"""The ``mbar_harmonic4`` cell's readers and bounds: the MBAR readers of the
port's trace log on a synthetic log and slice, and the bound arithmetic at
the cell's shape (its targets' grid bound by exponentials, one iteration of
its solve by bytes)."""

import types

import pytest

from portbench import harness, program_log, roofline, tracing
from thermoextrap_tpu_torch.utils import trace


def _slice(calls):
    return tracing.SliceReading(calls=calls, window_s=1.0, busy_s=0.5, kernels=10, device_ops=[], idle_gaps=[])


def _ctx(slice_):
    return types.SimpleNamespace(slice=slice_, entry={}, device_ms=lambda fn: None)


def _call(cid, name, spans, counters):
    ms = 1_000_000  # ns
    return {
        "id": cid,
        "name": name,
        "t0_ns": 0,
        "t1_ns": 100 * ms,
        "spans": [(cid, parent, n, a * ms, b * ms) for parent, n, a, b in spans],
        "counters": counters,
    }


# two MBAR calls of the slice, each three iterations, its solve's loop reads
# nested in te.mbar.solve
MBAR_LOG = [
    _call(
        cid,
        "te.mbar",
        [
            ("te.mbar", "te.mbar.pool", 0, 2),
            ("te.mbar.solve", "te.sync", 3, 40),
            ("te.mbar", "te.mbar.solve", 2, 50 + cid),
            ("te.mbar", "te.mbar.grid", 50 + cid, 99),
        ],
        {"host_syncs": {"n": 7}, "mbar_iters": {"n": 3}},
    )
    for cid in (1, 2)
]

# a log with no MBAR call: one point prediction
OTHER_LOG = [
    _call(
        cid,
        "te.extrap",
        [("te.extrap", "te.reduce", 0, 1), ("te.extrap", "te.sync", 1, 2), ("te.extrap", "te.coefs", 2, 3)],
        {"host_syncs": {"n": 1}, "host_reads": {"n": 1}, "launches": {"K1": 1}},
    )
    for cid in (1, 2)
]

MBAR_EXPECTED = {"mbar_iters_per_call": 3.0, "mbar_solve_ms": 49.5, "host_syncs_per_call": 7.0, "sync_wait_ms": 37.0}


@pytest.mark.parametrize("metric", list(MBAR_EXPECTED))
def test_mbar_readers_per_call(monkeypatch, metric):
    monkeypatch.setattr(trace, "calls", lambda: list(MBAR_LOG))
    read = harness.reader("metrics", metric).read
    assert read(_ctx(_slice(2))) == pytest.approx(MBAR_EXPECTED[metric])
    assert read(_ctx(None)) is None
    monkeypatch.setattr(trace, "calls", lambda: list(OTHER_LOG))
    if metric.startswith("mbar_"):
        assert read(_ctx(_slice(2))) == 0.0


@pytest.mark.parametrize("metric", [m for m in MBAR_EXPECTED if m.startswith("mbar_")])
def test_mbar_reader_without_the_log(monkeypatch, metric):
    """A port without ``utils.trace`` reads nothing and raises nothing."""

    def missing(name):
        raise ModuleNotFoundError(name)

    monkeypatch.setattr(program_log.importlib, "import_module", missing)
    assert harness.reader("metrics", metric).read(_ctx(_slice(2))) is None


@pytest.mark.parametrize(
    ("op", "shape", "ms", "by"),
    [
        ("mbar_grid", {"k": 4, "n": 10**8, "a": 256, "v": 2}, 6.22, "exps"),  # 2.6e10 ex2
        ("mbar_iter", {"k": 4, "n": 10**8}, 0.478, "bytes"),  # u_kn read once
    ],
)
def test_mbar_bounds(op, shape, ms, by):
    got, got_by = roofline.bound(roofline.op(op).work(**shape))
    assert got == pytest.approx(ms, rel=0.01)
    assert got_by == by
