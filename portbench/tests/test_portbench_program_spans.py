"""The readers of the port's trace log (``program_log`` and the metrics that
use it) on a synthetic log and a synthetic slice: per-call values, and None
without a slice or without a log."""

import types

import pytest

from portbench import harness, program_log, tracing
from thermoextrap_tpu_torch.utils import trace


def _slice(calls):
    return tracing.SliceReading(calls=calls, window_s=1.0, busy_s=0.5, kernels=10, device_ops=[], idle_gaps=[])


def _ctx(slice_):
    return types.SimpleNamespace(slice=slice_, entry={}, device_ms=lambda fn: None)


def _call(cid, name, spans, syncs):
    ms = 1_000_000  # ns
    return {
        "id": cid,
        "name": name,
        "t0_ns": 0,
        "t1_ns": 100 * ms,
        "spans": [(cid, parent, n, a * ms, b * ms) for parent, n, a, b in spans],
        "counters": {"host_syncs": {"n": syncs}, "host_reads": {"n": 0}, "launches": {"K1": 1, "K3": 1}},
    }


# two stream calls of the slice: each an update and a predict
LOG = [
    _call(1, "te.stream.update", [("te.stream.update", "te.reduce", 0, 1), ("te.stream.update", "te.merge", 1, 3)], 0),
    _call(
        2,
        "te.stream.predict",
        [
            ("te.stream.predict", "te.sync", 0, 4),
            ("te.stream.predict", "te.coefs", 4, 6),
            ("te.stream.predict", "te.taylor", 6, 7),
        ],
        1,
    ),
    _call(3, "te.stream.update", [("te.stream.update", "te.reduce", 0, 1), ("te.stream.update", "te.merge", 1, 3)], 0),
    _call(4, "te.stream.predict", [("te.stream.predict", "te.sync", 0, 2), ("te.stream.predict", "te.coefs", 2, 3)], 1),
]

EXPECTED = {
    "series_host_ms": (2 + 1 + 1) / 2,
    "merge_host_ms": (2 + 2) / 2,
    "sync_wait_ms": (4 + 2) / 2,
    "host_syncs_per_call": 2 / 2,
}


@pytest.fixture
def log(monkeypatch):
    monkeypatch.setattr(trace, "calls", lambda: list(LOG))


@pytest.mark.parametrize("metric", list(EXPECTED))
def test_reader_per_call(log, metric):
    read = harness.reader("metrics", metric).read
    assert read(_ctx(_slice(2))) == pytest.approx(EXPECTED[metric])
    assert read(_ctx(_slice(4))) == pytest.approx(EXPECTED[metric] / 2)
    assert harness.reader("metrics", f"{metric}.host").read(_ctx(_slice(2))) == pytest.approx(EXPECTED[metric])


@pytest.mark.parametrize("metric", list(EXPECTED))
def test_reader_none_without_slice_or_log(monkeypatch, log, metric):
    read = harness.reader("metrics", metric).read
    assert read(_ctx(None)) is None
    assert read(_ctx(_slice(0))) is None
    monkeypatch.setattr(trace, "calls", list)
    assert read(_ctx(_slice(2))) is None


def test_program_without_the_log(monkeypatch):
    """A port without ``utils.trace`` (the parent of this reader) reads
    nothing and raises nothing."""

    def missing(name):
        raise ModuleNotFoundError(name)

    monkeypatch.setattr(program_log.importlib, "import_module", missing)
    for metric in EXPECTED:
        assert harness.reader("metrics", metric).read(_ctx(_slice(2))) is None
