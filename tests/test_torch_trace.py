"""The port's spans and counters (``utils.trace``): nothing recorded with no
profiler running, the pipelines' and MBAR's call spans with their stages
nested under ``torch.profiler`` (in the profiler's events and in the log,
under one call id), bare kernel entries kept out of the log, the log's
bounds, the counters held by reference, and MBAR's iterations and host
reads counted."""

import types

import numpy as np
import pytest
import torch
from _torch_parity import cuda_device  # noqa: F401  (pins the default device to the CPU)
from torch.autograd import DeviceType
from torch.profiler import profile

from thermoextrap_tpu_torch import DataValues, MBARModel, beta, pipeline
from thermoextrap_tpu_torch.models import mbar as tm
from thermoextrap_tpu_torch.ops import dispatch
from thermoextrap_tpu_torch.ops import moments_cuda as mc
from thermoextrap_tpu_torch.utils import device as udev
from thermoextrap_tpu_torch.utils import trace

ORDER, BETA0, NREP = 3, 1.0, 8
BETAS = np.array([0.9, 1.1])


def _samples(n=3000, device="cpu"):
    g = np.random.default_rng(5)
    u = torch.as_tensor(g.normal(5.0, 1.0, n), device=device)
    return u, (2.0 + 0.1 * u)[:, None]


def _extrap(device="cpu"):
    u, x = _samples(device=device)
    run = pipeline.make_extrap_pipeline(ORDER, BETA0, nrep=NREP)
    return lambda: run(u, x, BETAS, seed=3)


def _lnpi():
    uv = torch.as_tensor(np.random.default_rng(6).normal(size=(4, 800)))
    run = pipeline.make_lnpi_pipeline(2, BETA0, nrep=NREP)
    return lambda: run(uv, torch.zeros(4), torch.arange(4.0), BETAS, seed=3)


def _stream():
    u, x = _samples()
    state0, update, predict = pipeline.make_streaming_extrap_pipeline(ORDER, BETA0, nrep=NREP, device="cpu")
    return lambda: predict(update(state0, u, x), BETAS)


def _mbar(device="cpu", n=500):
    """``MBARModel.predict`` over three harmonic states at two targets."""
    g = torch.Generator().manual_seed(7)
    states = []
    for s in (1.0, 2.0, 3.0):
        x = (s * torch.randn(n, generator=g, dtype=torch.float64)).to(device)
        data = DataValues.from_vals(torch.stack([x, x * x], dim=-1), 0.5 * x * x, order=0)
        states.append(beta.factory_extrapmodel(s**-2, data, order=0))
    model = MBARModel(states)
    return lambda: model.predict(np.array([0.5, 0.2]))


# each case: its calls, and each call's stages in the order they close
CASES = {
    "extrap": (_extrap, [("te.extrap", ["te.reduce", "te.coefs", "te.taylor", "te.boot", "te.coefs", "te.taylor"])]),
    "lnpi": (_lnpi, [("te.lnpi", ["te.reduce", "te.coefs", "te.taylor", "te.boot", "te.coefs", "te.taylor"])]),
    "stream": (
        _stream,
        [
            ("te.stream.update", ["te.reduce", "te.merge", "te.boot", "te.merge"]),
            ("te.stream.predict", ["te.coefs", "te.taylor", "te.coefs", "te.taylor"]),
        ],
    ),
    "mbar": (_mbar, [("te.mbar", ["te.mbar.pool", "te.mbar.solve", "te.mbar.grid"])]),
}


def _raise(*_a, **_k):
    raise AssertionError("called with no profiler running")


def test_nothing_recorded_without_a_profiler(monkeypatch):
    fns = [make() for make, _ in CASES.values()]
    before = trace.calls()
    monkeypatch.setattr(trace, "record_function", _raise)
    monkeypatch.setattr(torch.cuda, "Event", _raise)
    monkeypatch.setattr(torch.cuda, "synchronize", _raise)
    assert not torch.autograd._profiler_enabled()
    for fn in fns:
        fn()
    with trace.call("te.extrap"), trace.span("te.reduce"):
        pass
    after = trace.calls()
    assert [c["id"] for c in after] == [c["id"] for c in before]


@pytest.mark.parametrize("case", list(CASES))
def test_call_spans_nest_their_stages(case):
    make, expected = CASES[case]
    fn = make()
    fn()  # warm
    with profile() as prof:
        fn()
    logged = trace.calls()[-len(expected) :]
    assert [(c["name"], [s[2] for s in c["spans"]]) for c in logged] == expected
    for c in logged:
        assert c["t0_ns"] <= c["t1_ns"]
        for call_id, parent, name, t0, t1 in c["spans"]:
            assert call_id == c["id"] and parent == c["name"]
            assert c["t0_ns"] <= t0 <= t1 <= c["t1_ns"], name
    assert len({c["id"] for c in logged}) == len(logged)
    # the same spans in the profiler's events, each stage inside its call
    host = [e for e in prof.events() if e.device_type == DeviceType.CPU and e.name.startswith("te.")]
    for name, stages in expected:
        (outer,) = [e for e in host if e.name == name]
        inner = [
            e.name
            for e in host
            if e is not outer and outer.time_range.start <= e.time_range.start and e.time_range.end <= outer.time_range.end
        ]
        assert sorted(inner) == sorted(stages)


def test_bare_kernel_entry_leaves_no_log():
    u, x = _samples()
    before = [c["id"] for c in trace.calls()]
    with profile() as prof:
        dispatch.reduce_central(u, x, ORDER)
        mc.resample_central_comoments_poisson(u, x, NREP, ORDER, seed=1)
    assert [c["id"] for c in trace.calls()] == before
    assert "te.reduce" in {e.name for e in prof.events()}  # the profiler still sees the span


def test_log_stays_within_its_bounds(monkeypatch):
    monkeypatch.setattr(trace, "MAX_SPANS", 3)
    with profile():
        for _ in range(trace.MAX_CALLS + 5):
            with trace.call("t.call"):
                for _ in range(5):
                    with trace.span("t.stage"):
                        pass
    logged = trace.calls()
    assert len(logged) == trace.MAX_CALLS
    assert all(len(c["spans"]) == 3 for c in logged[-trace.MAX_CALLS :])
    ids = [c["id"] for c in logged]
    assert ids == sorted(ids) and ids[-1] - ids[0] == trace.MAX_CALLS - 1


def test_nested_call_is_a_stage_and_threads_keep_their_own_stack():
    import threading

    seen = []
    with profile():
        with trace.call("outer"), trace.call("inner"), trace.span("leaf"):
            t = threading.Thread(target=lambda: seen.append(trace._local().stack[:]))
            t.start()
            t.join(timeout=10)
    assert not t.is_alive() and seen == [[]]
    rec = trace.calls()[-1]
    assert rec["name"] == "outer"
    assert [(s[1], s[2]) for s in rec["spans"]] == [("inner", "leaf"), ("outer", "inner")]


def test_counters_held_by_reference():
    assert trace.COUNTERS["launches"] is mc.LAUNCHES
    assert trace.COUNTERS["host_reads"] is udev.HOST_READS
    assert trace.COUNTERS["host_syncs"] is udev.HOST_SYNCS
    reads, syncs, k1 = udev.HOST_READS["n"], udev.HOST_SYNCS["n"], mc.LAUNCHES["K1"]
    with profile():
        with trace.call("t.counted"):
            mc.LAUNCHES["K1"] += 2
            udev.host_numpy(torch.ones(3))  # a CPU tensor: no read back
            udev.to_device(np.ones(3), "cpu")  # no copy onto a card
    rec = trace.calls()[-1]
    assert rec["counters"]["launches"]["K1"] == 2 and rec["counters"]["host_syncs"]["n"] == 0
    assert rec["counters"]["host_reads"]["n"] == 0
    assert (udev.HOST_READS["n"], udev.HOST_SYNCS["n"], mc.LAUNCHES["K1"]) == (reads, syncs, k1 + 2)
    mc.LAUNCHES["K1"] -= 2
    # the CPU routes launch no kernel and make no host wait
    before = dict(mc.LAUNCHES), udev.HOST_READS["n"], udev.HOST_SYNCS["n"]
    for make, _ in CASES.values():
        make()()
    assert (dict(mc.LAUNCHES), udev.HOST_READS["n"], udev.HOST_SYNCS["n"]) == before


@pytest.mark.parametrize("method", ["hybrid", "sci"])
def test_mbar_counts_its_iterations_and_each_host_read(monkeypatch, method):
    """``mbar_iters`` gains the solve's iterations (``n_iter``), and every
    host read of the solve goes through ``host_item``: one a loop trip, the
    one that ends the loop, and ``n_iter``'s (the CPU reads count nothing,
    so they are counted here at the helper)."""
    x = torch.randn((3, 400), generator=torch.Generator().manual_seed(8), dtype=torch.float64)
    alpha0 = torch.tensor([1.0, 0.3, 0.1], dtype=torch.float64)
    u_kn = alpha0[:, None] * (0.5 * x * x * torch.tensor([1.0, 4.0, 9.0], dtype=torch.float64)[:, None]).reshape(-1)
    reads = []
    real = tm.host_item
    monkeypatch.setattr(tm, "host_item", lambda t: reads.append(t.shape) or real(t))
    before = tm.MBAR_ITERS["n"]
    with profile(), trace.call("t.mbar"):
        _, n_iter, _ = tm.mbar_solve_info(u_kn, torch.full((3,), 400.0, dtype=torch.float64), method=method)
    assert trace.COUNTERS["mbar_iters"] is tm.MBAR_ITERS
    assert n_iter > 1 and tm.MBAR_ITERS["n"] - before == n_iter
    assert trace.calls()[-1]["counters"]["mbar_iters"]["n"] == n_iter
    trips = n_iter if method == "hybrid" else n_iter - 1  # sci's first update precedes the loop
    assert len(reads) == trips + 2 and all(shape == () for shape in reads)


def test_host_item_counts_a_read_from_a_card():
    card = types.SimpleNamespace(device=torch.device("cuda", 0), item=lambda: 7)
    reads, syncs = udev.HOST_READS["n"], udev.HOST_SYNCS["n"]
    assert udev.host_item(torch.tensor(True)) is True  # a CPU tensor: no read back
    assert (udev.HOST_READS["n"], udev.HOST_SYNCS["n"]) == (reads, syncs)
    with profile(), trace.call("t.item"):
        assert udev.host_item(card) == 7
    rec = trace.calls()[-1]
    assert rec["counters"]["host_reads"]["n"] == rec["counters"]["host_syncs"]["n"] == 1
    assert [s[2] for s in rec["spans"]] == ["te.sync"]


@pytest.mark.cuda
def test_mbar_on_the_card_counts_each_wait(cuda_device):  # noqa: F811
    """On the card a ``predict`` waits on the two α copies, each solve
    iteration's read, the read that ends the loop and ``n_iter``'s."""
    fn = _mbar(cuda_device, n=20000)
    fn()
    with profile():
        fn()
    rec = trace.calls()[-1]
    n_iter = rec["counters"]["mbar_iters"]["n"]
    assert rec["name"] == "te.mbar" and n_iter >= 2
    assert rec["counters"]["host_syncs"]["n"] == 2 + n_iter + 2
    assert [s[2] for s in rec["spans"]].count("te.sync") == 2 + n_iter + 2
    assert rec["counters"]["host_reads"]["n"] == n_iter + 2


@pytest.mark.cuda
def test_numpy_betas_on_the_card_wait_once_a_call(cuda_device):  # noqa: F811
    fn = _extrap(cuda_device)
    fn()
    n0 = udev.HOST_SYNCS["n"]
    for _ in range(3):
        fn()
    assert udev.HOST_SYNCS["n"] - n0 == 3
    with profile():
        fn()
    rec = trace.calls()[-1]
    assert rec["name"] == "te.extrap" and rec["counters"]["host_syncs"]["n"] == 1
    assert [s[2] for s in rec["spans"]].count("te.sync") == 1
    assert rec["counters"]["launches"]["K1"] == 1 and rec["counters"]["launches"]["K3"] == 1
