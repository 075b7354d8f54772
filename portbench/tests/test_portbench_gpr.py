"""The ``gpr_ig5`` cell against its plain reference on the CPU, stage by
stage at the tiny size in float64: each state's staged GP inputs, the
marginal likelihood and its gradient, and the posterior at the same
parameters, then the whole cell's ``pred_err`` and its bfloat16 control,
and the deviation's hold on ``pred_err``; the reference's imports; the
cell's readers of the port's trace log and its roofline bound.

Tolerances: both sides compute in float64 from the same float64 samples
and the same index tables, and differ only in the order of their sums
(the program's shifted comoments against the reference's power sums about
the head's mean), so the derivatives agree to rtol 1e-10 and each
covariance to 1e-8 of its largest entry (``np.cov`` of 100 replicates
whose spread is ~1e-3 of their size loses ~3 digits); the likelihood, its
gradient and the posterior, on identical inputs, to 1e-9 relative (25 x 25
Cholesky factors of a matrix whose order-4 noise rows reach exp(100) at
the start)."""

import json
import math
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from conftest import REPO, SEED, cell_sizes, tiny_cell

from portbench import compare, harness, program_log, roofline, tracing
from portbench.reference import gpr_idealgas as ref
from thermoextrap_tpu_torch import DataCentralMomentsVals, beta
from thermoextrap_tpu_torch.gpr_active import active_utils
from thermoextrap_tpu_torch.utils import trace

CELL = "gpr_ig5.point"


@pytest.fixture(scope="module")
def tiny():
    """The tiny cell's configuration, its inputs, and the program's states."""
    cell = tiny_cell(CELL)
    cfg = cell.config
    inputs = harness.model(cfg).make_inputs(cfg, SEED, torch.device("cpu"))
    states = [
        beta.factory_extrapmodel(b, DataCentralMomentsVals.from_vals(inputs["x"][k][:, None], inputs["u"][k], order=cfg["order"]))
        for k, b in enumerate(cfg["state_betas"])
    ]
    return cfg, inputs, states


def _gen(cfg):
    return torch.Generator().manual_seed(int(cfg["table_seed"]))


def test_each_state_staged_as_the_reference(tiny):
    cfg, inputs, states = tiny
    gen, rgen = _gen(cfg), _gen(cfg)
    r, nrep = inputs["nrec"], int(cfg["boot_nrep"])
    for k, state in enumerate(states):
        x, y, cov = active_utils.input_GP_from_state(state, n_rep=nrep, rng=gen)
        idx = torch.randint(0, r, (nrep, r), generator=rgen)
        ry, rcov = ref.state_inputs(inputs["u"][k], inputs["x"][k], int(cfg["order"]), idx)
        np.testing.assert_array_equal(x, np.column_stack([np.full(len(ry), cfg["state_betas"][k]), np.arange(len(ry))]))
        np.testing.assert_allclose(y[:, 0], ry, rtol=1e-10)
        assert np.max(np.abs(cov[0] - rcov)) <= 1e-8 * np.max(np.abs(rcov))


@pytest.fixture
def both_gps(tiny):
    """The program's untrained GP and the reference's on the same inputs."""
    cfg, inputs, _states = tiny
    locs, orders, y, cov = ref.staged(cfg, inputs)
    gpr = active_utils.create_base_GP_model((np.column_stack([locs, orders]), y[:, None], cov[None]))
    return gpr, ref.GP(locs, orders, y, cov)


@pytest.mark.parametrize("raw", [None, [0.3, 2.0, -1.5], [-0.7, 0.5, 0.0]], ids=["start", "a", "b"])
def test_likelihood_and_gradient(both_gps, raw):
    gpr, rgp = both_gps
    vec = gpr.get_unconstrained().numpy() if raw is None else np.asarray(raw)
    if raw is None:  # both start from the same point
        np.testing.assert_allclose(vec, [ref._inv_softplus(ref.START[k]) for k in ("l", "var", "p")], rtol=1e-15)
    val, grad = gpr._lml_fns()["neg_vag"](torch.as_tensor(vec), *gpr._bound_args())
    rval, rgrad = rgp.objective(vec)
    assert float(val) == pytest.approx(rval, rel=1e-9)
    np.testing.assert_allclose(grad.numpy(), rgrad, rtol=1e-9, atol=1e-9 * np.max(np.abs(rgrad)))


def test_posterior_at_the_same_parameters(both_gps, tiny):
    gpr, rgp = both_gps
    cfg, inputs, _ = tiny
    raw = np.array([0.4, 1.5, -3.0])
    gpr.set_unconstrained(raw)
    betas = inputs["betas"]
    mean, var = gpr.predict_f(np.column_stack([betas, np.zeros_like(betas)]))
    rmean, rvar = rgp.posterior(raw, betas)
    np.testing.assert_allclose(mean.numpy()[:, 0], rmean.numpy(), rtol=1e-9)
    np.testing.assert_allclose(var.numpy()[:, 0], rvar.numpy(), rtol=1e-9)


@pytest.fixture(scope="module")
def answer(tiny):
    """The reference's answer at the tiny size."""
    cfg, inputs, _ = tiny
    return ref.predict(cfg, inputs, inputs["betas"])


@pytest.mark.parametrize("control", [False, True], ids=["program", "bfloat16"])
def test_cell_against_the_reference(tiny, answer, control):
    """The program's answer is under the cell's ``pred_err`` limit; the
    bfloat16 control's is over it."""
    cfg, inputs, _ = tiny
    call = harness.model(cfg).batch(cfg, inputs, 0, control=control)
    (pred,) = call(SEED)
    assert pred.dtype == torch.float64 and tuple(pred.shape) == (len(inputs["betas"]), 2)
    err = compare.pred_err(pred.numpy(), answer)
    limit = harness.load_cell(CELL).limits["pred_err"]
    assert (err > limit) if control else (err <= limit), err
    assert torch.equal(call(SEED + 1)[0], pred)  # the call's seed is not read


@pytest.mark.parametrize(
    ("factor", "held"), [(0.0, False), (3.0, False), (1.5, False), (0.6, False), (1.02, True), (0.98, True)], ids=str
)
def test_sigma_is_held_by_its_relative_error(answer, factor, held):
    """``pred_err`` holds the deviation on its own scale, through the
    weighted log column: a deviation of 0, or one off by a factor of 1.5 or
    more either way, fails the cell's limit; one 2% off passes.  (The mean's
    change over the targets, which divides every gap, is ~1e5 times the
    deviation at the cell's size, so the deviation itself would read as
    nothing.)"""
    weight = harness.load_cell(CELL).config["log_sigma_weight"]
    pred = answer["pred"].clone()
    pred[:, 1] += weight * math.log(factor) if factor else -math.inf
    err = compare.pred_err(pred.numpy(), answer)
    limit = harness.load_cell(CELL).limits["pred_err"]
    assert (err <= limit) if held else (err > limit), err


def test_reference_imports_no_program_and_no_jax():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]); base = set(sys.modules)\n"
        "import portbench.reference.gpr_idealgas\n"
        "print(' '.join(sorted({m.split('.')[0] for m in set(sys.modules) - base})))"
    )
    res = subprocess.run([sys.executable, "-c", code, str(REPO)], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    loaded = set(res.stdout.split())
    assert "torch" in loaded and not loaded & {"jax", "jaxlib", "flax", "thermoextrap_tpu", "thermoextrap_tpu_torch"}


def _call(cid, name, spans, counters):
    ms = 1_000_000  # ns
    return {
        "id": cid,
        "name": name,
        "t0_ns": 0,
        "t1_ns": 500 * ms,
        "spans": [(cid, parent, n, a * ms, b * ms) for parent, n, a, b in spans],
        "counters": counters,
    }


# two benchmark calls of the slice, each a training and a prediction
GPR_LOG = []
for _cid in (1, 3):
    GPR_LOG.append(
        _call(
            _cid,
            "te.gpr.train",
            [
                ("te.gpr.train", "te.reduce", 0, 1),
                ("te.gpr.inputs", "te.sync", 10, 20),
                ("te.gpr.train", "te.gpr.inputs", 0, 200 + _cid),
                ("te.gpr.fit", "te.sync", 210, 212),
                ("te.gpr.train", "te.gpr.fit", 205, 400),
            ],
            {"host_syncs": {"n": 50}, "gpr_lml_evals": {"n": 40 + _cid}},
        )
    )
    GPR_LOG.append(_call(_cid + 1, "te.gpr.predict", [("te.gpr.predict", "te.sync", 0, 1)], {"host_syncs": {"n": 3}}))

GPR_EXPECTED = {
    "gpr_inputs_ms.host": 202.0,
    "gpr_fit_ms.host": 195.0,
    "gpr_lml_evals_per_call.host": 42.0,
    "host_syncs_per_call.host": 53.0,
    "sync_wait_ms.host": 13.0,
}


def _ctx(calls):
    s = None if calls is None else tracing.SliceReading(calls=calls, window_s=1.0, busy_s=0.5, kernels=10, device_ops=[], idle_gaps=[])
    return types.SimpleNamespace(slice=s, entry={}, device_ms=lambda fn: None)


@pytest.mark.parametrize("metric", list(GPR_EXPECTED))
def test_gpr_readers_per_call(monkeypatch, metric):
    assert metric in {m["name"] for m in harness.load_cell(CELL).per_layer}
    monkeypatch.setattr(trace, "calls", lambda: list(GPR_LOG))
    read = harness.reader("metrics", metric).read
    assert read(_ctx(2)) == pytest.approx(GPR_EXPECTED[metric])
    assert read(_ctx(None)) is None


@pytest.mark.parametrize("metric", ["gpr_inputs_ms", "gpr_fit_ms", "gpr_lml_evals_per_call", "table_boot_roofline"])
def test_gpr_reader_finds_nothing(monkeypatch, metric):
    """A port without ``utils.trace``, or a run without a card, reads
    nothing and raises nothing."""

    def missing(name):
        raise ModuleNotFoundError(name)

    monkeypatch.setattr(program_log.importlib, "import_module", missing)
    cfg = {**harness.load_cell(CELL).config, **cell_sizes(CELL, "tiny")}
    mod = harness.model(cfg)
    ctx = _ctx(2)
    ctx.entry = mod.entry_inputs(cfg, mod.make_inputs(cfg, SEED, torch.device("cpu")), {"mode": "batch", "nrep": 0})
    assert harness.reader("metrics", metric).read(ctx) is None


def test_table_boot_bound():
    """One state at the cell's shape: 1e9 counts drawn, 12 integer
    operations each, at 16.75 T a second."""
    conf = json.loads((REPO / "portbench" / "configs" / "gpr_ig5.json").read_text())
    shape = {"r": conf["samples_per_state"], "v": 1, "order": conf["order"], "nrep": conf["boot_nrep"]}
    got, by = roofline.bound(roofline.op("table_boot").work(**shape))
    assert got == pytest.approx(0.716, rel=0.01) and by == "draws"
