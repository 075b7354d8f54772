"""The port's example CLIs against the JAX package, in-process, and their
refusal to run at full size without a card.

- ``examples_torch/macrostate_lnpi.py`` reads the golden lnPi file: its
  per-temperature errors equal those of the same computation through the
  JAX package (float64 on the CPU) to 1e-10.
- ``examples_torch/lnpi_gpr_surface.py`` draws its run moments from
  ``np.random.default_rng(3)``, the reference script's very draws: the
  per-state GP inputs (x, y, cov of ``input_GP_from_state``) equal the JAX
  package's to 1e-10, and the GP's predicted lnPi surface lies within 1e-3 of
  its posterior sigma of the JAX package's (the fit tolerance of
  ``tests/test_torch_gpr.py::test_train_matches_jax``).
- Without ``--smoke`` every script exits non-zero when there is no CUDA
  device (``CUDA_VISIBLE_DEVICES`` empty): it never carries on on the CPU.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from _torch_parity import npy

ROOT = Path(__file__).resolve().parent.parent
EX = ROOT / "examples_torch"
EXAMPLES = sorted(p for p in EX.glob("*.py") if not p.stem.startswith("_"))


def _load(name):
    """The example module ``examples_torch/<name>.py``, imported in-process."""
    sys.path.insert(0, str(EX))
    try:
        spec = importlib.util.spec_from_file_location(f"examples_torch_{name}", EX / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(EX))
    return mod


def _jax_lnpi_errors(n_samples):
    """The reference script's errors (``examples/macrostate_lnpi.py``) through
    the JAX package."""
    import thermoextrap_tpu as xtpu
    from thermoextrap_tpu import lnpi
    from thermoextrap_tpu.utils.trees import replace

    d = json.loads((ROOT / "tests" / "lnpi_data" / "sample_data.json").read_text())
    ref = d["ref"]
    lnpi0 = np.array(ref["lnPi"])
    lnpi0 -= lnpi0[0]
    energy = np.array(ref["energy"])
    energy = np.concatenate([np.ones_like(energy[:, :1]), energy], axis=-1)
    data = xtpu.DataCentralMoments.from_ave_raw(u=energy.T, xu=None, x_is_u=True, central=True)
    meta = lnpi.lnPiDataCallback.from_mu(lnPi0=lnpi0, mu=[ref["mu"]], ncoords=np.arange(len(lnpi0), dtype=float)[None, :])
    model = lnpi.factory_extrapmodel_lnPi(ref["beta"], replace(data, meta=meta))
    errs = []
    for s in d["samples"][:n_samples]:
        pred = np.asarray(model.predict(s["beta"], cumsum=True))[s["order"]]
        gold = np.array(s["lnPi"])
        errs.append(float(np.max(np.abs((pred - pred[0]) - (gold - gold[0])))))
    return errs


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_macrostate_lnpi_matches_jax(smoke):
    got = _load("macrostate_lnpi").main(smoke=smoke)
    want = _jax_lnpi_errors(len(got["errs"]))
    assert len(got["errs"]) == (2 if smoke else 4)
    np.testing.assert_allclose(got["errs"], want, rtol=0, atol=1e-10)
    assert got["max_abs_err"] < 1e-8


@pytest.fixture(scope="module")
def lnpi_gpr():
    """The port script's states and the JAX package's, from the same draws."""
    import thermoextrap_tpu as xtpu
    from thermoextrap_tpu import lnpi
    from thermoextrap_tpu.utils.trees import replace

    mod = _load("lnpi_gpr_surface")
    nmax, nrun, _ = mod.sizes(True)
    nvals = np.arange(nmax + 1, dtype=float)
    jstates = []
    for b, u_mom in zip(mod.BETAS_REF, mod.state_moments(True)):
        data = xtpu.DataCentralMoments.from_ave_raw(u=u_mom, xu=None, x_is_u=True, central=True)
        meta = lnpi.lnPiDataCallback.from_mu(
            lnPi0=np.broadcast_to(mod.lnpi_exact(nvals, b), (nrun, nmax + 1)),
            mu=[mod.MU],
            ncoords=np.broadcast_to(nvals, (nrun, nmax + 1))[None],
        )
        jstates.append(lnpi.factory_extrapmodel_lnPi(b, replace(data, meta=meta)))
    return mod, mod.build_states(True), jstates


def test_lnpi_gpr_surface_state_inputs_match_jax(lnpi_gpr):
    from thermoextrap_tpu.gpr_active import active_utils as jau

    from thermoextrap_tpu_torch.gpr_active import active_utils as tau

    _mod, states, jstates = lnpi_gpr
    assert len(states) == len(jstates) == 2
    for s, js in zip(states, jstates):
        for got, want in zip(tau.input_GP_from_state(s), jau.input_GP_from_state(js)):
            np.testing.assert_allclose(npy(got), np.asarray(want), rtol=1e-10, atol=1e-12)


def test_lnpi_gpr_surface_prediction_matches_jax(lnpi_gpr):
    from thermoextrap_tpu.gpr_active import active_utils as jau

    mod, states, jstates = lnpi_gpr

    class JStatelnPi:
        def __init__(self, state):
            x, y, cov = jau.input_GP_from_state(state)
            self.x, self.y, self.cov = x, y[:, 1:], cov[1:]

        def __call__(self):
            return self.x, self.y, self.cov

    gp = mod.active_utils.create_GPR([mod.StatelnPi(s) for s in states])
    jgp = jau.create_GPR([JStatelnPi(s) for s in jstates])
    x_test = np.stack([np.asarray(mod.BETAS_TEST, dtype=float), np.zeros(len(mod.BETAS_TEST))], axis=1)
    mean, var = (npy(a) for a in gp.predict_f(x_test))
    jmean, jvar = (np.asarray(a) for a in jgp.predict_f(x_test))
    assert mean.shape == jmean.shape
    assert np.all(np.abs(mean - jmean) <= 1e-3 * np.sqrt(jvar))


def test_lnpi_gpr_surface_main_holds_its_bars():
    out = _load("lnpi_gpr_surface").main(smoke=True)
    assert out["surface_max_abs_err"] < 0.15 and out["n_axis_max_abs_err"] < 0.2


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.stem)
def test_full_size_needs_a_card(path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, str(path)], capture_output=True, text=True, timeout=300, env=env, check=False)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr and not proc.stdout.strip(), (proc.stdout[-2000:], proc.stderr[-2000:])
