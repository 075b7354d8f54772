"""Perturbation reweighting of the torch port against the JAX package, on the
CPU: the plain versions of K7 and K8, ``PerturbModel``, ``factory_perturbmodel``
and ``make_perturb_pipeline``.

Inputs are made with numpy from a seed and sent through both packages.
Tolerances, with their reasons:

- the port's plain K7 (float64) against the float32 JAX kernel in interpret
  mode: rtol 2e-5 / atol 1e-5, the bar of tests/test_parallel.py:716-818;
- two float64 forms of the same sums (plain version, einsum oracle): rtol
  1e-12;
- predictions of the two packages in float64: rtol 1e-10;
- bootstrap standard deviations, whose random counts differ between the
  packages (threefry against torch's generator): a ratio within [0.7, 1.4]
  at 300 replicates (the relative error of a standard deviation from n
  replicates is ~1/sqrt(2n) = 4%, on each side).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import assert_close, npy, tt

from thermoextrap_tpu import beta as jbeta
from thermoextrap_tpu import pipeline as jpipe
from thermoextrap_tpu.models.extrap import PerturbModel as JPerturbModel
from thermoextrap_tpu.ops.moments_pallas import resample_perturb_freq as j_resample_perturb_freq
from thermoextrap_tpu_torch import beta as tbeta
from thermoextrap_tpu_torch import pipeline as tpipe
from thermoextrap_tpu_torch.models.extrap import PerturbModel
from thermoextrap_tpu_torch.ops import moments_cuda as mc

R, A, NREP = 1000, 5, 16


@pytest.fixture
def rng():
    return np.random.default_rng(23)


def _kernel_case(rng, v, weighted=False, zero_columns=False):
    """float32 ``e (A, R)``, ``x (R, v)``, an int8 Poisson table and the
    float64 einsum oracle of the sums (the case of tests/test_parallel.py:723)."""
    u = rng.normal(3.0, 1.0, R).astype(np.float32)
    x = rng.normal(1.0, 0.5, (R, v)).astype(np.float32)
    dalpha = np.linspace(-0.3, 0.3, A).astype(np.float32)
    logw = -dalpha[:, None] * u[None, :]
    if weighted:
        logw = logw + np.log(rng.uniform(0.2, 2.0, R).astype(np.float32))[None, :]
    e = np.exp(logw - logw.max(axis=1, keepdims=True)).astype(np.float32)
    if zero_columns:
        e[:, ::7] = 0.0
    freq = rng.poisson(1.0, (NREP, R)).astype(np.int8)
    xe = np.concatenate([x, np.ones((R, 1), np.float32)], axis=1).astype(np.float64)
    want = np.einsum("nr,arv->anv", freq.astype(np.float64), e[:, :, None].astype(np.float64) * xe[None])
    return e, x, freq, want


@pytest.mark.parametrize(
    ("v", "weighted", "zero_columns"),
    [(2, False, False), (2, True, True), (1, False, False), (1, True, True)],
)
def test_k7_plain_matches_jax_kernel_and_oracle(rng, v, weighted, zero_columns):
    e, x, freq, want = _kernel_case(rng, v, weighted, zero_columns)
    jax_kernel = np.asarray(j_resample_perturb_freq(e, x, freq, interpret=True))
    plain64 = mc.resample_perturb_plain(tt(e).double(), tt(x).double(), tt(freq))
    assert plain64.shape == (A, NREP, v + 1) and plain64.dtype == torch.float64
    assert_close(plain64, want, 1e-12)
    assert_close(plain64, jax_kernel, 2e-5, 1e-5)
    # the wrapper on CPU tensors is the plain version, chunked or not
    assert torch.equal(mc.resample_perturb_freq(tt(e).double(), tt(x).double(), tt(freq)), plain64)
    assert_close(mc.resample_perturb_plain(tt(e).double(), tt(x).double(), tt(freq), chunk=96), want, 1e-12)
    # float32 inputs stay float32 in the plain version
    plain32 = mc.resample_perturb_plain(tt(e), tt(x), tt(freq))
    assert plain32.dtype == torch.float32
    assert_close(plain32, want, 2e-5, 1e-5)


def test_k7_plain_equals_jax_perturb_boot(rng):
    """The port's ``_perturb_boot`` and the JAX one on the same float64 table."""
    e, x, freq, _ = _kernel_case(rng, 2, weighted=True)
    e64, x64, f64 = e.astype(np.float64), x.astype(np.float64), freq.astype(np.float64)
    ref = np.asarray(jpipe._perturb_boot(jnp.asarray(e64), jnp.asarray(x64), jnp.asarray(f64)))
    assert_close(tpipe._perturb_boot(tt(e64), tt(x64), tt(f64)), ref, 1e-12)
    sums = mc.resample_perturb_plain(tt(e64), tt(x64), tt(freq))
    assert_close(sums[..., :2] / sums[..., 2:], ref, 1e-12)


@pytest.mark.parametrize("v", [1, 2])
def test_k8_plain_draws_k3_counts(rng, v):
    """The plain Poisson version is the plain table version on
    ``_poisson_counts``, whatever the chunking; its replicate mean is near
    the full-sample prediction (rtol 0.05, tests/test_parallel.py:805-809);
    at e = 1 its weight sums are those of K3's plain version."""
    e, x, _, _ = _kernel_case(rng, v)
    e64, x64 = tt(e).double(), tt(x).double()
    counts = mc._poisson_counts(3, NREP, R)
    on_table = mc.resample_perturb_plain(e64, x64, counts)
    assert torch.equal(mc.resample_perturb_poisson_plain(e64, x64, NREP, seed=3), on_table)
    assert torch.equal(mc.resample_perturb_poisson(e64, x64, NREP, seed=3), on_table)
    assert_close(mc.resample_perturb_poisson_plain(e64, x64, NREP, seed=3, chunk=64), on_table, 1e-12)
    assert not torch.equal(mc.resample_perturb_poisson_plain(e64, x64, NREP, seed=4), on_table)
    pred = on_table[..., :v] / on_table[..., v:]
    full = (e64 @ x64) / e64.sum(1)[:, None]
    assert_close(pred.mean(dim=1), full, 0.05, 0.05)
    ones = torch.ones((1, R), dtype=torch.float64)
    wsum8 = mc.resample_perturb_poisson_plain(ones, x64, NREP, seed=3)[0, :, -1]
    wsum3 = mc.resample_poisson_plain(x64[:, 0], x64, NREP, 2, seed=3)[4]
    assert torch.equal(wsum8, wsum3)


def test_kernel_entries_validate(rng):
    e, x, freq, _ = _kernel_case(rng, 2)
    with pytest.raises(ValueError, match="targets, samples"):
        mc.resample_perturb_freq(tt(e)[0], tt(x), tt(freq))
    with pytest.raises(ValueError, match="does not lead"):
        mc.resample_perturb_freq(tt(e), tt(x)[:-1], tt(freq))
    with pytest.raises(ValueError, match="counts must have shape"):
        mc.resample_perturb_plain(tt(e), tt(x), tt(freq)[:, :-1])
    # more than 512 contribution rows is no limit of the port
    big = mc.resample_perturb_freq(torch.ones((200, 64), dtype=torch.float64), tt(x)[:64].double(), torch.ones((4, 64)))
    assert big.shape == (200, 4, 3)
    assert "K7" in mc.LAUNCHES and "K8" in mc.LAUNCHES


# -- PerturbModel and the factory (tests/test_models.py::TestPerturb) ---------------------


def test_perturb_model_exact_discrete_and_jax():
    rng = np.random.default_rng(4)
    u = rng.uniform(0.5, 2.0, size=50)
    x = rng.uniform(0.0, 1.0, size=(50, 1))
    betas = np.array([0.8, 1.0, 1.7])
    model = tbeta.factory_perturbmodel(1.0, u, x)
    assert isinstance(model, PerturbModel) and model.alpha_name == "beta"
    got = npy(model.predict(betas))
    for i, b in enumerate(betas):
        w = np.exp(-(b - 1.0) * u)
        np.testing.assert_allclose(got[i], (w[:, None] * x).sum(0) / w.sum(), rtol=1e-10)
    assert_close(model.predict(betas), np.asarray(jbeta.factory_perturbmodel(1.0, u, x).predict(betas)), 1e-10)
    assert model(1.1).shape == (1,)
    assert_close(model(1.1), model.predict(betas * 0 + 1.1)[0], 1e-14)


def test_perturb_model_resample_matches_jax_on_the_same_indices(rng):
    u = rng.normal(2.0, 0.5, 400)
    x = 1.5 + 0.3 * (u - 2.0)[:, None] + rng.normal(0, 0.2, (400, 2))
    idx = rng.integers(0, 400, (7, 400))
    betas = np.array([0.9, 1.1])
    jmodel = jbeta.factory_perturbmodel(1.0, u, x).resample({"indices": idx})
    tmodel = tbeta.factory_perturbmodel(1.0, u, x).resample({"indices": idx})
    assert tmodel.data.uv.shape == (7, 400)
    # the reference predicts from flat samples only; replicate by replicate
    for i in range(7):
        ref = np.asarray(JPerturbModel(1.0, type("D", (), {"uv": jmodel.data.uv[i], "xv": jmodel.data.xv[i]})()).predict(betas))
        got = PerturbModel(1.0, type("D", (), {"uv": tmodel.data.uv[i], "xv": tmodel.data.xv[i]})()).predict(betas)
        assert_close(got, ref, 1e-10)


# -- make_perturb_pipeline (tests/test_pipeline.py::TestPerturbPipeline) ---------------------


def _data(rng, r=4000, v=None):
    u = rng.normal(2.0, 0.5, r)
    shape = (r,) if v is None else (r, v)
    x = 1.5 + 0.3 * (u.reshape(r, *([1] * (len(shape) - 1))) - 2.0) + rng.normal(0, 0.2, shape)
    return u, x


@pytest.mark.parametrize("v", [None, 3])
def test_pipeline_matches_jax_and_model(rng, v):
    u, x = _data(rng, v=v)
    betas = np.array([0.9, 1.0, 1.15])
    got = tpipe.make_perturb_pipeline(1.0)(u, x, betas)
    assert got.dtype == torch.float64 and got.shape == (3,) + x.shape[1:]
    assert_close(got, np.asarray(jpipe.make_perturb_pipeline(1.0)(u, x, betas)), 1e-10)
    data = type("D", (), {"uv": tt(u), "xv": tt(x)})()
    assert_close(got, PerturbModel(1.0, data).predict(betas), 1e-12)
    # at beta0 the weights are uniform: the plain mean
    assert_close(got[1], x.mean(axis=0), 1e-12)


def test_pipeline_weights_match_jax(rng):
    u, x = _data(rng, r=1000)
    betas = np.array([0.95, 1.1])
    w = rng.uniform(0.5, 2.0, 1000) * (rng.uniform(size=1000) > 0.1)
    e = tpipe._perturb_weights(tt(u), tt(betas - 1.0), tt(w))
    assert_close(e, np.asarray(jpipe._perturb_weights(jnp.asarray(u), jnp.asarray(betas - 1.0), w)), 1e-12)
    assert torch.equal(e[:, w == 0], torch.zeros_like(e[:, w == 0]))
    run_w = tpipe.make_perturb_pipeline(1.0, weighted=True)
    base = run_w(u, x, betas, w)
    assert_close(base, np.asarray(jpipe.make_perturb_pipeline(1.0, weighted=True)(u, x, betas, w)), 1e-10)
    # zero-weight padding changes nothing
    up = np.concatenate([u, rng.normal(0, 1, 64)])
    xp = np.concatenate([x, rng.normal(0, 1, 64)])
    wp = np.concatenate([w, np.zeros(64)])
    assert_close(run_w(up, xp, betas, wp), base, 1e-12)


def test_pipeline_zero_rows_give_nan_at_the_division(rng):
    """All weights zero: the weight rows are exact zeros, the sums are zero
    and the prediction is the 0/0 NaN of the normalization, as in the
    reference (tests/test_pipeline.py:749); a replicate of all-zero counts
    gives a NaN replicate, so a NaN standard deviation."""
    u, x = _data(rng, r=64)
    e = tpipe._perturb_weights(tt(u), tt([0.1, -0.1]), tt(np.zeros(64)))
    assert torch.equal(e, torch.zeros_like(e))
    sums = mc.resample_perturb_freq(e, tt(x)[:, None], torch.ones((3, 64)))
    assert torch.equal(sums, torch.zeros_like(sums))
    out = tpipe.make_perturb_pipeline(1.0, weighted=True)(u, x, np.array([0.9, 1.1]), np.zeros(64))
    assert bool(torch.isnan(out).all())
    ref = np.asarray(jpipe.make_perturb_pipeline(1.0, weighted=True)(u, x, np.array([0.9, 1.1]), np.zeros(64)))
    assert np.isnan(ref).all()
    freq = torch.ones((3, 64), dtype=torch.float64)
    freq[1] = 0
    bpred = tpipe._perturb_boot(tpipe._perturb_weights(tt(u), tt([0.1]), None), tt(x)[:, None], freq)
    assert bool(torch.isnan(bpred[0, 1]).all()) and bool(torch.isfinite(bpred[0, [0, 2]]).all())


def test_pipeline_modes_validate_and_agree_on_cpu(rng):
    with pytest.raises(ValueError, match="table.*device"):
        tpipe.make_perturb_pipeline(1.0, poisson="hardware")
    u, x = _data(rng, r=500)
    betas = np.array([0.9, 1.1])
    p_t, s_t = tpipe.make_perturb_pipeline(1.0, nrep=16, poisson="table")(u, x, betas, seed=3)
    p_d, s_d = tpipe.make_perturb_pipeline(1.0, nrep=16, poisson="device")(u, x, betas, seed=3)
    assert torch.equal(p_t, p_d) and torch.equal(s_t, s_d)
    _, s_other = tpipe.make_perturb_pipeline(1.0, nrep=16)(u, x, betas, seed=4)
    assert not torch.equal(s_other, s_d)
    out = tpipe.make_perturb_pipeline(1.0)(u[:64], np.zeros((64, 0)), betas)
    assert out.shape == (2, 0)


def test_pipeline_bootstrap_std_tracks_jax(rng):
    u, x = _data(rng, r=3000, v=2)
    betas = np.array([0.92, 1.08])
    nrep = 300
    pred, std = tpipe.make_perturb_pipeline(1.0, nrep=nrep)(u, x, betas, seed=3)
    jpred, jstd = jpipe.make_perturb_pipeline(1.0, nrep=nrep)(u, x, betas, seed=3)
    assert std.shape == (2, 2) and bool((std > 0).all())
    assert_close(pred, np.asarray(jpred), 1e-10)
    ratio = npy(std) / np.asarray(jstd)
    assert np.all(ratio > 0.7) and np.all(ratio < 1.4), ratio
    # the population standard deviation of the replicates, as the reference takes it
    gen = torch.Generator().manual_seed(3)
    from thermoextrap_tpu_torch.ops.resample import poisson1_freq

    freq = poisson1_freq(gen, (nrep, 3000), dtype=torch.float64)
    e = tpipe._perturb_weights(tt(u), tt(betas - 1.0), None)
    assert_close(std, tpipe._perturb_boot(e, tt(x), freq).std(dim=1, correction=0), 1e-12)


def test_k8_sigma_is_unbiased_over_seeds(rng):
    """The bootstrap sigma of a plain mean from K8's counts (128 replicates,
    e = 1) scatters around the exact sigma/sqrt(R) with the ~6% standard
    error of a sigma from 128 replicates: every seed within 30%, the mean of
    8 seeds within 10%.  One seed alone can be 15% off."""
    r, nrep = 20_000, 128
    x = tt(rng.normal(1.0, 0.5, (r, 1)))
    ones = torch.ones((1, r), dtype=torch.float64)
    ratios = []
    for seed in (20240607, 20240608, 7, 5, 123456789, 1, 2, 3):
        s = mc.resample_perturb_poisson_plain(ones, x, nrep, seed=seed)[0]
        ratios.append(float((s[:, 0] / s[:, 1]).std()) / (0.5 / np.sqrt(r)))
    assert all(0.7 < q < 1.3 for q in ratios), ratios
    assert abs(np.mean(ratios) - 1.0) < 0.1, ratios
