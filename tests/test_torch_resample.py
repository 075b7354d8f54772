"""K2 / K3 (the bootstrap sums) and the resampling helpers of the torch port.

- K2's plain version and the port's ``ops.resample`` against JAX
  ``resample_central_comoments`` on the same numpy count table (int8,
  int32, fractional), float64 at rtol 1e-10;
- K3's counts: the Philox4x32-10 known-answer vectors, the Poisson(1)
  chi-square of tests/test_moments.py:184, independence of the chunking,
  and K3's plain version equal to K2's plain version on the materialized
  table;
- the bootstrap spread against the bounds of tests/test_parallel.py:101.
"""

import math

import numpy as np
import pytest
import torch
from _torch_parity import assert_close, npy, tt

from thermoextrap_tpu.ops import resample as jr
from thermoextrap_tpu_torch.ops import dispatch, moments_cuda as mc
from thermoextrap_tpu_torch.ops import resample as tr
from thermoextrap_tpu_torch.utils.random import validate_rng

RTOL64 = 1e-10
ATOL64 = 1e-12


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _samples(rng, r, v):
    u = rng.normal(5.0, 1.0, r)
    x = 2.0 + 0.3 * (u[:, None] - 5.0) + rng.normal(0.0, 0.5, (r, v))
    return u, x


def _table(rng, nrep, r, kind):
    idx = rng.integers(0, r, (nrep, r))
    freq = np.asarray(jr.freq_from_indices(idx, r))
    if kind == "fractional":
        return freq * rng.uniform(0.5, 1.5, freq.shape)
    return freq.astype(kind)


# -- K2 and the plain bootstrap against JAX -------------------------------------


@pytest.mark.parametrize(
    ("kind", "v", "weighted"),
    [("int8", 1, False), ("int32", 2, True), ("fractional", 1, True), ("int64", 3, False)],
)
def test_k2_plain_matches_jax_f64(rng, kind, v, weighted):
    r, nrep = 1200, 6
    u, x = _samples(rng, r, v)
    w = rng.uniform(0.5, 1.5, r) if weighted else None
    freq = _table(rng, nrep, r, kind)
    ref = jr.resample_central_comoments(u, x, freq, 6, weight=w)
    tw = None if w is None else tt(w)
    assert_close(mc.resample_central_comoments_fused(tt(u), tt(x), tt(freq), 6, tw), ref, RTOL64, ATOL64)
    assert_close(tr.resample_central_comoments(tt(u), tt(x), tt(freq), 6, weight=tw), ref, RTOL64, ATOL64)
    assert_close(dispatch.resample_central(tt(u), tt(x), tt(freq), 6, weight=tw), ref, RTOL64, ATOL64)


def test_resample_helpers_match_jax(rng):
    r, nrep = 300, 5
    u, x = _samples(rng, r, 2)
    idx = rng.integers(0, r, (nrep, r))
    assert_close(tr.freq_from_indices(tt(idx), r), jr.freq_from_indices(idx, r), 0.0)
    assert_close(tr.resample_values(tt(x), tt(idx)), jr.resample_values(x, idx), 0.0)
    assert_close(tr.resample_values(tt(x), tt(idx[:, :7]), rec_axis=0), jr.resample_values(x, idx[:, :7], 0), 0.0)
    freq = np.asarray(jr.freq_from_indices(idx, r))
    w = rng.uniform(0.5, 1.5, r)
    ref = jr.resample_raw_comoments(u, x, freq, 4, weight=w)
    assert_close(tr.resample_raw_comoments(tt(u), tt(x), tt(freq), 4, weight=tt(w)), ref, RTOL64, ATOL64)
    ub = rng.normal(2.0, 1.0, (3, r))
    ref = jr.resample_central_umoments_batched(ub, freq, 5, weight=w)
    assert_close(tr.resample_central_umoments_batched(tt(ub), tt(freq), 5, weight=tt(w)), ref, RTOL64, ATOL64)


def test_random_tables(rng):
    gen = validate_rng(5)
    idx = tr.random_indices(gen, 4, 50)
    assert idx.shape == (4, 50) and int(idx.min()) >= 0 and int(idx.max()) < 50
    f = tr.random_freq(validate_rng(5), 4, 50)
    assert f.dtype == torch.int32 and bool((f.sum(1) == 50).all())
    p = tr.random_freq(validate_rng(5), 200, 500, method="poisson")
    assert abs(float(p.double().mean()) - 1.0) < 0.02
    pe = tr.random_freq(validate_rng(5), 200, 500, method="poisson_exact")
    assert abs(float(pe.double().mean()) - 1.0) < 0.02
    with pytest.raises(ValueError, match="unknown method"):
        tr.random_freq(gen, 2, 2, method="dirichlet")
    assert tr.POISSON1_CDF == jr.POISSON1_CDF
    with pytest.raises(TypeError):
        validate_rng("seed")


def test_zero_replicate_row_is_finite(rng):
    """An all-zero count row takes the finite convention of the plain
    bootstrap (raw moments [1, 0, ...]) on both the K2 plain path and the
    two-pass path, instead of 0/0."""
    r = 400
    u, x = _samples(rng, r, 1)
    freq = np.ones((3, r), np.int32)
    freq[1] = 0
    ref = jr.resample_central_comoments(u, x, freq, 4)
    for got in (
        mc.resample_central_comoments_fused(tt(u), tt(x), tt(freq), 4),
        tr.resample_central_comoments(tt(u), tt(x), tt(freq), 4),
    ):
        assert all(bool(torch.isfinite(g).all()) for g in got)
        np.testing.assert_allclose(npy(got[2][2:, 1]), 0.0, atol=1e-12)
        assert_close((got[0][0], got[2][:, 0]), (ref[0][0], ref[2][:, 0]), RTOL64, ATOL64)
    # the K2 plain path's zero row sits at the head shift
    s_u, _ = mc._head_shift(tt(u)[None], None, tt(x)[None])
    np.testing.assert_allclose(npy(mc.resample_central_comoments_fused(tt(u), tt(x), tt(freq), 4)[1][1]), npy(s_u[0]), rtol=RTOL64)


# -- K3's counts ------------------------------------------------------------------


def _philox(c, k):
    words = mc._philox4x32_10(*[torch.tensor([v], dtype=torch.int64) for v in c], k[0], k[1])
    return [int(w) for w in words]


@pytest.mark.parametrize(
    ("ctr", "key", "out"),
    [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        (
            (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
            (0xA4093822, 0x299F31D0),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1),
        ),
    ],
)
def test_philox_known_answers(ctr, key, out):
    """Philox4x32-10 in int64 torch arithmetic reproduces the published
    Random123 known-answer vectors (the 32x32 products overflow int64;
    only their masked words are read)."""
    assert _philox(ctr, key) == list(out)


def test_poisson_counts_distribution():
    """Poisson(1) truncated at 9: chi-square against the exact pmf, with
    the small bins pooled (tests/test_moments.py:184)."""
    f = npy(mc._poisson_counts(3, 50, 4000)).ravel()
    n = f.size
    assert f.min() >= 0 and f.max() <= len(tr.POISSON1_CDF)
    counts = np.bincount(f, minlength=10)[:10].astype(np.float64)
    pmf = np.array([math.exp(-1.0) / math.factorial(k) for k in range(10)])
    pmf[9] = 1.0 - pmf[:9].sum()
    expect = n * pmf
    keep = expect > 5
    counts_p = np.append(counts[keep], counts[~keep].sum())
    expect_p = np.append(expect[keep], expect[~keep].sum())
    chi2 = float(((counts_p - expect_p) ** 2 / expect_p).sum())
    assert chi2 < 30, (chi2, counts)
    assert abs(f.mean() - 1.0) < 0.02
    assert abs(f.var() - 1.0) < 0.03


def test_poisson_counts_are_a_function_of_seed_rep_sample():
    """The counts do not depend on the chunking or the replicate count, and
    adjacent seeds are independent streams."""
    full = mc._poisson_counts(9, 6, 1003)
    parts = torch.cat([mc._poisson_counts(9, 6, 400, start=0), mc._poisson_counts(9, 6, 603, start=400)], dim=1)
    assert torch.equal(full, parts)
    assert torch.equal(mc._poisson_counts(9, 3, 1003), full[:3])
    a = npy(mc._poisson_counts(9, 8, 5000)).astype(float).ravel()
    b = npy(mc._poisson_counts(10, 8, 5000)).astype(float).ravel()
    assert abs(np.corrcoef(a, b)[0, 1]) < 0.03
    with pytest.raises(ValueError, match="multiple of 4"):
        mc._poisson_counts(9, 2, 10, start=2)


@pytest.mark.parametrize("weighted", [False, True])
def test_k3_plain_equals_k2_plain_on_table(rng, weighted):
    r, nrep = 3001, 7
    u, x = _samples(rng, r, 2)
    w = tt(rng.uniform(0.5, 1.5, r)) if weighted else None
    table = mc._poisson_counts(21, nrep, r)
    k2 = mc.resample_central_comoments_fused(tt(u), tt(x), table, 5, w)
    k3 = mc.resample_central_comoments_poisson(tt(u), tt(x), nrep, 5, w, seed=21)
    assert_close(k3, k2, 1e-12, 1e-14)
    chunked = mc.resample_poisson_plain(tt(u), tt(x), nrep, 5, w, seed=21, chunk=512)
    assert_close(chunked[:4], k2, 1e-12, 1e-14)
    ref = jr.resample_central_comoments(u, x, npy(table), 5, weight=None if w is None else npy(w))
    assert_close(k3, ref, RTOL64, ATOL64)


def test_poisson_bootstrap_statistics(rng):
    """K3 (plain path here): replicate means scatter at the standard error
    (tests/test_parallel.py:101 bounds); return_wsum adds the replicate
    weight totals, ~ R."""
    r, nrep, order = 4000, 64, 4
    u = rng.normal(5.0, 1.0, r).astype(np.float32)
    x = rng.normal(2.0, 0.5, (r, 1)).astype(np.float32)
    xave, uave, du, dxdu = mc.resample_central_comoments_poisson(tt(u), tt(x), nrep, order, seed=3)
    assert xave.shape == (nrep, 1) and du.shape == (order + 1, nrep)
    assert abs(float(uave.mean()) - u.mean()) < 5 * 1.0 / np.sqrt(r)
    sem = float(xave.std())
    assert 0.5 * 0.5 / np.sqrt(r) < sem < 2.0 * 0.5 / np.sqrt(r)
    np.testing.assert_allclose(npy(du[0]), 1.0)
    np.testing.assert_allclose(npy(du[1]), 0.0, atol=1e-12)
    out = mc.resample_central_comoments_poisson(tt(u), tt(x), nrep, order, seed=3, return_wsum=True)
    assert_close(out[:4], (xave, uave, du, dxdu), 0.0)
    assert out[4].shape == (nrep,)
    assert bool(((out[4] - r).abs() < 6 * np.sqrt(r)).all())
