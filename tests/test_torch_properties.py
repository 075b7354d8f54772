"""tests/test_properties.py on the torch port: each property of the series
algebra, the moment conversions and the plain reduce / merge / resample
paths, 20 hypothesis examples each.  Every example holds the port to the
property at the JAX test's tolerance and to the JAX package's output on the
same draw (1e-10 relative, or the property's own bar where it is looser).
``test_shift_raw_moments_composes`` passes the shifts as Python floats.
"""

from __future__ import annotations

import numpy as np
import pytest

hyp = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from _torch_parity import npy, tt  # noqa: E402

from thermoextrap_tpu.ops import convert as jconvert  # noqa: E402
from thermoextrap_tpu.ops import moments as jmoments  # noqa: E402
from thermoextrap_tpu.ops import resample as jresample  # noqa: E402
from thermoextrap_tpu.ops import series as jseries  # noqa: E402
from thermoextrap_tpu_torch.ops import convert, moments, resample, series  # noqa: E402

COMMON = settings(max_examples=20, deadline=None, derandomize=True)
PARITY = 1e-10

orders = st.integers(min_value=1, max_value=6)
seeds = st.integers(min_value=0, max_value=2**32 - 1)
samples = st.integers(min_value=3, max_value=400)


def _rng(seed):
    return np.random.default_rng(seed)


def _series(rng, k, batch=(), lead_positive=False):
    """Random length-(k+1) coefficient series with O(1) entries (numpy)."""
    c = rng.uniform(-2.0, 2.0, size=(k + 1, *batch))
    if lead_positive:
        c[0] = rng.uniform(0.5, 3.0, size=batch)
    elif abs(float(np.min(np.abs(c[0]) if batch else [abs(c[0])]))) < 1e-3:
        c[0] = np.where(np.abs(c[0]) < 1e-3, 1.0, c[0])
    return c


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(npy(got), np.asarray(want), rtol=rtol, atol=atol)


def _parity(got, ref, rtol=PARITY, atol=1e-12):
    """The port's output against the JAX package's on the same draw."""
    if isinstance(got, (tuple, list)):
        for g, r in zip(got, ref):
            _parity(g, r, rtol, atol)
        return
    _close(got, ref, rtol, atol)


# ---------------------------------------------------------------------------
# series ring laws
# ---------------------------------------------------------------------------


@COMMON
@given(seed=seeds, k=orders)
def test_series_mul_commutes_and_associates(seed, k):
    rng = _rng(seed)
    a, b, c = (_series(rng, k) for _ in range(3))
    ab = series.series_mul(tt(a), tt(b), order=k)
    _close(ab, npy(series.series_mul(tt(b), tt(a), order=k)), 1e-12, 1e-12)
    left = series.series_mul(ab, tt(c), order=k)
    right = series.series_mul(tt(a), series.series_mul(tt(b), tt(c), order=k), order=k)
    _close(left, npy(right), 1e-10, 1e-10)
    _parity(left, jseries.series_mul(jseries.series_mul(jnp.asarray(a), jnp.asarray(b), order=k), jnp.asarray(c), order=k))


@COMMON
@given(seed=seeds, k=orders)
def test_series_div_mul_roundtrip(seed, k):
    rng = _rng(seed)
    a = _series(rng, k)
    b = _series(rng, k, lead_positive=True)
    q = series.series_div(tt(a), tt(b), order=k)
    _close(series.series_mul(q, tt(b), order=k), a, 1e-9, 1e-9)
    _parity(q, jseries.series_div(jnp.asarray(a), jnp.asarray(b), order=k), atol=1e-10)


@COMMON
@given(seed=seeds, k=orders)
def test_series_inv_is_reciprocal(seed, k):
    rng = _rng(seed)
    b = _series(rng, k, lead_positive=True)
    one = np.zeros(k + 1)
    one[0] = 1.0
    inv = series.series_inv(tt(b), order=k)
    _close(series.series_mul(inv, tt(b), order=k), one, 1e-9, 1e-9)
    _parity(inv, jseries.series_inv(jnp.asarray(b), order=k), atol=1e-10)


@COMMON
@given(seed=seeds, k=orders, i=st.integers(min_value=0, max_value=5))
def test_series_pow_matches_repeated_mul(seed, k, i):
    rng = _rng(seed)
    a = _series(rng, k, lead_positive=True)
    expected = torch.zeros(k + 1, dtype=torch.float64)
    expected[0] = 1.0
    for _ in range(i):
        expected = series.series_mul(expected, tt(a), order=k)
    got = series.series_pow(tt(a), i, order=k)
    _close(got, npy(expected), 1e-9, 1e-9)
    _parity(got, jseries.series_pow(jnp.asarray(a), i, order=k), atol=1e-9)
    if i:
        one = np.zeros(k + 1)
        one[0] = 1.0
        _close(series.series_mul(got, series.series_pow(tt(a), -i, order=k), order=k), one, 1e-8, 1e-8)


def _series_ddx(c):
    """Formal derivative of a normalized-coefficient series: (n+1) c[n+1]."""
    return torch.stack([(n + 1) * c[n + 1] for n in range(c.shape[0] - 1)], dim=0)


@COMMON
@given(seed=seeds, k=st.integers(min_value=2, max_value=6))
def test_series_log_satisfies_a_logp_eq_ap(seed, k):
    rng = _rng(seed)
    a = tt(_series(rng, k, lead_positive=True))
    log_a = series.series_log(a, order=k)
    prod = series.series_mul(a, _series_ddx(log_a), order=k - 1)
    _close(prod, npy(_series_ddx(a)), 1e-9, 1e-9)
    _parity(log_a, jseries.series_log(jnp.asarray(npy(a)), order=k), atol=1e-10)


@COMMON
@given(seed=seeds, k=orders)
def test_series_log_product_rule(seed, k):
    rng = _rng(seed)
    a = tt(_series(rng, k, lead_positive=True))
    b = tt(_series(rng, k, lead_positive=True))
    lhs = series.series_log(series.series_mul(a, b, order=k), order=k)
    rhs = series.series_log(a, order=k) + series.series_log(b, order=k)
    _close(lhs, npy(rhs), 1e-9, 1e-9)
    np.testing.assert_array_equal(npy(series.series_neg_log(a, order=k)), -npy(series.series_log(a, order=k)))


@COMMON
@given(
    seed=seeds,
    k=orders,
    s=st.floats(min_value=-3.0, max_value=3.0, allow_nan=False),
    t=st.floats(min_value=-3.0, max_value=3.0, allow_nan=False),
)
def test_series_compose_linear_is_multiplicative(seed, k, s, t):
    rng = _rng(seed)
    a, b = tt(_series(rng, k)), tt(_series(rng, k))
    twice = series.series_compose_linear(series.series_compose_linear(a, s), t)
    once = series.series_compose_linear(a, s * t)
    _close(twice, npy(once), 1e-10, 1e-12)
    lhs = series.series_compose_linear(series.series_mul(a, b, order=k), s)
    rhs = series.series_mul(series.series_compose_linear(a, s), series.series_compose_linear(b, s), order=k)
    _close(lhs, npy(rhs), 1e-9, 1e-9)
    _parity(once, jseries.series_compose_linear(jnp.asarray(npy(a)), s * t))


@COMMON
@given(seed=seeds, k=orders)
def test_derivs_coefs_roundtrip(seed, k):
    c = _series(_rng(seed), k, batch=(2,))
    d = series.derivs_from_coefs(tt(c))
    _close(series.coefs_from_derivs(d), c, 1e-12, 1e-15)
    _parity(d, jseries.derivs_from_coefs(jnp.asarray(c)))


# ---------------------------------------------------------------------------
# moment conversions vs direct sample statistics
# ---------------------------------------------------------------------------


def _raw_moments(x, order):
    return np.stack([np.mean(x**n) for n in range(order + 1)])


def _central_moments(x, order):
    d = x - x.mean()
    out = np.stack([np.mean(d**n) for n in range(order + 1)])
    out[0], out[1] = 1.0, 0.0
    return out


@COMMON
@given(seed=seeds, k=orders, n=samples)
def test_central_from_raw_matches_sample_oracle(seed, k, n):
    x = _rng(seed).normal(1.5, 0.7, size=n)
    u = _raw_moments(x, k)
    du = convert.central_from_raw(tt(u))
    _close(du, _central_moments(x, k), 1e-9, 1e-12)
    _parity(du, jconvert.central_from_raw(jnp.asarray(u)))


@COMMON
@given(seed=seeds, k=orders)
def test_raw_central_roundtrip(seed, k):
    x = _rng(seed).normal(-0.8, 1.2, size=200)
    u = _raw_moments(x, k)
    du = convert.central_from_raw(tt(u))
    back = convert.raw_from_central(du, float(u[1]))
    _close(back, u, 1e-9, 1e-12)
    _parity(back, jconvert.raw_from_central(jconvert.central_from_raw(jnp.asarray(u)), float(u[1])))


@COMMON
@given(
    seed=seeds,
    k=orders,
    d1=st.floats(min_value=-2.0, max_value=2.0, allow_nan=False),
    d2=st.floats(min_value=-2.0, max_value=2.0, allow_nan=False),
)
def test_shift_raw_moments_composes(seed, k, d1, d2):
    """Python-float shifts, as the JAX test passes them."""
    u = _raw_moments(_rng(seed).normal(0.3, 1.1, size=100), k)
    twice = convert.shift_raw_moments(convert.shift_raw_moments(tt(u), d1), d2)
    once = convert.shift_raw_moments(tt(u), d1 + d2)
    _close(twice, npy(once), 1e-8, 1e-10)
    _parity(once, jconvert.shift_raw_moments(jnp.asarray(u), d1 + d2), atol=1e-10)
    _parity(convert.shift_raw_comoments(tt(u), d1), jconvert.shift_raw_comoments(jnp.asarray(u), d1), atol=1e-10)


@COMMON
@given(seed=seeds, k=orders, n=samples)
def test_central_comoments_from_raw_matches_sample_oracle(seed, k, n):
    rng = _rng(seed)
    u_s = rng.normal(2.0, 0.9, size=n)
    x_s = 0.4 * u_s + rng.normal(0.0, 0.5, size=n)
    u = _raw_moments(u_s, k)
    xu = np.stack([np.mean(x_s * u_s**m) for m in range(k + 1)])
    got = convert.central_comoments_from_raw(tt(u), tt(xu))
    dm, dx = u_s - u_s.mean(), x_s - x_s.mean()
    oracle = np.stack([np.mean(dx * dm**m) for m in range(k + 1)])
    oracle[0] = 0.0
    np.testing.assert_allclose(float(got[0]), x_s.mean(), rtol=1e-12)
    _close(got[1], _central_moments(u_s, k), 1e-9, 1e-12)
    _close(got[2], oracle, 1e-8, 1e-11)
    _parity(got, jconvert.central_comoments_from_raw(jnp.asarray(u), jnp.asarray(xu)), atol=1e-11)


@COMMON
@given(seed=seeds, k=orders)
def test_x_is_u_shift_trick(seed, k):
    u_s = _rng(seed).normal(1.0, 0.6, size=150)
    xu = np.stack([np.mean(u_s * u_s**m) for m in range(k + 1)])
    _close(convert.u_from_xu_when_x_is_u(tt(xu)), _raw_moments(u_s, k + 1), 1e-12, 1e-15)


# ---------------------------------------------------------------------------
# exact merge of randomly partitioned streams
# ---------------------------------------------------------------------------


@COMMON
@given(
    seed=seeds,
    k=orders,
    cuts=st.lists(st.integers(min_value=2, max_value=80), min_size=2, max_size=6),
    weighted=st.booleans(),
)
def test_merge_central_comoments_matches_one_shot(seed, k, cuts, weighted):
    rng = _rng(seed)
    n = sum(cuts)
    u_s = rng.normal(0.5, 1.3, size=n)
    x_s = np.sin(u_s) + rng.normal(0.0, 0.2, size=n)
    w = rng.uniform(0.2, 2.0, size=n) if weighted else np.ones(n)

    def stats(sl):
        us, xs, ws = u_s[sl], x_s[sl], w[sl]
        wt = ws.sum()
        um = (ws * us).sum() / wt
        xm = (ws * xs).sum() / wt
        du = np.stack([(ws * (us - um) ** m).sum() / wt for m in range(k + 1)])
        dxdu = np.stack([(ws * (xs - xm) * (us - um) ** m).sum() / wt for m in range(k + 1)])
        du[0], du[1], dxdu[0] = 1.0, 0.0, 0.0
        return xm, um, du, dxdu, wt

    parts, start = [], 0
    for c in cuts:
        parts.append(stats(slice(start, start + c)))
        start += c
    fields = (
        np.stack([p[0] for p in parts]),
        np.stack([p[1] for p in parts]),
        np.stack([p[2] for p in parts], axis=1),
        np.stack([p[3] for p in parts], axis=1),
        np.stack([p[4] for p in parts]),
    )
    got = convert.merge_central_comoments(*(tt(f) for f in fields))
    exp_xm, exp_um, exp_du, exp_dxdu, exp_wt = stats(slice(None))
    np.testing.assert_allclose(float(got[4]), exp_wt, rtol=1e-12)
    np.testing.assert_allclose(float(got[1]), exp_um, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(float(got[0]), exp_xm, rtol=1e-10, atol=1e-12)
    _close(got[2], exp_du, 1e-8, 1e-10)
    _close(got[3], exp_dxdu, 1e-8, 1e-10)
    _parity(got, jconvert.merge_central_comoments(*(jnp.asarray(f) for f in fields)), atol=1e-11)


# ---------------------------------------------------------------------------
# plain reduction / bootstrap paths vs per-replicate numpy statistics
# ---------------------------------------------------------------------------


@COMMON
@given(
    seed=seeds,
    k=orders,
    n=st.integers(min_value=4, max_value=150),
    nb=st.integers(min_value=0, max_value=2),
    v=st.integers(min_value=1, max_value=3),
    weighted=st.booleans(),
)
def test_reduce_central_comoments_matches_oracle(seed, k, n, nb, v, weighted):
    rng = _rng(seed)
    batch = tuple(rng.integers(1, 3, size=nb))
    uv = rng.normal(1.0, 0.8, size=(*batch, n))
    xv = rng.normal(-0.5, 1.1, size=(*batch, n, v))
    w = rng.uniform(0.1, 2.0, size=(*batch, n)) if weighted else None
    xave, uave, du, dxdu = moments.reduce_central_comoments(tt(uv), tt(xv), k, weight=None if w is None else tt(w))

    wo = np.ones((*batch, n)) if w is None else w
    wt = wo.sum(-1)
    um = (wo * uv).sum(-1) / wt
    xm = (wo[..., None] * xv).sum(-2) / wt[..., None]
    duo = np.stack([(wo * (uv - um[..., None]) ** m).sum(-1) / wt for m in range(k + 1)])
    dxduo = np.stack(
        [
            (wo[..., None] * (xv - xm[..., None, :]) * ((uv - um[..., None]) ** m)[..., None]).sum(-2) / wt[..., None]
            for m in range(k + 1)
        ]
    )
    duo[0], duo[1], dxduo[0] = 1.0, 0.0, 0.0
    _close(uave, um, 1e-10, 1e-12)
    _close(xave, xm, 1e-10, 1e-12)
    _close(du, duo, 1e-8, 1e-10)
    _close(dxdu, dxduo, 1e-8, 1e-10)
    ref = jax.jit(jmoments.reduce_central_comoments, static_argnums=2)(
        jnp.asarray(uv), jnp.asarray(xv), k, weight=None if w is None else jnp.asarray(w)
    )
    _parity((xave, uave, du, dxdu), ref, atol=1e-11)


@COMMON
@given(
    seed=seeds,
    k=orders,
    n=st.integers(min_value=4, max_value=120),
    nrep=st.integers(min_value=1, max_value=8),
    weighted=st.booleans(),
)
def test_resample_central_comoments_matches_oracle(seed, k, n, nrep, weighted):
    rng = _rng(seed)
    uv = rng.normal(2.0, 0.7, size=n)
    xv = rng.normal(0.0, 1.0, size=(n, 2))
    w = rng.uniform(0.2, 1.5, size=n) if weighted else None
    freq = rng.multinomial(n, np.ones(n) / n, size=nrep)
    got = resample.resample_central_comoments(tt(uv), tt(xv), tt(freq), k, weight=None if w is None else tt(w))
    xave, uave, du, dxdu = (npy(g) for g in got)

    wo = np.ones(n) if w is None else w
    for r in range(nrep):
        wr = freq[r] * wo
        wt = wr.sum()
        um = (wr * uv).sum() / wt
        xm = (wr[:, None] * xv).sum(0) / wt
        duo = np.stack([(wr * (uv - um) ** m).sum() / wt for m in range(k + 1)])
        dxduo = np.stack([(wr[:, None] * (xv - xm) * ((uv - um) ** m)[:, None]).sum(0) / wt for m in range(k + 1)])
        duo[0], duo[1], dxduo[0] = 1.0, 0.0, 0.0
        np.testing.assert_allclose(uave[r], um, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(xave[r], xm, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(du[:, r], duo, rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(dxdu[:, r], dxduo, rtol=1e-7, atol=1e-9)
    ref = jax.jit(jresample.resample_central_comoments, static_argnums=3)(
        jnp.asarray(uv), jnp.asarray(xv), jnp.asarray(freq), k, weight=None if w is None else jnp.asarray(w)
    )
    _parity(got, ref, rtol=1e-9, atol=1e-10)


@COMMON
@given(
    seed=seeds,
    k=orders,
    n=st.integers(min_value=4, max_value=100),
    nrep=st.integers(min_value=1, max_value=6),
    nb=st.integers(min_value=1, max_value=2),
)
def test_resample_umoments_batched_matches_oracle(seed, k, n, nrep, nb):
    rng = _rng(seed)
    batch = tuple(rng.integers(1, 4, size=nb))
    uv = rng.normal(-1.0, 0.9, size=(*batch, n))
    freq = rng.multinomial(n, np.ones(n) / n, size=nrep)
    uave, du = resample.resample_central_umoments_batched(tt(uv), tt(freq), k)
    assert uave.shape == (nrep, *batch)
    assert du.shape == (k + 1, nrep, *batch)

    flat = uv.reshape(-1, n)
    for r in range(nrep):
        wr = freq[r].astype(float)
        wt = wr.sum()
        um = (flat * wr).sum(-1) / wt
        duo = np.stack([(wr * (flat - um[:, None]) ** m).sum(-1) / wt for m in range(k + 1)])
        duo[0], duo[1] = 1.0, 0.0
        np.testing.assert_allclose(npy(uave)[r].ravel(), um, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(npy(du)[:, r].reshape(k + 1, -1), duo, rtol=1e-7, atol=1e-9)
    ref = jax.jit(jresample.resample_central_umoments_batched, static_argnums=2)(jnp.asarray(uv), jnp.asarray(freq), k)
    _parity((uave, du), ref, rtol=1e-9, atol=1e-10)


def test_repaired_shift_values():
    """A Python-number or 0-d tensor shift gives the JAX package's values
    (it raised a TypeError before)."""
    m = tt([1.0, 0.3, 1.5, 0.9])
    for shift in (0.3, torch.tensor(0.3, dtype=torch.float64)):
        _close(convert.shift_raw_moments(m, shift), [1.0, 0.0, 1.41, -0.396], 1e-12, 1e-15)
        _close(convert.shift_raw_comoments(m, shift), [1.0, 0.0, 1.41, -0.396], 1e-12, 1e-15)
    _close(convert.raw_from_central(tt([1.0, 0.0, 1.2, 0.1]), 0.3), [1.0, 0.3, 1.29, 1.207], 1e-12, 1e-15)
    _parity(convert.raw_from_central(tt([1.0, 0.0, 1.2, 0.1]), 0.3), jconvert.raw_from_central(jnp.asarray([1.0, 0.0, 1.2, 0.1]), 0.3))
