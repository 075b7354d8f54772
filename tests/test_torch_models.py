"""The collection models of the torch port against the JAX package, on the CPU
(float64 on both sides): ``StateCollection``, ``ExtrapWeightedModel``,
``InterpModel``, ``InterpModelPiecewise``, ``xr_weights_minkowski`` and
``predict_fn``, mirroring ``tests/test_models.py`` (TestInterpModel,
TestExtrapWeighted, TestStateCollection, the Minkowski underflow case,
``test_predict_fn_jittable``) and
``tests/test_edges.py::test_interp_single_state_collection_order``.

States are built in both packages from the same numpy samples.  Tolerances,
with their reasons: the JAX tests' own bars for the properties they check
(Hermite property rtol 1e-7, polynomial recovery 1e-10, piecewise and
weighted identities 1e-10, float32 Minkowski weights 1e-4); port against JAX
rtol 1e-10 (the same reductions and series in float64) where the joint system
is mild (two states at order 3: condition 2e7), and rtol 1e-8, the JAX
suite's bar for streaming against one-shot interpolation
(tests/test_streaming.py), for three states at order 3 (condition 2e11: two
LU factorizations, LAPACK's and XLA's, may differ by up to cond * eps = 2e-5;
they differ by 2.6e-9 here).
"""

import doctest
import math

import numpy as np
import pytest
import torch
from _torch_parity import assert_close, npy, tt

import thermoextrap_tpu as jx
import thermoextrap_tpu_torch as tx
from thermoextrap_tpu import beta as jbeta
from thermoextrap_tpu.models import extrap as jextrap
from thermoextrap_tpu_torch import beta as tbeta
from thermoextrap_tpu_torch.models import extrap as textrap
from thermoextrap_tpu_torch.models.derivatives import Derivatives

ORDER = 3
RTOL, ATOL = 1e-10, 1e-12
RTOL_COND = 1e-8  # three states' joint solve (condition 2e11)
BETAS = ((0.5, 0), (1.0, 1), (1.5, 2))


def _samples(seed, beta0, n=80):
    rng = np.random.default_rng(seed)
    return rng.normal(loc=2.0, size=n), rng.normal(loc=1.0 + beta0, size=(n, 2))


def _state(pkg, beta0, seed, order=ORDER):
    u, x = _samples(seed, beta0)
    if pkg == "jax":
        return jbeta.factory_extrapmodel(beta0, jx.DataValuesCentral.from_vals(x, u, order))
    return tbeta.factory_extrapmodel(beta0, tx.DataValuesCentral.from_vals(tt(x), tt(u), order))


@pytest.fixture(scope="module")
def states():
    return [_state("torch", b, s) for b, s in BETAS]


@pytest.fixture(scope="module")
def jstates():
    return [_state("jax", b, s) for b, s in BETAS]


# -- TestInterpModel ----------------------------------------------------------------------


def test_interp_hermite_property_and_jax(states, jstates):
    """The joint polynomial reproduces each state's derivatives at its own
    alpha0, and its coefficients are the JAX package's."""
    interp = textrap.InterpModel(states[:2])
    coefs = npy(interp.coefs())
    assert interp.coefs().dtype == torch.float64
    porder = coefs.shape[0] - 1
    for m in states[:2]:
        derivs = npy(m.derivs())
        for j in range(ORDER + 1):
            val = sum(
                coefs[p] * math.factorial(p) / math.factorial(p - j) * m.alpha0 ** (p - j)
                for p in range(j, porder + 1)
            )
            np.testing.assert_allclose(val, derivs[j], rtol=1e-7, atol=1e-10)
    jinterp = jextrap.InterpModel(jstates[:2])
    assert_close(interp.coefs(), jinterp.coefs(), RTOL, ATOL)
    alphas = np.array([0.5, 0.7, 1.0])
    assert_close(interp.predict(alphas), jinterp.predict(alphas), RTOL, ATOL)
    assert_close(interp.predict(0.8), jinterp.predict(0.8), RTOL, ATOL)
    # the reference's functional form, powers of absolute alpha
    derivs = [m.derivs() for m in states[:2]]
    coefs_abs = textrap.joint_interp_coefs([0.5, 1.0], derivs, ORDER)
    assert_close(coefs_abs, jextrap.joint_interp_coefs([0.5, 1.0], [npy(d) for d in derivs], ORDER), RTOL, ATOL)
    assert_close(textrap.eval_abs_poly(coefs_abs, alphas), interp.predict(alphas), RTOL, ATOL)
    # cached per (order, minus_log), and a lower order is its own entry
    assert interp.fit() is interp.fit()
    assert_close(interp.coefs(order=1), jinterp.coefs(order=1), RTOL, ATOL)
    assert interp.coefs(order=1).shape[0] == 4


def test_interp_three_states_and_replicates_ride_the_solve(states, jstates):
    """Three states (joint order 11) and bootstrap replicates, whose axis
    rides the solve's right-hand side: one solve equals a solve per
    replicate, and the JAX package's on the same indices."""
    alphas = np.array([0.6, 1.2])
    assert_close(
        textrap.InterpModel(states).predict(alphas), jextrap.InterpModel(jstates).predict(alphas), RTOL_COND, ATOL
    )
    idx = np.random.default_rng(3).integers(0, 80, (5, 80))
    rep = textrap.InterpModel(states[:2]).resample({"indices": idx})
    jrep = jextrap.InterpModel(jstates[:2]).resample({"indices": idx})
    got = rep.predict(alphas)
    assert got.shape == (2, 5, 2)
    assert_close(got, jrep.predict(alphas), RTOL, ATOL)
    one = textrap.InterpModel([type(m)(m.alpha0, _take(m.data, 2), m.derivatives, m.order) for m in rep])
    assert_close(got[:, 2], one.predict(alphas), RTOL, ATOL)


def _take(data, r):
    """Replicate ``r`` of a resampled values container, as a flat one."""
    import dataclasses

    return dataclasses.replace(data, uv=data.uv[r], xv=data.xv[r], weight=None)


def test_interp_polynomial_recovery():
    """Two order-1 states whose derivatives come from a cubic recover it
    exactly (the coefficient function returns torch tensors)."""
    poly = np.array([0.3, -0.2, 0.5, 1.0])

    class FakeData:
        def __init__(self, beta0):
            self.order = 1
            self.derivs_args = (beta0,)

    def coef_fn(args, order):
        (b0,) = args
        rows = [
            sum(poly[p] * math.factorial(p) / math.factorial(p - j) * b0 ** (p - j) for p in range(j, 4))
            / math.factorial(j)
            for j in range(order + 1)
        ]
        return torch.tensor(rows, dtype=torch.float64)

    d = Derivatives(coefs_fn=coef_fn, name="poly")
    interp = textrap.InterpModel([textrap.ExtrapModel(b, FakeData(b), d, order=1) for b in (0.5, 1.5)])
    np.testing.assert_allclose(npy(interp.coefs()), poly, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(npy(interp.predict(2.0)), np.polyval(poly[::-1], 2.0), rtol=1e-10)


def test_interp_doctest_example():
    """The ``InterpModel`` docstring example (numpy-valued derivative
    functions) runs on the port."""
    flags = doctest.ELLIPSIS | doctest.NORMALIZE_WHITESPACE
    finder = doctest.DocTestFinder()
    runner = doctest.DocTestRunner(optionflags=flags)
    for test in finder.find(textrap.InterpModel, "InterpModel", globs=vars(textrap).copy()):
        runner.run(test)
    assert runner.tries >= 1 and runner.failures == 0


def test_interp_piecewise_matches_pair_and_jax(states, jstates):
    pw = textrap.InterpModelPiecewise(states)
    jpw = jextrap.InterpModelPiecewise(jstates)
    pair = textrap.InterpModel(states[0:2])
    np.testing.assert_allclose(npy(pw.predict(0.75)), npy(pair.predict(0.75)), rtol=1e-10)
    out = pw.predict(np.array([0.6, 1.2]))
    assert out.shape == (2, 2)
    assert_close(out, jpw.predict(np.array([0.6, 1.2])), RTOL, ATOL)
    for method in ("between", "nearest"):
        assert_close(pw.predict(1.4, method=method), jpw.predict(1.4, method=method), RTOL, ATOL)
    assert pw.single_interpmodel(1, 2) is pw.single_interpmodel(1, 2)
    with pytest.raises(ValueError, match="unknown method"):
        pw.predict(1.0, method="spline")
    with pytest.raises(ValueError, match="outside of bounds"):
        pw.predict(np.array([1.0, 1.6]), bounded=True)


# -- TestExtrapWeighted -------------------------------------------------------------------


def test_weighted_endpoint_equals_state(states, jstates):
    ew = textrap.ExtrapWeightedModel(states[:2])
    a = states[0].alpha0
    np.testing.assert_allclose(npy(ew.predict(a)), npy(states[0].predict(a)), rtol=1e-10)
    alphas = np.array([0.5, 0.7, 1.0])
    assert_close(ew.predict(alphas), jextrap.ExtrapWeightedModel(jstates[:2]).predict(alphas), RTOL, ATOL)


def test_weighted_multi_state_selection(states, jstates):
    ew = textrap.ExtrapWeightedModel(states)
    out = ew.predict(np.array([0.7, 1.3]))
    assert out.shape == (2, 2)
    pair = textrap.ExtrapWeightedModel(states[1:])
    np.testing.assert_allclose(npy(out[1]), npy(pair.predict(1.3)), rtol=1e-10)
    jew = jextrap.ExtrapWeightedModel(jstates)
    assert_close(out, jew.predict(np.array([0.7, 1.3])), RTOL, ATOL)
    assert_close(ew.predict(0.9, method="nearest"), jew.predict(0.9, method="nearest"), RTOL, ATOL)
    # a tensor alpha gives the same answer
    assert_close(ew.predict(torch.tensor([0.7, 1.3], dtype=torch.float64)), out, 0.0)


def test_minkowski_weights_no_f32_underflow():
    """A raw delta**20 underflows in float32 below ~0.006; the normalized
    form stays finite and matches float64 and the JAX package."""
    import jax.numpy as jnp

    w = textrap.xr_weights_minkowski(torch.tensor([0.004, 0.006], dtype=torch.float32))
    assert w.dtype == torch.float32 and bool(torch.isfinite(w).all())
    ref = textrap.xr_weights_minkowski(np.array([0.004, 0.006], np.float64))
    np.testing.assert_allclose(npy(w), npy(ref), rtol=1e-4)
    assert_close(ref, jextrap.xr_weights_minkowski(np.array([0.004, 0.006])), 1e-13)
    w0 = textrap.xr_weights_minkowski(torch.tensor([0.0, 0.0], dtype=torch.float32))
    np.testing.assert_allclose(npy(w0), [0.5, 0.5])
    d = np.random.default_rng(1).uniform(0.0, 2.0, (3, 4))
    assert_close(
        textrap.xr_weights_minkowski(d, m=6, axis=1),
        jextrap.xr_weights_minkowski(jnp.asarray(d), m=6, axis=1),
        1e-12,
    )


# -- TestStateCollection ------------------------------------------------------------------


def test_state_collection_basic_api(states):
    sc = tx.StateCollection(states)
    assert len(sc) == 3
    assert sc.order == ORDER
    assert sc.alpha0 == [0.5, 1.0, 1.5]
    assert sc.alpha_name == "beta"
    appended = sc.append([_state("torch", 0.75, 9)])
    assert [m.alpha0 for m in appended] == [0.5, 0.75, 1.0, 1.5]
    assert [m.alpha0 for m in sc.append([_state("torch", 0.75, 9)], sort=False)] == [0.5, 1.0, 1.5, 0.75]
    with pytest.raises(ValueError, match="outside of bounds"):
        sc._check_alpha(2.0, bounded=True)
    sc._check_alpha(2.0)


def test_state_collection_resample(states, jstates):
    sc = tx.StateCollection(states)
    rs = sc.resample({"nrep": 4})
    assert rs[0].predict(0.6).shape == (4, 2)
    # one sampler per state, the JAX package's answer on the same indices
    idx = [np.random.default_rng(s).integers(0, 80, (4, 80)) for s in range(3)]
    got = sc.resample([{"indices": i} for i in idx])
    ref = jx.StateCollection(jstates).resample([{"indices": i} for i in idx])
    for g, r in zip(got, ref):
        assert_close(g.predict(0.6), r.predict(0.6), RTOL, ATOL)
    with pytest.raises(ValueError, match="must equal"):
        sc.resample([{"nrep": 2}] * 2)


def test_state_collection_map_concat(states, jstates):
    sc = tx.StateCollection(states)
    out = sc.map_concat("predict", 0.8)
    assert out.shape == (3, 2)
    np.testing.assert_allclose(npy(out), np.stack([npy(s.predict(0.8)) for s in sc]))
    np.testing.assert_allclose(npy(sc.map_concat(lambda s: s.predict(0.8))), npy(out))
    assert_close(out, jx.StateCollection(jstates).map_concat("predict", 0.8), RTOL, ATOL)
    assert [float(a) for a in sc.map(lambda s: s.alpha0)] == sc.alpha0


def test_interp_single_state_collection_order():
    """StateCollection.order is the smallest of its states' orders
    (tests/test_edges.py)."""
    rng = np.random.default_rng(0)

    def mk(order, b):
        d = tx.factory_data_values(uv=rng.normal(size=50), xv=rng.normal(size=(50, 1)), order=order, central=True)
        return tbeta.factory_extrapmodel(b, d)

    sc = tx.StateCollection([mk(2, 0.5), mk(4, 1.5)])
    assert sc.order == 2
    assert textrap.InterpModel(list(sc)).coefs().shape[0] == 2 * 3


# -- predict_fn ---------------------------------------------------------------------------


def test_predict_fn_closure_and_autograd(states, jstates):
    """predict_fn is a plain closure over the coefficients: equal to the
    model's predict and to the JAX package's, and differentiable in alpha."""
    fn = textrap.predict_fn(states[0])
    alphas = np.array([0.6, 0.9])
    np.testing.assert_allclose(npy(fn(alphas)), npy(states[0].predict(alphas)), rtol=1e-12)
    assert_close(fn(alphas), jextrap.predict_fn(jstates[0])(alphas), RTOL, ATOL)
    a = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    fn(a).sum().backward()
    assert np.isfinite(float(a.grad))
    # the slope of the series at alpha0 + 0.2, by hand
    c = npy(states[0].coefs())
    want = sum(n * c[n] * 0.2 ** (n - 1) for n in range(1, ORDER + 1)).sum()
    np.testing.assert_allclose(float(a.grad), want, rtol=1e-12)


def test_interp_keeps_the_digits_the_absolute_basis_cancels():
    """Between states 5.2 and 6.0 at order 6 the reference's joint polynomial
    in powers of absolute alpha (condition 1.2e20) has coefficients of
    ~1e9 from sampled derivatives, which cancel when evaluated: its one-shot
    and streaming forms, the same float64 data summed in two orders, differ
    far beyond roundoff.  The port's centered, scaled solve (condition 6e4)
    agrees with itself to roundoff, and both packages' answers agree with
    each other to the reference's own scatter."""
    import jax.numpy as jnp

    from thermoextrap_tpu import pipeline as jpipe
    from thermoextrap_tpu_torch import pipeline as tpipe

    rng = np.random.default_rng(0)
    b0s, betas = (5.2, 6.0), np.array([5.2, 5.4, 5.6, 5.8, 6.0])
    data = []
    for b in b0s:
        pos = -np.log(1.0 - rng.uniform(size=(20_000, 8)) * (1.0 - np.exp(-b))) / b
        data.append((pos.sum(-1), pos.mean(-1)))

    def chunked(update, states):
        for i, (u, x) in enumerate(data):
            for k in range(10):
                states = update(states, i, u[k::10], x[k::10])
        return states

    jone = jextrap.InterpModel([jbeta.factory_extrapmodel(b, jx.DataCentralMoments.from_vals(x, u, 6)) for b, (u, x) in zip(b0s, data)])
    jst, jup, jpr = jpipe.make_streaming_interp_pipeline(6, b0s, dtype=jnp.float64)
    ja, jb = np.asarray(jone.predict(betas)), np.asarray(jpr(chunked(jup, jst), betas))
    tone = textrap.InterpModel([tbeta.factory_extrapmodel(b, tx.DataCentralMoments.from_vals(tt(x), tt(u), 6)) for b, (u, x) in zip(b0s, data)])
    tst, tup, tpr = tpipe.make_streaming_interp_pipeline(6, b0s, device="cpu")
    ta, tb = npy(tone.predict(betas)), npy(tpr(chunked(tup, tst), betas))
    assert np.abs(np.asarray(jone.coefs())).max() > 1e7
    assert np.max(np.abs(ja - jb) / np.abs(ja)) > 1e-6
    np.testing.assert_allclose(tb, ta, rtol=1e-12)
    np.testing.assert_allclose(ta, ja, rtol=1e-2)
