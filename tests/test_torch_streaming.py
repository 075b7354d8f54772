"""The streaming accumulator and pipelines of the torch port against the JAX
package, on the CPU (float64 on both sides).

Inputs are made with numpy from a seed and fed to both packages in the same
chunks.  Tolerances, with their reasons:

- any chunking against one shot, and port against JAX on the mean leg: rtol
  1e-10 (the same exact merge in float64; only the order of sums differs);
- the replicate fold: exact to rtol 1e-9 against the one-shot bootstrap on
  the concatenation of the very count tables the chunks drew, in the port
  and, on those same tables, in the JAX package;
- bootstrap standard deviations across packages, whose random counts differ
  (threefry against torch's generator): a ratio within [0.7, 1.4] at 300
  replicates (~4% relative error of each side at that count);
- the streaming interpolation against the one-shot ``InterpModel`` and the
  JAX pipeline: rtol 1e-8, the JAX test's bar (the joint system's condition
  is 2e11 at order 4, and the two merge orders differ by ~1e-15); its
  replicate fold against the one-shot bootstrap over the port's own
  per-chunk count tables: rtol 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import assert_close, npy, tt

import thermoextrap_tpu as jx
import thermoextrap_tpu_torch as tx
from thermoextrap_tpu import beta as jbeta
from thermoextrap_tpu import pipeline as jpipe
from thermoextrap_tpu.ops import resample as jresample
from thermoextrap_tpu.utils.trees import replace as jreplace
from thermoextrap_tpu_torch import DataCentralMoments, interop
from thermoextrap_tpu_torch import beta as tbeta
from thermoextrap_tpu_torch import pipeline as tpipe
from thermoextrap_tpu_torch.ops import resample as tresample

BETAS = np.array([0.8, 1.0, 1.2])
F64 = {"dtype": torch.float64, "device": "cpu"}


@pytest.fixture
def rng():
    return np.random.default_rng(31)


def _chunks(rng, n=4, c=250, v=2):
    uv = rng.normal(5.0, 1.0, n * c)
    xv = 2.0 + 0.3 * (uv[:, None] - 5.0) + rng.normal(0.0, 0.5, (n * c, v))
    return uv, xv, [(uv[i * c : (i + 1) * c], xv[i * c : (i + 1) * c]) for i in range(n)]


def _same_state(got, ref, rtol=1e-10):
    """Port state against a JAX state, field by field through interop."""
    g, r = interop.data_to_numpy(got), interop.data_to_numpy(ref)
    for name in interop.FLAGS:
        assert g[name] == r[name], name
    for name in interop.FIELDS:
        assert g[name].shape == r[name].shape, name
        np.testing.assert_allclose(g[name], r[name], rtol=rtol, atol=1e-13, err_msg=name)


# -- DataCentralMoments.zeros / merge / push_vals ------------------------------------------


@pytest.mark.parametrize(
    "kws",
    [
        {"val_shape": (2,)},
        {"val_shape": ()},
        {"batch_shape": (3,), "x_is_u": True},
        {"val_shape": (2,), "xalpha": True},
        {"val_shape": (), "xalpha": True, "deriv": 2},
    ],
)
def test_zeros_matches_jax(kws):
    got = DataCentralMoments.zeros(3, **kws, **F64)
    ref = jx.DataCentralMoments.zeros(3, dtype=jnp.float64, **kws)
    _same_state(got, ref)
    assert float(got.du[0].min()) == 1.0 and got.wsum.dtype == torch.float64
    assert DataCentralMoments.zeros(3, device="cpu").xave.dtype == torch.float64


def test_zeros_merge_chunk_returns_the_chunk(rng):
    uv, xv, chunks = _chunks(rng)
    chunk = DataCentralMoments.from_vals(tt(chunks[0][1]), tt(chunks[0][0]), 3)
    merged = DataCentralMoments.zeros(3, val_shape=(2,), **F64).merge(chunk)
    _same_state(merged, chunk, rtol=1e-14)
    with pytest.raises(ValueError, match="identical order"):
        DataCentralMoments.zeros(2, val_shape=(2,), **F64).merge(chunk)
    with pytest.raises(ValueError, match="deriv axis and batch axes"):
        DataCentralMoments.zeros(2, batch_shape=(2,), xalpha=True, **F64)


@pytest.mark.parametrize("weighted", [False, True])
def test_push_vals_equals_one_shot_and_jax(rng, weighted):
    uv, xv, chunks = _chunks(rng)
    w = rng.uniform(0.5, 1.5, len(uv)) if weighted else None
    state = DataCentralMoments.zeros(3, val_shape=(2,), **F64)
    jstate = jx.DataCentralMoments.zeros(3, val_shape=(2,), dtype=jnp.float64)
    lo = 0
    for cu, cx in chunks:
        cw = None if w is None else w[lo : lo + len(cu)]
        state = state.push_vals(cx, cu, weight=cw)
        jstate = jstate.push_vals(cx, cu, weight=cw)
        lo += len(cu)
    _same_state(state, jstate)
    one = DataCentralMoments.from_vals(tt(xv), tt(uv), 3, weight=None if w is None else tt(w))
    _same_state(state, one)
    # merge of several states at once, and the pool of per-chunk states
    parts = [DataCentralMoments.from_vals(tt(cx), tt(cu), 3) for cu, cx in chunks]
    if not weighted:
        _same_state(parts[0].merge(*parts[1:]), one)


def test_merge_batched_x_is_u_and_xalpha_match_jax(rng):
    g = rng.normal(3.0, 1.0, (3, 2, 400))
    st = DataCentralMoments.zeros(3, batch_shape=(3, 2), x_is_u=True, **F64)
    jst = jx.DataCentralMoments.zeros(3, batch_shape=(3, 2), x_is_u=True, dtype=jnp.float64)
    for lo in (0, 150):
        hi = lo + 150 if lo == 0 else 400
        st = st.push_vals(None, g[..., lo:hi])
        jst = jst.push_vals(None, g[..., lo:hi])
    _same_state(st, jst)
    uv = rng.normal(5.0, 1.0, 300)
    xa = rng.normal(2.0, 0.5, (300, 4, 2))
    sa = DataCentralMoments.zeros(3, val_shape=(2,), xalpha=True, **F64)
    ja = jx.DataCentralMoments.zeros(3, val_shape=(2,), xalpha=True, dtype=jnp.float64)
    for lo, hi in ((0, 100), (100, 300)):
        sa = sa.push_vals(xa[lo:hi], uv[lo:hi])
        ja = ja.push_vals(xa[lo:hi], uv[lo:hi])
    _same_state(sa, ja)


# -- make_streaming_extrap_pipeline ----------------------------------------------------------


@pytest.mark.parametrize(
    "kws",
    [{}, {"minus_log": True}, {"nrep": 8, "seed": 5}],
    ids=["plain", "minus_log", "nrep"],
)
def test_streaming_extrap_chunked_equals_one_shot_and_jax(rng, kws):
    uv, xv, chunks = _chunks(rng)
    state, update, predict = tpipe.make_streaming_extrap_pipeline(3, 1.0, val_shape=(2,), **kws, **F64)
    jstate, jupdate, jpredict = jpipe.make_streaming_extrap_pipeline(3, 1.0, val_shape=(2,), dtype=jnp.float64, **kws)
    for c in chunks:
        state = update(state, *c)
        jstate = jupdate(jstate, *c)
    nrep = kws.get("nrep", 0)
    pred = predict(state, BETAS)[0] if nrep else predict(state, BETAS)
    jpred = jpredict(jstate, BETAS)[0] if nrep else jpredict(jstate, BETAS)
    one = tpipe.make_extrap_pipeline(3, 1.0, minus_log=kws.get("minus_log", False))(uv, xv, BETAS)
    assert pred.dtype == torch.float64 and pred.shape == (3, 2)
    assert_close(pred, one, 1e-10)
    assert_close(pred, np.asarray(jpred), 1e-10)
    _same_state(state[0] if nrep else state, jstate[0] if nrep else jstate)
    if nrep:
        assert state[2] == 4 and int(jstate[2]) == 4
        assert state[1].xave.shape == (8, 2) and state[1].wsum.shape == (8,)


def test_streaming_extrap_state_keeps_structure_and_dtype(rng):
    """Ten updates of float32 chunks leave a float64 state float64 (and a
    float32 state float32), with the same shapes."""
    uv, xv, _ = _chunks(rng, n=10, c=60)
    for dtype in (torch.float64, torch.float32):
        state0, update, predict = tpipe.make_streaming_extrap_pipeline(
            3, 1.0, val_shape=(2,), nrep=4, dtype=dtype, device="cpu"
        )
        state = state0
        for i in range(10):
            state = update(state, uv[i * 60 : (i + 1) * 60].astype(np.float32), xv[i * 60 : (i + 1) * 60].astype(np.float32))
        assert state[2] == 10
        for new, old in zip(state[:2], state0[:2]):
            for name in interop.FIELDS:
                a, b = getattr(new, name), getattr(old, name)
                assert a.dtype == dtype and a.shape == b.shape and a.device == b.device, name
        assert predict(state, BETAS)[0].dtype == torch.float64


def test_streaming_extrap_replicate_fold_is_the_one_shot_bootstrap(rng):
    """The per-chunk count tables, concatenated, give the streamed standard
    deviation through the one-shot bootstrap of the port and of JAX."""
    uv, xv, chunks = _chunks(rng)
    state, update, predict = tpipe.make_streaming_extrap_pipeline(3, 1.0, val_shape=(2,), nrep=16, seed=11, **F64)
    for c in chunks:
        state = update(state, *c)
    _, std = predict(state, BETAS)
    freq = torch.cat([tpipe._chunk_freq(11, step, 16, len(c[0]), "cpu") for step, c in enumerate(chunks)], dim=1)
    assert len({tpipe._chunk_seed(11, step) for step in range(1000)}) == 1000
    from thermoextrap_tpu_torch.models.derivatives import central_x_ave_coefs
    from thermoextrap_tpu_torch.models.extrap import _poly_eval

    bx, _bu, bdu, bdxdu = tresample.resample_central_comoments(tt(uv), tt(xv), freq, 3)
    bpred = _poly_eval(central_x_ave_coefs(bx, bdu[:, :, None], bdxdu, 3), tt(BETAS) - 1.0)
    assert_close(std, bpred.std(dim=1, correction=0), 1e-9)
    jb = jresample.resample_central_comoments(jnp.asarray(uv), jnp.asarray(xv), jnp.asarray(npy(freq)), 3)
    assert_close((bx, _bu, bdu, bdxdu), tuple(np.asarray(a) for a in jb), 1e-9, 1e-12)
    # the weight sums the replicates carry are the tables' row sums
    assert_close(state[1].wsum, freq.double().sum(dim=1), 1e-14)


def test_streaming_extrap_zero_weight_chunk_is_noop(rng):
    uv, xv, chunks = _chunks(rng, n=2)
    state, update, predict = tpipe.make_streaming_extrap_pipeline(3, 1.0, val_shape=(2,), nrep=16, seed=11, **F64)
    state = update(state, *chunks[0])
    before = predict(state, BETAS)
    after = predict(update(state, *chunks[1], weight=np.zeros(len(chunks[1][0]))), BETAS)
    assert_close(after, before, 1e-12)


def test_streaming_extrap_sigma_tracks_one_shot_and_jax(rng):
    uv, xv, chunks = _chunks(rng, n=4, c=500, v=1)
    state, update, predict = tpipe.make_streaming_extrap_pipeline(3, 1.0, val_shape=(1,), nrep=300, seed=2, **F64)
    jstate, jupdate, jpredict = jpipe.make_streaming_extrap_pipeline(3, 1.0, val_shape=(1,), dtype=jnp.float64, nrep=300, seed=2)
    for c in chunks:
        state = update(state, *c)
        jstate = jupdate(jstate, *c)
    _, std = predict(state, BETAS)
    _, one = tpipe.make_extrap_pipeline(3, 1.0, nrep=300)(uv, xv, BETAS, seed=2)
    for other in (npy(one), np.asarray(jpredict(jstate, BETAS)[1])):
        ratio = npy(std) / other
        assert np.all(ratio > 0.7) and np.all(ratio < 1.4), ratio


def test_streaming_extrap_xalpha_and_x_is_u(rng):
    uv = rng.normal(5.0, 1.0, 600)
    xa = rng.normal(2.0, 0.5, (600, 4, 2))
    w = rng.uniform(0.5, 1.5, 600)
    for minus_log in (False, True):
        state, update, predict = tpipe.make_streaming_extrap_pipeline(
            3, 1.0, xalpha=True, val_shape=(2,), minus_log=minus_log, nrep=6, **F64
        )
        jstate, jupdate, jpredict = jpipe.make_streaming_extrap_pipeline(
            3, 1.0, xalpha=True, val_shape=(2,), minus_log=minus_log, dtype=jnp.float64
        )
        for lo, hi in ((0, 200), (200, 600)):
            state = update(state, uv[lo:hi], np.abs(xa[lo:hi]))
            jstate = jupdate(jstate, uv[lo:hi], np.abs(xa[lo:hi]))
        pred, std = predict(state, BETAS)
        one = tpipe.make_extrap_pipeline(3, 1.0, xalpha=True, minus_log=minus_log)(uv, np.abs(xa), BETAS)
        assert_close(pred, one, 1e-10)
        assert_close(pred, np.asarray(jpredict(jstate, BETAS)), 1e-10)
        assert std.shape == (3, 2) and bool((std > 0).all())
    state, update, predict = tpipe.make_streaming_extrap_pipeline(3, 1.0, x_is_u=True, nrep=6, **F64)
    jstate, jupdate, jpredict = jpipe.make_streaming_extrap_pipeline(3, 1.0, x_is_u=True, dtype=jnp.float64)
    for lo, hi in ((0, 200), (200, 600)):
        state = update(state, uv[lo:hi], weight=w[lo:hi])
        jstate = jupdate(jstate, uv[lo:hi], weight=w[lo:hi])
    pred, std = predict(state, BETAS)
    one = tpipe.make_extrap_pipeline(3, 1.0, x_is_u=True, weighted=True)(uv, BETAS, w)
    assert_close(pred, one, 1e-10)
    assert_close(pred, np.asarray(jpredict(jstate, BETAS)), 1e-10)
    _same_state(state[0], jstate)
    assert bool((std > 0).all())
    with pytest.raises(ValueError, match="val_shape must be"):
        tpipe.make_streaming_extrap_pipeline(3, 1.0, x_is_u=True, val_shape=(2,))
    with pytest.raises(ValueError, match="mutually exclusive"):
        tpipe.make_streaming_extrap_pipeline(3, 1.0, x_is_u=True, xalpha=True)


def test_states_cross_between_the_packages(rng):
    """A JAX streaming state predicts in the port and a port state in JAX."""
    uv, xv, chunks = _chunks(rng)
    state, update, predict = tpipe.make_streaming_extrap_pipeline(3, 1.0, val_shape=(2,), nrep=8, **F64)
    jstate, jupdate, jpredict = jpipe.make_streaming_extrap_pipeline(3, 1.0, val_shape=(2,), dtype=jnp.float64, nrep=8)
    for c in chunks:
        state = update(state, *c)
        jstate = jupdate(jstate, *c)
    carried = interop.state_from_numpy(interop.state_to_numpy(jstate), device="cpu")
    assert isinstance(carried[0], DataCentralMoments) and carried[2] == 4
    assert_close(predict(carried, BETAS), tuple(np.asarray(a) for a in jpredict(jstate, BETAS)), 1e-10)
    # one more chunk folds into the carried state as into the port's own
    more = update(carried, *chunks[0])
    assert more[2] == 5 and float(more[0].wsum) == 1250.0
    back = interop.state_to_numpy(state)
    jback = (
        jreplace(jstate[0], **{k: jnp.asarray(back[0][k]) for k in interop.FIELDS}),
        jreplace(jstate[1], **{k: jnp.asarray(back[1][k]) for k in interop.FIELDS}),
        jnp.asarray(back[2], jnp.int32),
    )
    assert_close(tuple(np.asarray(a) for a in jpredict(jback, BETAS)), predict(state, BETAS), 1e-10)


# -- lnΠ, volume, jackknife ------------------------------------------------------------------


def test_streaming_lnpi_matches_one_shot_and_jax(rng):
    g = rng.normal(3.0, 1.0, (3, 2, 800)) + np.arange(3)[:, None, None]
    lnpi0 = rng.normal(size=(3, 2))
    mudotn = 0.7 * np.arange(6, dtype=float).reshape(3, 2)
    state, update, predict = tpipe.make_streaming_lnpi_pipeline(3, 1.0, grid_shape=(3, 2), nrep=12, seed=7, **F64)
    jstate, jupdate, jpredict = jpipe.make_streaming_lnpi_pipeline(3, 1.0, grid_shape=(3, 2), dtype=jnp.float64)
    bounds = ((0, 100), (100, 500), (500, 800))
    for lo, hi in bounds:
        state = update(state, g[..., lo:hi])
        jstate = jupdate(jstate, g[..., lo:hi])
    pred, std = predict(state, lnpi0, mudotn, BETAS)
    assert_close(pred, tpipe.make_lnpi_pipeline(3, 1.0)(g, lnpi0, mudotn, BETAS), 1e-10)
    assert_close(pred, np.asarray(jpredict(jstate, lnpi0, mudotn, BETAS)), 1e-10)
    _same_state(state[0], jstate)
    # the replicate fold on the concatenated per-chunk tables, counts shared by the grid
    freq = torch.cat([tpipe._chunk_freq(7, step, 12, hi - lo, "cpu") for step, (lo, hi) in enumerate(bounds)], dim=1)
    from thermoextrap_tpu_torch.models.derivatives import central_u_ave_coefs, lnpi_coefs
    from thermoextrap_tpu_torch.models.extrap import _poly_eval

    bu, bdu = tresample.resample_central_umoments_batched(tt(g), freq, 3)
    coefs = lnpi_coefs(central_u_ave_coefs(bu, bdu, 2), tt(lnpi0)[None], tt(mudotn)[None], 3)
    assert_close(std, _poly_eval(coefs, tt(BETAS) - 1.0).std(dim=1, correction=0), 1e-9)
    jb = jresample.resample_central_umoments_batched(jnp.asarray(g), jnp.asarray(npy(freq)), 3)
    assert_close((bu, bdu), tuple(np.asarray(a) for a in jb), 1e-9, 1e-12)
    assert_close(state[1].wsum, freq.double().sum(dim=1)[:, None, None].expand(12, 3, 2), 1e-14)
    with pytest.raises(ValueError, match="order must be >= 1"):
        tpipe.make_streaming_lnpi_pipeline(0, 1.0, grid_shape=(2,))


def _volume_data(rng, r=2000, v=None):
    wv = rng.normal(-3.0, 1.0, r)
    shape = (r,) if v is None else (r, v)
    xv = 1.0 + 0.2 * wv.reshape(r, *([1] * (len(shape) - 1))) + rng.normal(0, 0.3, shape)
    return wv, xv, 0.5 * xv + rng.normal(0, 0.1, shape)


@pytest.mark.parametrize("v", [None, 3])
def test_streaming_volume_matches_one_shot_and_jax(rng, v):
    wv, xv, dxdqv = _volume_data(rng, v=v)
    w = rng.uniform(0.5, 1.5, len(wv))
    vols = np.array([1.8, 2.0, 2.3])
    val_shape = () if v is None else (v,)
    state, update, predict = tpipe.make_streaming_volume_pipeline(2.0, ndim=3, val_shape=val_shape, nrep=10, **F64)
    jstate, jupdate, jpredict = jpipe.make_streaming_volume_pipeline(2.0, ndim=3, val_shape=val_shape, dtype=jnp.float64)
    for lo, hi in ((0, 300), (300, 2000)):
        state = update(state, wv[lo:hi], xv[lo:hi], dxdqv[lo:hi], weight=w[lo:hi])
        jstate = jupdate(jstate, wv[lo:hi], xv[lo:hi], dxdqv[lo:hi], weight=w[lo:hi])
    pred, std = predict(state, vols)
    one = tpipe.make_volume_pipeline(2.0, ndim=3, weighted=True)(wv, xv, dxdqv, vols, w)
    assert pred.shape == (3, *val_shape)
    assert_close(pred, one, 1e-10)
    assert_close(pred, np.asarray(jpredict(jstate, vols)), 1e-10)
    assert std.shape == pred.shape and bool((std > 0).all())
    with pytest.raises(ValueError, match="must match"):
        update(state, wv[:10], xv[:10], np.zeros((10, 7)))


def test_streaming_jackknife_matches_jax(rng):
    wv, xv, dxdqv = _volume_data(rng, r=4000)
    vols = np.array([1.8, 2.3])
    st0, upd, prd = tpipe.make_streaming_volume_pipeline(2.0, ndim=3, **F64)
    jst0, jupd, jprd = jpipe.make_streaming_volume_pipeline(2.0, ndim=3, dtype=jnp.float64)
    states = [upd(st0, wv[lo : lo + 500], xv[lo : lo + 500], dxdqv[lo : lo + 500]) for lo in range(0, 4000, 500)]
    jstates = [jupd(jst0, wv[lo : lo + 500], xv[lo : lo + 500], dxdqv[lo : lo + 500]) for lo in range(0, 4000, 500)]
    pred, se = tpipe.streaming_jackknife(states, prd, vols)
    jpred, jse = jpipe.streaming_jackknife(jstates, jprd, vols)
    assert_close(pred, prd(states[0].merge(*states[1:]), vols), 1e-13)
    assert_close((pred, se), (np.asarray(jpred), np.asarray(jse)), 1e-10)
    assert bool((se > 0).all())
    with pytest.raises(ValueError, match=">= 2 chunk states"):
        tpipe.streaming_jackknife(states[:1], prd, vols)
    # over extrapolation states too
    uv, xe, chunks = _chunks(rng, n=5, c=200, v=1)
    e0, eupd, eprd = tpipe.make_streaming_extrap_pipeline(3, 1.0, val_shape=(1,), **F64)
    j0, jeupd, jeprd = jpipe.make_streaming_extrap_pipeline(3, 1.0, val_shape=(1,), dtype=jnp.float64)
    got = tpipe.streaming_jackknife([eupd(e0, *c) for c in chunks], eprd, BETAS)
    ref = jpipe.streaming_jackknife([jeupd(j0, *c) for c in chunks], jeprd, BETAS)
    assert_close(got, tuple(np.asarray(a) for a in ref), 1e-10)


# -- make_streaming_perturb_pipeline (tests/test_streaming.py::TestStreamingPerturb) ---------


def _perturb_data(rng, r=3000):
    u = rng.normal(2.0, 0.6, r)
    return u, 1.5 + 0.3 * (u - 2.0) + rng.normal(0, 0.2, r)


def test_streaming_perturb_chunked_equals_one_shot_and_jax(rng):
    u, x = _perturb_data(rng)
    betas = np.array([0.7, 1.0, 1.4])  # a wide spread: the running maximum moves
    st, update, predict = tpipe.make_streaming_perturb_pipeline(1.0, betas, **F64)
    jst, jupdate, jpredict = jpipe.make_streaming_perturb_pipeline(1.0, betas, dtype=jnp.float64)
    for lo, hi in ((0, 700), (700, 701), (701, 2200), (2200, 3000)):
        st = update(st, u[lo:hi], x[lo:hi])
        jst = jupdate(jst, u[lo:hi], x[lo:hi])
    got = predict(st)
    assert_close(got, tpipe.make_perturb_pipeline(1.0)(u, x, betas), 1e-12)
    assert_close(got, np.asarray(jpredict(jst)), 1e-10)
    # the states agree leaf by leaf, and cross through interop
    for a, b in zip(interop.state_to_numpy(st), interop.state_to_numpy(jst)):
        np.testing.assert_allclose(a, b, rtol=1e-10)
    carried = interop.state_from_numpy(interop.state_to_numpy(jst), device="cpu")
    assert_close(predict(carried), got, 1e-10)
    whole, wupdate, wpredict = tpipe.make_streaming_perturb_pipeline(1.0, betas, **F64)
    assert_close(wpredict(wupdate(whole, u, x)), got, 1e-12)


def test_streaming_perturb_zero_weight_drops_exactly(rng):
    u, x = _perturb_data(rng, r=500)
    st, update, predict = tpipe.make_streaming_perturb_pipeline(1.0, np.array([1.1]), **F64)
    empty = update(st, u[:64], x[:64], weight=np.zeros(64))
    assert bool(torch.isinf(empty[0]).all()) and float(empty[2]) == 0.0
    assert bool(torch.isnan(predict(empty)).all())
    st = update(empty, u, x)
    base = predict(st)
    st = update(st, u[:64] + 100.0, x[:64], weight=np.zeros(64))
    assert torch.equal(predict(st), base)


def test_streaming_perturb_vector_values_and_ci(rng):
    u, _ = _perturb_data(rng, r=2000)
    x = 1.5 + 0.3 * (u[:, None] - 2.0) + rng.normal(0, 0.2, (2000, 3))
    betas = np.array([0.95, 1.1])
    st, update, predict = tpipe.make_streaming_perturb_pipeline(1.0, betas, val_shape=(3,), nrep=300, seed=4, **F64)
    jst, jupdate, jpredict = jpipe.make_streaming_perturb_pipeline(1.0, betas, val_shape=(3,), dtype=jnp.float64, nrep=300, seed=4)
    for lo, hi in ((0, 800), (800, 2000)):
        st = update(st, u[lo:hi], x[lo:hi])
        jst = jupdate(jst, u[lo:hi], x[lo:hi])
    pred, std = predict(st)
    jpred, jstd = jpredict(jst)
    assert pred.shape == (2, 3) and st[5] == 2 and st[3].shape == (2, 300, 3)
    assert_close(pred, np.asarray(jpred), 1e-10)
    _, std_1 = tpipe.make_perturb_pipeline(1.0, nrep=300)(u, x, betas, seed=9)
    for other in (np.asarray(jstd), npy(std_1)):
        ratio = npy(std) / other
        assert np.all(ratio > 0.7) and np.all(ratio < 1.4), ratio


def test_streaming_perturb_chunk_keying_advances(rng):
    u, x = _perturb_data(rng, r=300)
    st, update, _ = tpipe.make_streaming_perturb_pipeline(1.0, np.array([1.0]), nrep=16, **F64)
    st1 = update(st, u, x)
    st2 = update(st1, u, x)
    assert not torch.allclose(st1[3], st2[3] - st1[3])
    assert st2[5] == 2
    # the default state is float64 on the default device (the CPU in these tests)
    d0 = tpipe.make_streaming_perturb_pipeline(1.0, np.array([1.0]))[0]
    assert d0[1].dtype == torch.float64 and d0[1].device.type == "cpu"


# -- make_streaming_interp_pipeline (tests/test_streaming.py:507-562, :693-790) ----------------


def _two_sims(rng, r=1200):
    """Two "simulations": disjoint halves of one sample set, moved apart."""
    uv, xv, _ = _chunks(rng, n=1, c=r, v=1)
    return (uv[: r // 2], xv[: r // 2, 0]), (uv[r // 2 :] * 1.1, xv[r // 2 :, 0] + 0.2)


def test_streaming_interp_matches_one_shot_jackknife_and_jax(rng):
    """Interleaved chunks of two states give InterpModel over the one-shot
    states (rtol 1e-8, the JAX test's bar: the merge order differs), the JAX
    pipeline on the same chunks, and compose with the jackknife over one
    state's chunks."""
    (ua, xa), (ub, xb) = _two_sims(rng)
    beta0s = [0.8, 1.3]
    states, update, predict = tpipe.make_streaming_interp_pipeline(4, beta0s, **F64)
    jstates, jupdate, jpredict = jpipe.make_streaming_interp_pipeline(4, beta0s, dtype=jnp.float64)
    for i, (u, x) in ((0, (ua[:350], xa[:350])), (1, (ub[:200], xb[:200])), (0, (ua[350:], xa[350:])), (1, (ub[200:], xb[200:]))):
        states = update(states, i, u, x)
        jstates = jupdate(jstates, i, u, x)
    betas = np.array([0.8, 1.0, 1.25])
    got = predict(states, betas)
    assert got.dtype == torch.float64 and got.shape == (3,)
    one = tx.InterpModel(
        [tbeta.factory_extrapmodel(b, DataCentralMoments.from_vals(tt(x), tt(u), 4)) for b, (u, x) in zip(beta0s, [(ua, xa), (ub, xb)])]
    )
    assert_close(got, one.predict(betas), 1e-8)
    assert_close(got, np.asarray(jpredict(jstates, betas)), 1e-8)
    for s, js in zip(states, jstates):
        _same_state(s, js)

    zero = DataCentralMoments.zeros(4, **F64)
    chunks0 = [zero.push_vals(xa[:350], ua[:350]), zero.push_vals(xa[350:], ua[350:])]
    s1 = states[1]
    jk_pred, jk_se = tpipe.streaming_jackknife(chunks0, lambda s0, b: predict((s0, s1), b), betas)
    assert_close(jk_pred, got, 1e-12)
    assert jk_se.shape == jk_pred.shape and bool((jk_se >= 0).all()) and bool(torch.isfinite(jk_se).all())
    jz = jx.DataCentralMoments.zeros(4, dtype=jnp.float64)
    jchunks0 = [jz.push_vals(xa[:350], ua[:350]), jz.push_vals(xa[350:], ua[350:])]
    js1 = jstates[1]
    jjk = jpipe.streaming_jackknife(jchunks0, lambda s0, b: jpredict((s0, js1), b), betas)
    # the standard error is a spread of leave-one-out predictions of size ~2,
    # so its error across the two solves is absolute: 1e-8 of the predictions
    assert_close((jk_pred, jk_se), tuple(np.asarray(a) for a in jjk), 1e-8, 2e-8)

    with pytest.raises(ValueError, match=">= 2 reference states"):
        tpipe.make_streaming_interp_pipeline(4, [1.0])


def test_streaming_interp_minus_log_matches_interp_model(rng):
    (ua, xa), (ub, xb) = _two_sims(rng)
    xa, xb = xa + 3.0, xb + 3.0  # -log <x> needs <x> > 0
    states, update, predict = tpipe.make_streaming_interp_pipeline(3, (0.8, 1.3), minus_log=True, **F64)
    states = update(update(states, 0, ua, xa), 1, ub, xb)
    one = tx.InterpModel(
        [
            tbeta.factory_extrapmodel(b, DataCentralMoments.from_vals(tt(x), tt(u), 3), minus_log=True)
            for b, (u, x) in zip((0.8, 1.3), [(ua, xa), (ub, xb)])
        ]
    )
    assert_close(predict(states, BETAS), one.predict(BETAS), 1e-10)


class TestStreamingInterpBootstrap:
    """With ``nrep``: per-state replicate accumulators solved jointly.  The
    oracle is the one-shot bootstrap over the port's own per-state,
    per-chunk count tables (``_chunk_freq(seed_i, step, ...)``), through the
    port's and the JAX package's reduction and InterpModel, at rtol 1e-9."""

    ORDER, NREP, SEED = 2, 12, 5
    BETA0S = (0.7, 1.3)

    def test_streamed_ci_equals_oneshot_same_freq(self):
        rng = np.random.default_rng(42)
        n, c, v = 2, 300, 2
        data = [(rng.normal(5.0 / b, 1.0, n * c), rng.normal(b, 0.3, (n * c, v))) for b in self.BETA0S]
        states, update, predict = tpipe.make_streaming_interp_pipeline(
            self.ORDER, self.BETA0S, val_shape=(v,), nrep=self.NREP, seed=self.SEED, **F64
        )
        for i, (uv, xv) in enumerate(data):
            for k in range(n):
                states = update(states, i, uv[k * c : (k + 1) * c], xv[k * c : (k + 1) * c])
        assert all(s[2] == n for s in states)
        betas = np.array([0.8, 1.0, 1.2])
        pred, std = predict(states, betas)

        derivs = tbeta.factory_derivatives("x_ave", central=True)
        jderivs = jbeta.factory_derivatives("x_ave", central=True)
        rep_models, jrep_models = [], []
        for i, (b, (uv, xv)) in enumerate(zip(self.BETA0S, data)):
            seed_i = int((self.SEED + 0x9E3779B9 * (i + 1)) & 0x7FFFFFFF)
            assert seed_i == tpipe._state_seed(self.SEED, i)
            freq = torch.cat([tpipe._chunk_freq(seed_i, s, self.NREP, c, "cpu") for s in range(n)], dim=1)
            boot = tresample.resample_central_comoments(tt(uv), tt(xv), freq, self.ORDER)
            rep = DataCentralMoments.from_ave_central(*boot, wsum=freq.sum(dim=1).double())
            rep_models.append(tx.ExtrapModel(b, rep, derivs, order=self.ORDER, alpha_name="beta"))
            jboot = jresample.resample_central_comoments(uv, xv, jnp.asarray(npy(freq)), self.ORDER)
            jrep = jx.DataCentralMoments.from_ave_central(*jboot, wsum=npy(freq).sum(axis=1).astype(np.float64))
            jrep_models.append(jx.ExtrapModel(b, jrep, jderivs, order=self.ORDER, alpha_name="beta"))
        want = tx.InterpModel(rep_models).predict(betas).std(dim=1, correction=0)
        assert_close(std, want, 1e-9)
        assert_close(std, np.asarray(jx.InterpModel(jrep_models).predict(betas)).std(axis=1), 1e-9)

        s0, up0, pr0 = tpipe.make_streaming_interp_pipeline(self.ORDER, self.BETA0S, val_shape=(v,), **F64)
        for i, (uv, xv) in enumerate(data):
            for k in range(n):
                s0 = up0(s0, i, uv[k * c : (k + 1) * c], xv[k * c : (k + 1) * c])
        assert_close(pred, pr0(s0, betas), 1e-12)
        assert bool((std > 0).all())

    def test_state_seeds_differ(self):
        """Identical data in both states must not give identical replicates:
        each state draws from its own seed."""
        rng = np.random.default_rng(2)
        uv = rng.normal(5.0, 1.0, 400)
        xv = rng.normal(2.0, 0.5, (400, 1))
        states, update, _ = tpipe.make_streaming_interp_pipeline(
            self.ORDER, self.BETA0S, val_shape=(1,), nrep=self.NREP, seed=self.SEED, **F64
        )
        states = update(update(states, 0, uv, xv), 1, uv, xv)
        assert not torch.allclose(states[0][1].xave, states[1][1].xave)
        assert torch.equal(states[0][0].xave, states[1][0].xave)
