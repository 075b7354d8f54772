"""The port's moment containers against the JAX package where the two once
differed: the weight sums of ``DataCentralMoments.from_resample_vals`` on
bfloat16 streams (the reference promotes ``bf16 counts @ float32 weights`` to
float32), and ``DataCentralMoments.resample``, the block bootstrap, which is
one merge over a leading replicate axis as the reference's vmapped merge is.

Tolerances: float64 block bootstraps at rtol 1e-10 (both packages run the
same exact merge, in another order of operations); float32 weight sums at
rtol 1e-6; the bfloat16 weight sums of an unweighted call exactly.
"""

import numpy as np
import pytest
import torch
from _torch_parity import assert_close, npy, tt

import thermoextrap_tpu as jx
import thermoextrap_tpu_torch as tx
from thermoextrap_tpu_torch import data as tdata

ORDER = 4
NREP, NBLOCK = 6, 8
RTOL, ATOL = 1e-10, 1e-13


def _fields(d):
    return (d.xave, d.uave, d.du, d.dxdu, d.wsum)


@pytest.fixture
def vals():
    rng = np.random.default_rng(17)
    u = rng.normal(2.0, 0.7, 400)
    x = np.stack([u * 0.3 + rng.normal(0.0, 0.2, 400), rng.normal(1.0, 0.5, 400)], axis=1)
    return u, x


def _freq(seed, nblock=NBLOCK):
    return np.random.default_rng(seed).integers(0, 3, (NREP, nblock))


@pytest.mark.parametrize("weighted", [False, True])
def test_from_resample_vals_bf16_weight_sums_match_jax(weighted):
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    r = 4001
    u = rng.normal(5.0, 1.0, r).astype(np.float32)
    x = rng.normal(2.0, 0.5, (r, 1)).astype(np.float32)
    weight = rng.uniform(0.5, 1.5, r).astype(np.float32) if weighted else None
    freq = rng.integers(0, 3, (3, r)).astype(np.int32)
    jd = jx.DataCentralMoments.from_resample_vals(
        jnp.asarray(x, dtype=jnp.bfloat16), jnp.asarray(u, dtype=jnp.bfloat16), 2, {"freq": freq}, weight=weight
    )
    td = tx.DataCentralMoments.from_resample_vals(
        tt(x).to(torch.bfloat16), tt(u).to(torch.bfloat16), 2, {"freq": tt(freq)}, weight=None if weight is None else tt(weight)
    )
    if weighted:
        assert jd.wsum.dtype == jnp.float32 and td.wsum.dtype == torch.float32
        assert_close(td.wsum, jd.wsum, 1e-6)
        # exact float32 sums, not the bfloat16 ones the port once gave
        assert_close(td.wsum, freq.astype(np.float64) @ weight.astype(np.float64), 1e-6)
    else:
        assert jd.wsum.dtype == jnp.bfloat16 and td.wsum.dtype == torch.bfloat16
        np.testing.assert_array_equal(npy(td.wsum), np.asarray(jd.wsum, dtype=np.float64))


def test_block_resample_weighted_matches_jax(vals):
    u, x = vals
    w = np.random.default_rng(11).uniform(0.5, 2.0, len(u))
    blk = len(u) // NBLOCK
    u_b, x_b, w_b = u.reshape(NBLOCK, blk), x.reshape(NBLOCK, blk, -1), w.reshape(NBLOCK, blk)
    freq = _freq(9)
    jr = jx.DataCentralMoments.from_vals(x_b, u_b, ORDER, weight=w_b).resample({"freq": freq})
    tr = tx.DataCentralMoments.from_vals(tt(x_b), tt(u_b), ORDER, weight=tt(w_b)).resample({"freq": tt(freq)})
    assert tr.wsum.shape == (NREP,)
    assert_close(_fields(tr), _fields(jr), RTOL, ATOL)


def test_block_resample_axis_with_kept_batch_matches_jax(vals):
    u, x = vals
    u_b = u.reshape(2, 4, -1)
    x_b = x.reshape(2, 4, -1, x.shape[1])
    freq = _freq(13, nblock=4)
    jr = jx.DataCentralMoments.from_vals(x_b, u_b, ORDER).resample({"freq": freq}, axis=1)
    tr = tx.DataCentralMoments.from_vals(tt(x_b), tt(u_b), ORDER).resample({"freq": tt(freq)}, axis=1)
    assert tr.wsum.shape == (NREP, 2)
    assert_close(_fields(tr), _fields(jr), RTOL, ATOL)


def test_block_resample_xalpha_matches_jax(vals):
    u, _ = vals
    rng = np.random.default_rng(5)
    blk = len(u) // NBLOCK
    xa = rng.normal(1.0, 0.5, (len(u), ORDER + 1, 2))
    u_b = u.reshape(NBLOCK, blk)
    x_b = xa.reshape(NBLOCK, blk, ORDER + 1, 2)
    freq = _freq(17)
    jr = jx.DataCentralMoments.from_vals(x_b, u_b, ORDER, xalpha=True).resample({"freq": freq})
    tr = tx.DataCentralMoments.from_vals(tt(x_b), tt(u_b), ORDER, xalpha=True).resample({"freq": tt(freq)})
    assert tr.xave.shape == (ORDER + 1, NREP, 2)
    assert tr.dxdu.shape == (ORDER + 1, ORDER + 1, NREP, 2)
    assert_close(_fields(tr), _fields(jr), RTOL, ATOL)


def test_block_resample_is_one_merge(vals, monkeypatch):
    """The replicates go through one batched merge, not one merge each."""
    u, x = vals
    d = tx.DataCentralMoments.from_vals(tt(x.reshape(NBLOCK, -1, 2)), tt(u.reshape(NBLOCK, -1)), ORDER)
    calls = []
    merge = tdata.merge_central_comoments

    def counted(*args, **kws):
        calls.append(args[-1].shape)
        return merge(*args, **kws)

    monkeypatch.setattr(tdata, "merge_central_comoments", counted)
    r = d.resample({"freq": tt(_freq(21))})
    assert calls == [(NREP, NBLOCK)]
    assert r.wsum.shape == (NREP,)


# -- tests/test_data.py:111-346: weights, the pooled reduce, the block bootstrap --------------


def test_weighted_reduction_equals_repeats():
    """Integer weights equal literally repeated samples."""
    rng = np.random.default_rng(2)
    u = rng.normal(size=10)
    x = rng.normal(size=(10, 1))
    w = rng.integers(1, 4, size=10)
    d_w = tx.DataValuesCentral.from_vals(tt(x), tt(u), ORDER, weight=tt(w.astype(float)))
    d_r = tx.DataValuesCentral.from_vals(tt(np.repeat(x, w, axis=0)), tt(np.repeat(u, w)), ORDER)
    assert_close(d_w.derivs_args, d_r.derivs_args, RTOL, 1e-12)
    jd = jx.DataValuesCentral.from_vals(x, u, ORDER, weight=w.astype(float))
    assert_close(d_w.derivs_args, jd.derivs_args, RTOL, ATOL)


def test_tree_round_trip_of_values(vals):
    """A values container flattens to its tensors and rebuilds with its
    static fields (tests/test_data.py::test_pytree_roundtrip)."""
    from thermoextrap_tpu_torch.utils import trees

    u, x = vals
    d = tx.DataValues.from_vals(tt(x), tt(u), ORDER, central=False)
    leaves, treedef = trees.tree_flatten(d)
    assert len(leaves) == 2  # uv and xv; the absent weight is an empty subtree
    d2 = trees.tree_unflatten(treedef, leaves)
    assert d2.order == d.order and d2.weight is None and type(d2) is tx.DataValues
    assert torch.equal(d2.uv, d.uv)


def test_reduce_merges_blocks_matches_one_shot_and_jax(vals):
    """Pooling per-block moments equals reducing the concatenation."""
    u, x = vals
    nblock, blk = 4, len(u) // 4
    u_b, x_b = u.reshape(nblock, blk), x.reshape(nblock, blk, -1)
    pooled = tx.DataCentralMoments.from_vals(tt(x_b), tt(u_b), ORDER).reduce(axis=0)
    d_all = tx.DataCentralMoments.from_vals(tt(x), tt(u), ORDER)
    assert_close(_fields(pooled)[:2], _fields(d_all)[:2], 1e-12)
    assert_close(_fields(pooled)[2:4], _fields(d_all)[2:4], RTOL, 1e-14)
    assert float(pooled.wsum) == len(u)
    jpooled = jx.DataCentralMoments.from_vals(x_b, u_b, ORDER).reduce(axis=0)
    assert_close(_fields(pooled), _fields(jpooled), RTOL, ATOL)


def _block_freq(seed, nblock=NBLOCK):
    """A multinomial block count table, as test_data.py draws one."""
    idx = np.random.default_rng(seed).integers(0, nblock, (NREP, nblock))
    return np.stack([np.bincount(r, minlength=nblock) for r in idx])


def _assert_block_equal(r_mom, r_val):
    assert_close((r_mom.xave, r_mom.uave), (r_val.xave, r_val.uave), RTOL, ATOL)
    assert_close((r_mom.du, r_mom.dxdu), (r_val._du_norm, r_val.dxdu), 1e-9, ATOL)
    assert_close(r_mom.wsum, r_val.wsum, 1e-12)


@pytest.mark.parametrize("case", ["plain", "weighted", "x_is_u"])
def test_block_resample_matches_values_bootstrap_and_jax(vals, case):
    """A block bootstrap of per-block moments equals the values bootstrap
    whose counts repeat each block's count over its samples."""
    u, x = vals
    blk = len(u) // NBLOCK
    w = np.random.default_rng(11).uniform(0.5, 2.0, len(u)) if case == "weighted" else None
    xs = None if case == "x_is_u" else x
    freq = _block_freq({"plain": 7, "weighted": 9, "x_is_u": 3}[case])
    x_b = None if xs is None else tt(xs.reshape(NBLOCK, blk, -1))
    w_b = None if w is None else tt(w.reshape(NBLOCK, blk))
    r_mom = tx.DataCentralMoments.from_vals(x_b, tt(u.reshape(NBLOCK, blk)), ORDER, weight=w_b).resample({"freq": tt(freq)})
    assert r_mom.wsum.shape == (NREP,)
    r_val = tx.DataCentralMoments.from_resample_vals(
        None if xs is None else tt(xs),
        tt(u),
        ORDER,
        {"freq": tt(np.repeat(freq, blk, axis=1))},
        weight=None if w is None else tt(w),
        x_is_u=xs is None,
    )
    _assert_block_equal(r_mom, r_val)
    jr = jx.DataCentralMoments.from_vals(
        None if xs is None else xs.reshape(NBLOCK, blk, -1),
        u.reshape(NBLOCK, blk),
        ORDER,
        weight=None if w is None else w.reshape(NBLOCK, blk),
    ).resample({"freq": freq})
    assert_close(_fields(r_mom), _fields(jr), RTOL, ATOL)


def test_block_resample_axis_rows_equal_flat_resamples(vals):
    """With blocks on axis 1, every kept row equals its own flat resample."""
    u, _ = vals
    u_b = u.reshape(2, 4, -1)
    x_b = u_b[..., None] * 0.5 + 1.0
    freq = tt(_block_freq(13, nblock=4))
    r = tx.DataCentralMoments.from_vals(tt(x_b), tt(u_b), ORDER).resample({"freq": freq}, axis=1)
    assert r.wsum.shape == (NREP, 2)
    for g in range(2):
        r_g = tx.DataCentralMoments.from_vals(tt(x_b[g]), tt(u_b[g]), ORDER).resample({"freq": freq})
        assert_close(r.dxdu[:, :, g], r_g.dxdu, 1e-12)
        assert_close(r.wsum[:, g], r_g.wsum, 1e-12)


def test_block_resample_guards(vals):
    u, x = vals
    with pytest.raises(ValueError, match="block batch axis"):
        tx.DataCentralMoments.from_vals(tt(x), tt(u), ORDER).resample({"nrep": 4})


def test_block_resample_xalpha_against_weighted_reductions(vals):
    """xalpha blocks pool and bootstrap exactly: each replicate equals the
    independent weighted one-shot reduction with the block counts as
    sample weights."""
    u, x = vals
    rng = np.random.default_rng(5)
    blk = len(u) // NBLOCK
    xa = rng.normal(1.0, 0.5, (len(u), ORDER + 1, x.shape[1]))
    d_blocks = tx.DataCentralMoments.from_vals(tt(xa.reshape(NBLOCK, blk, ORDER + 1, -1)), tt(u.reshape(NBLOCK, blk)), ORDER, xalpha=True)
    d_all = tx.DataCentralMoments.from_vals(tt(xa), tt(u), ORDER, xalpha=True)
    pooled = d_blocks.reduce(axis=0)
    assert_close(pooled.xave, d_all.xave, RTOL)
    assert_close((pooled.dxdu, pooled._du_norm), (d_all.dxdu, d_all._du_norm), 1e-9, ATOL)
    freq = _block_freq(17)
    r_mom = d_blocks.resample({"freq": tt(freq)})
    for rep in range(NREP):
        w_vals = np.repeat(freq[rep].astype(np.float64), blk)
        if w_vals.sum() == 0:
            continue
        d_r = tx.DataCentralMoments.from_vals(tt(xa), tt(u), ORDER, xalpha=True, weight=tt(w_vals))
        assert_close(r_mom.xave[:, rep], d_r.xave, 1e-9, ATOL)
        assert_close(r_mom.dxdu[:, :, rep], d_r.dxdu, 1e-8, 1e-12)
        assert_close(r_mom.wsum[rep], d_r.wsum, 1e-12)


# -- tests/test_data.py:362-438: from_data, cmom, rmom -------------------------------------


def _cmomy_layout(d_ref, n, v):
    data = np.zeros((v, 2, ORDER + 1))
    data[:, 0, 0] = n
    data[:, 1, 0] = npy(d_ref.xave)
    data[:, 0, 1] = float(d_ref.uave)
    for j in range(2, ORDER + 1):
        data[:, 0, j] = npy(d_ref.du).reshape(ORDER + 1, -1)[j, 0]
    for j in range(1, ORDER + 1):
        data[:, 1, j] = npy(d_ref.dxdu)[j]
    return data


def test_from_data_matches_from_vals_and_jax(vals):
    u, x = vals
    d_ref = tx.DataCentralMoments.from_vals(tt(x), tt(u), ORDER)
    data = _cmomy_layout(d_ref, len(u), x.shape[1])
    d = tx.DataCentralMoments.from_data(data, val_ndim=1, central=True)
    assert_close(d.derivs_args, d_ref.derivs_args, 1e-7, 1e-12)
    assert_close(d.xu, d_ref.xu, 1e-6)
    assert int(d.wsum) == len(u) and d.dxdu.dtype == torch.float64 and d.order == ORDER
    jd = jx.DataCentralMoments.from_data(data, val_ndim=1, central=True)
    assert_close(_fields(d), _fields(jd), RTOL, ATOL)
    # a tensor keeps its device; the raises of the reference
    assert tx.DataCentralMoments.from_data(tt(data), val_ndim=1).xave.device.type == "cpu"
    with pytest.raises(NotImplementedError, match="deriv axis"):
        tx.DataCentralMoments.from_data(data, xalpha=True)
    with pytest.raises(ValueError, match="trailing"):
        tx.DataCentralMoments.from_data(np.zeros((2, 3, 5)))
    with pytest.raises(ValueError, match=">= 2 moment entries"):
        tx.DataCentralMoments.from_data(np.zeros(1), x_is_u=True)


def test_from_data_x_is_u_and_doctest(vals):
    """The x_is_u layout is the reference's moments_to_comoments shift; the
    docstring example is a case."""
    import doctest

    u, _ = vals
    d_ref = tx.DataCentralMoments.from_vals(None, tt(u), ORDER, x_is_u=True)
    data = np.zeros(ORDER + 2)
    data[0] = len(u)
    data[1] = float(d_ref.uave)
    du_full = npy(tx.DataValues.from_vals(None, tt(u), ORDER + 1, x_is_u=True, central=True).du)
    data[2:] = du_full[2 : ORDER + 2]
    d = tx.DataCentralMoments.from_data(data, x_is_u=True, central=True)
    assert d.order == ORDER
    assert_close(d.derivs_args, d_ref.derivs_args, 1e-7, 1e-12)
    assert_close(_fields(d), _fields(jx.DataCentralMoments.from_data(data, x_is_u=True, central=True)), RTOL, ATOL)
    runner = doctest.DocTestRunner(optionflags=doctest.NORMALIZE_WHITESPACE)
    for test in doctest.DocTestFinder().find(tx.DataCentralMoments.from_data, "from_data", globs={"DataCentralMoments": tx.DataCentralMoments}):
        runner.run(test)
    assert runner.tries >= 3 and runner.failures == 0


def test_cmom_rmom_round_trip_and_jax(vals):
    u, x = vals
    d = tx.DataCentralMoments.from_vals(tt(x), tt(u), ORDER)
    jd = jx.DataCentralMoments.from_vals(x, u, ORDER)
    t = d.cmom()
    assert t.shape == (x.shape[1], 2, ORDER + 1)
    assert_close(t, jd.cmom(), RTOL, ATOL)
    back = tx.DataCentralMoments.from_data(t, val_ndim=1, central=True)
    assert_close(back.derivs_args, d.derivs_args, 1e-12)
    assert float(back.wsum) == float(d.wsum)
    r = npy(d.rmom())
    assert_close(r, jd.rmom(), RTOL, ATOL)
    np.testing.assert_allclose(r[..., 0, 0], float(d.wsum))
    np.testing.assert_allclose(np.moveaxis(r[..., 1, :], -1, 0), npy(d.xu), rtol=1e-12)
    np.testing.assert_allclose(r[0, 0, 1:], npy(d.u).reshape(ORDER + 1, -1)[1:, 0], rtol=1e-12)


def test_cmom_rmom_round_trip_x_is_u_and_raises(vals):
    u, x = vals
    d = tx.DataCentralMoments.from_vals(None, tt(u), ORDER)
    jd = jx.DataCentralMoments.from_vals(None, u, ORDER)
    vec = d.cmom()
    assert vec.shape == (ORDER + 2,)
    assert_close(vec, jd.cmom(), RTOL, ATOL)
    back = tx.DataCentralMoments.from_data(vec, x_is_u=True, central=True)
    assert back.order == ORDER
    assert_close(back.derivs_args, d.derivs_args, 1e-12)
    r = npy(d.rmom())
    assert_close(r, jd.rmom(), RTOL, ATOL)
    np.testing.assert_allclose(r[0], float(d.wsum))
    np.testing.assert_allclose(r[1:], npy(d.u)[1:], rtol=1e-12)
    xa = tx.DataCentralMoments.from_vals(tt(np.stack([x] * (ORDER + 1), axis=1)), tt(u), ORDER, xalpha=True)
    for method in (xa.cmom, xa.rmom):
        with pytest.raises(NotImplementedError, match="deriv axis"):
            method()


# -- DataCentralMoments.save / load (tests/test_streaming.py:444-505) --------------------------


def test_save_load_resumes_exactly_and_crosses_packages(vals, tmp_path):
    """A mid-stream checkpoint restores the state exactly; the file is the
    JAX package's layout, read by either package."""
    u, x = vals
    acc = tx.DataCentralMoments.zeros(ORDER, val_shape=(2,), device="cpu").push_vals(tt(x[:250]), tt(u[:250]))
    path = tmp_path / "stream_state.npz"
    acc.save(path)
    resumed = tx.DataCentralMoments.load(path)
    assert resumed.order == ORDER and resumed.val_ndim == 1 and resumed.du.dtype == acc.du.dtype
    unbroken = acc.push_vals(tt(x[250:]), tt(u[250:]))
    for a, b in zip(_fields(unbroken), _fields(resumed.push_vals(tt(x[250:]), tt(u[250:])))):
        assert torch.equal(a, b)
    jr = jx.DataCentralMoments.load(path)
    assert_close(_fields(jr), _fields(acc), 0.0)
    jpath = tmp_path / "jax_state.npz"
    jx.DataCentralMoments.from_vals(x, u, ORDER).save(jpath)
    assert_close(_fields(tx.DataCentralMoments.load(jpath)), _fields(jx.DataCentralMoments.load(jpath)), 0.0)


def test_save_load_bf16_batched_and_suffixless(vals, tmp_path):
    u, x = vals
    d = tx.DataCentralMoments.from_vals(tt(x[:, 0]), tt(u), ORDER)
    b = tx.DataCentralMoments(
        **{k: getattr(d, k).to(torch.bfloat16) for k in ("xave", "uave", "du", "dxdu", "wsum")},
        meta=d.meta, order=d.order, central=d.central, x_is_u=d.x_is_u, xalpha=d.xalpha, val_ndim=d.val_ndim,
    )
    b.save(tmp_path / "bf16.npz")
    rb = tx.DataCentralMoments.load(tmp_path / "bf16.npz")
    assert rb.dxdu.dtype == torch.bfloat16 and torch.equal(rb.dxdu, b.dxdu)
    g = tx.DataCentralMoments.from_vals(None, tt(u.reshape(4, -1)), ORDER)
    g.save(tmp_path / "grid")  # no suffix: written as grid.npz, read back by the bare path
    assert (tmp_path / "grid.npz").exists()
    rg = tx.DataCentralMoments.load(tmp_path / "grid")
    assert rg.wsum.device.type == "cpu"  # the default device
    assert rg.x_is_u and rg.wsum.shape == (4,)
    assert_close(rg.derivs_args, g.derivs_args, 0.0)
