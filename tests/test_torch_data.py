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
