"""The finalize step of the K2 / K3 wrapper (chunk partials -> exact central
comoments) of the torch port, on the CPU.

- ``finalize_comoments_plain`` on seeded numpy partials equals the
  composition it replaced (float64 partial sum, ``_shifted_epilogue``, cast)
  bit for bit;
- fed the JAX package's own shifted raw moments
  (``thermoextrap_tpu.ops.resample.resample_raw_comoments`` about the global
  mean) it gives ``resample_central_comoments``' outputs at rtol 1e-12 in
  float64: both run the same exact binomial recentring on the same numbers,
  so only the order of a few additions differs;
- an all-zero replicate takes the finite convention (means = the shift,
  central moments 0, weight 0);
- the launch shapes of the shared contraction kernel (K5, K7, K8), of
  K2 / K3 and of their few-rows tensor-core kernel, for any size in range,
  against the Python mirror of the checks the kernel entries make.
"""

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from _torch_parity import assert_close, npy, tt

from thermoextrap_tpu.ops import resample as jr
from thermoextrap_tpu_torch.ops import moments_cuda as mc

RTOL64 = 1e-12
ATOL64 = 1e-13


@pytest.fixture
def rng():
    return np.random.default_rng(23)


def _partials(rng, nchunk, nrep, v, order):
    """Chunk partials as K2 writes them: column 0 the (positive) weight."""
    part = rng.normal(0.0, 1.0, (nchunk, nrep, (v + 1) * (order + 1)))
    part[:, :, 0] = rng.uniform(0.5, 1.5, (nchunk, nrep))
    return part


@pytest.mark.parametrize(("nchunk", "nrep", "v", "order"), [(1, 3, 1, 6), (37, 5, 2, 6), (4, 7, 17, 3), (9, 2, 1, 15)])
def test_finalize_plain_equals_the_composition_it_replaced(rng, nchunk, nrep, v, order):
    part = tt(_partials(rng, nchunk, nrep, v, order), torch.float32)
    s_u = tt(rng.normal(size=1), torch.float32)
    s_x = tt(rng.normal(size=v), torch.float32)
    sums = part.double().sum(0)
    sum_u = sums[:, : order + 1].T
    sum_x = sums[:, order + 1 :].reshape(nrep, v, order + 1).permute(2, 0, 1)
    ref = mc._shifted_epilogue(sum_u, sum_x, s_u.double().expand(nrep), s_x.double().expand(nrep, -1))
    got = mc.finalize_comoments_plain(part, s_u, s_x, order, v)
    assert [g.shape for g in got] == [(nrep, v), (nrep,), (order + 1, nrep), (order + 1, nrep, v), (nrep,)]
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        assert torch.equal(g, r.to(torch.float32))
    got64 = mc.finalize_comoments_plain(part.double(), s_u, s_x, order, v)
    assert all(g.dtype == torch.float64 and torch.equal(g, r) for g, r in zip(got64, ref))


@pytest.mark.parametrize(("v", "weighted", "nchunk"), [(1, False, 1), (2, True, 3), (3, True, 8)])
def test_finalize_plain_on_jax_shifted_sums_gives_jax_central_comoments(rng, v, weighted, nchunk):
    r, nrep, order = 900, 6, 6
    u = rng.normal(5.0, 1.0, r)
    x = 2.0 + 0.3 * (u[:, None] - 5.0) + rng.normal(0.0, 0.5, (r, v))
    w = rng.uniform(0.5, 1.5, r) if weighted else None
    freq = rng.poisson(1.0, (nrep, r)).astype(np.int32)
    ref = jr.resample_central_comoments(u, x, freq, order, weight=w)
    # the reference's shifted raw moments about its shift, the global mean
    wf = np.ones(r) if w is None else w
    ubar = (wf * u).sum() / wf.sum()
    xbar = (wf[:, None] * x).sum(0) / wf.sum()
    u_s, xu_s = jr.resample_raw_comoments(u - ubar, x - xbar[None], freq, order, weight=w)
    rows = np.concatenate([npy(u_s).T[:, None, :], np.moveaxis(npy(xu_s), 0, 2)], axis=1)  # (nrep, v+1, order+1)
    # spread over chunks whose shares sum to 1
    share = rng.dirichlet(np.ones(nchunk))
    part = share[:, None, None] * rows.reshape(nrep, -1)[None]
    got = mc.finalize_comoments_plain(tt(part), tt([ubar]), tt(xbar), order, v)
    assert all(g.dtype == torch.float64 for g in got)
    assert_close(got[:4], ref, RTOL64, ATOL64)
    assert_close(got[4], np.ones(nrep), RTOL64)


def test_finalize_plain_zero_weight_replicate(rng):
    nchunk, nrep, v, order = 5, 4, 2, 6
    part = _partials(rng, nchunk, nrep, v, order)
    part[:, 2] = 0.0
    s_u, s_x = tt([0.7]), tt([-0.2, 3.0])
    xave, uave, du, dxdu, wsum = mc.finalize_comoments_plain(tt(part), s_u, s_x, order, v)
    assert all(bool(torch.isfinite(t).all()) for t in (xave, uave, du, dxdu, wsum))
    assert torch.equal(xave[2], s_x) and float(uave[2]) == 0.7 and float(wsum[2]) == 0.0
    assert torch.equal(du[:, 2], tt([1.0] + [0.0] * order))
    assert torch.equal(dxdu[:, 2], torch.zeros(order + 1, v, dtype=torch.float64))
    # the other replicates are untouched by their neighbour
    rest = [0, 1, 3]
    alone = mc.finalize_comoments_plain(tt(part[:, rest]), s_u, s_x, order, v)
    assert torch.equal(du[:, rest], alone[2]) and torch.equal(xave[rest], alone[0])


def test_k2_k3_cpu_paths_equal_finalize_of_their_sums(rng):
    """The wrappers' CPU results are the finalize step applied to the plain
    shifted sums: the same epilogue serves the kernel path and the CPU path."""
    r, nrep, order = 700, 5, 4
    u = rng.normal(5.0, 1.0, r)
    x = rng.normal(2.0, 0.5, (r, 2))
    freq = rng.poisson(1.0, (nrep, r))
    uu, xx, _, s_u, s_x = mc._plain_streams(tt(u), tt(x), None)
    sum_u, sum_x = mc._resample_sums_plain(uu, xx, None, tt(freq), s_u, s_x, order)
    part = torch.cat([sum_u.T[:, None, :], sum_x.permute(1, 2, 0)], dim=1).reshape(1, nrep, -1)
    got = mc.finalize_comoments_plain(part, s_u[None], s_x, order, 2)
    ref = mc.resample_central_comoments_fused(tt(u), tt(x), tt(freq), order)
    assert_close(got[:4], ref, 1e-14, 1e-15)


# -- the launch shapes the wrappers hand the kernels --------------------------------


@settings(max_examples=400, deadline=None)
@given(
    m=st.integers(1, 6000),
    nrep=st.integers(1, 5000),
    r=st.one_of(st.integers(1, 3000), st.integers(1, 10**9)),
    target=st.sampled_from([mc._TARGET_BLOCKS, mc._PERTURB_TARGET_BLOCKS]),
)
def test_rows_launch_shape_is_one_the_kernel_takes(m, nrep, r, target):
    """Whatever (rows, replicates, samples) K5 / K7 / K8 are given, the launch
    shape passes the kernel entries' own check (its Python mirror), fits the
    232,448 bytes of shared memory a block can have, cuts the samples into
    whole tiles of the kernel the row count selects and leaves no chunk empty."""
    nr, npt, nchunk, chunk = mc._rows_launch(m, nrep, r, target)
    assert mc._rows_shape_ok(m, r, nrep, nchunk, chunk, nr, npt)
    assert mc._rows_smem(m, nr, npt) <= 232_448
    tile = mc._FEW_TILE if m <= mc._URS_CB else mc._URS_TILE
    assert chunk % tile == 0
    assert (nchunk - 1) * chunk < r <= nchunk * chunk
    # every row has a thread slot in a row tile, and up to 16 rows need one row-thread
    assert (nr == 1) == (m <= mc._URS_CB)
    assert 1 <= mc._URS_THREADS // (nr * npt) <= 32  # sample lanes: a warp at most


@pytest.mark.parametrize(
    ("m", "nrep", "r", "shape"),
    [
        (10, 128, 10_000_000, (1, 32, 256)),  # the perturbation call: few rows, 128 replicates a block
        (8, 256, 100_000_000, (1, 32, 256)),  # <u>: one row at order 7
        (448, 256, 1_000_000, (32, 8, 32)),  # 448 rows on the CUDA cores (K5 takes the tensor cores)
        (513, 37, 100_003, (32, 8, 32)),  # two row tiles
        (17, 5, 90, (2, 4, 32)),
        (1, 1, 1, (1, 8, 256)),
    ],
)
def test_rows_launch_shapes_of_the_serving_calls(m, nrep, r, shape):
    nr, npt, nchunk, chunk = mc._rows_launch(m, nrep, r, mc._TARGET_BLOCKS)
    assert (nr, npt) == shape[:2] and chunk % shape[2] == 0


def test_rows_shape_check_rejects_what_the_kernel_cannot_run():
    ok = dict(m=10, r=1000, nrep=128, nchunk=4, chunk=256, nr=1, npt=32)
    assert mc._rows_shape_ok(**ok)
    many = dict(m=448, r=1000, nrep=256, nchunk=32, chunk=32, nr=32, npt=8)
    assert mc._rows_shape_ok(**many)
    for base, bad in (
        (ok, {"chunk": 288}),  # not whole 256-sample tiles
        (ok, {"nchunk": 3}),  # does not cover the samples
        (ok, {"nr": 2, "npt": 16}),  # few rows take one row-thread
        (ok, {"npt": 4}),  # more than 32 sample lanes
        (ok, {"npt": 24}),  # not a power of two
        (ok, {"m": 0}),
        (many, {"chunk": 48, "nchunk": 21}),  # not whole 32-sample tiles
        (many, {"nr": 16, "npt": 32}),  # more than 256 threads
        (many, {"nrep": 32 * 65536}),  # more replicate blocks than grid.y takes
    ):
        assert not mc._rows_shape_ok(**{**base, **bad}), bad


@settings(max_examples=200, deadline=None)
@given(r=st.integers(1, 10**9), nrep=st.integers(1, 5000), m=st.integers(2, 700))
def test_k2_chunks_are_whole_tiles(r, nrep, m):
    """K2 / K3 on the CUDA cores (fractional tables, more than 16 rows) take
    the shared contraction's launch shape: whole tiles of the kernel that the
    row count selects, covering the samples."""
    nr, npt, nchunk, chunk = mc._rows_launch(m, nrep, r, mc._TARGET_BLOCKS)
    tile = mc._FEW_TILE if m <= mc._URS_CB else mc._URS_TILE
    assert chunk % tile == 0 and (nchunk - 1) * chunk < r <= nchunk * chunk
    assert mc._rows_shape_ok(m, r, nrep, nchunk, chunk, nr, npt)


def test_bf16_three_term_split_carries_float32():
    """The rows of K5's tensor-core kernel as three bf16 terms (split_bf16x3,
    the plain version of tx_split_bf16x3): b0 + b1 + b2 gives every float32
    value to 2^-24 relative over exponents -90 .. 90, the terms shrink by
    2^8 each, and small integers (the counts) are exact in b0 alone."""
    gen = torch.Generator().manual_seed(11)
    v = torch.randn(200_000, generator=gen) * torch.exp2(torch.randint(-90, 91, (200_000,), generator=gen).float())
    v = v[v != 0]
    b0, b1, b2 = mc.split_bf16x3(v)
    assert all(b.dtype == torch.bfloat16 for b in (b0, b1, b2))
    total = b0.double() + b1.double() + b2.double()
    assert float(((total - v.double()).abs() / v.double().abs()).max()) <= 2.0**-24
    big = b1 != 0
    assert bool((b1[big].double().abs() <= b0[big].double().abs() * 2.0**-8).all())
    counts = torch.arange(0, 257, dtype=torch.float32)
    c0, c1, c2 = mc.split_bf16x3(counts)
    assert torch.equal(c0.float(), counts) and not bool(c1.any()) and not bool(c2.any())


@settings(max_examples=200, deadline=None)
@given(nbatch=st.integers(1, 300), order=st.integers(1, 15), nrep=st.integers(1, 5000), r=st.integers(1, 10**9))
def test_mma_launch_covers_the_samples_in_whole_tiles(nbatch, order, nrep, r):
    """K5 past 16 rows takes the tensor-core kernel's launch shape: chunks of
    whole 32-sample tiles that cover the samples, none empty, about the
    target number of blocks of 128 replicates x 224 rows."""
    m = nbatch * (order + 1)
    nchunk, chunk = mc._mma_launch(m, nrep, r, mc._TARGET_BLOCKS // 4)
    assert chunk % mc._MMA_S == 0 and (nchunk - 1) * chunk < r <= nchunk * chunk
    blocks = nchunk * math.ceil(nrep / mc._MMA_REPS) * math.ceil(m / mc._MMA_ROWS)
    assert blocks < 2**31
    assert mc._k5_on_tensor_cores(m, order) == (m > mc._URS_CB)
    assert not mc._k5_on_tensor_cores(40, 0)  # order 0 stays on the CUDA cores


@settings(max_examples=200, deadline=None)
@given(v=st.integers(1, 15), order=st.integers(0, 15), nrep=st.integers(1, 5000), r=st.integers(1, 10**9))
def test_fewmma_launch_covers_the_samples_in_whole_tiles(v, order, nrep, r):
    """K2 / K3 up to 16 rows with integer counts take the few-rows
    tensor-core kernel's launch shape: chunks of whole 128-sample tiles that
    cover the samples, none empty, a shape the entry's check accepts; the
    fractional and bf16 tables and more rows keep the CUDA cores' shape."""
    m = (v + 1) * (order + 1)
    for kind in mc._COUNT_KIND.values():
        assert mc._k23_on_tensor_cores(m, kind) == (m <= mc._URS_CB and kind in (0, 1, 2))
    if not mc._k23_on_tensor_cores(m, mc._POISSON_KIND):
        return
    nchunk, chunk = mc._fewmma_launch(m, nrep, r, mc._TARGET_BLOCKS // 2)
    assert chunk % mc._FMMA_S == 0 and (nchunk - 1) * chunk < r <= nchunk * chunk
    assert mc._fewmma_shape_ok(m, r, nrep, nchunk, chunk)
    ycount = math.ceil(nrep / mc._FMMA_REPS)
    assert nchunk * ycount < mc._TARGET_BLOCKS // 2 + ycount  # about the target number of blocks


def test_fewmma_launch_writes_no_more_partials_at_the_main_shape():
    """At the main path's shape (14 rows, 256 replicates, R = 1e8) the
    tensor-core route writes no more chunk partials than the CUDA cores' few-
    rows launch did, and its shape check rejects what the kernel cannot run."""
    m, nrep, r = 14, 256, 10**8
    nchunk, chunk = mc._fewmma_launch(m, nrep, r, mc._TARGET_BLOCKS // 2)
    _, _, rows_nchunk, _ = mc._rows_launch(m, nrep, r, mc._TARGET_BLOCKS)
    assert nchunk * nrep * m <= rows_nchunk * nrep * m and nchunk == 528
    ok = dict(m=m, r=r, nrep=nrep, nchunk=nchunk, chunk=chunk)
    assert mc._fewmma_shape_ok(**ok)
    for bad in ({"m": 17}, {"m": 0}, {"chunk": chunk + 32}, {"nchunk": nchunk - 1}, {"nrep": 0}):
        assert not mc._fewmma_shape_ok(**{**ok, **bad}), bad
