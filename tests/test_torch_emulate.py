"""The CUDA kernels of the torch port run on the CPU: their sources compiled
by the host's g++ against a stand-in for the CUDA runtime
(``thermoextrap_tpu_torch.emulate``) and driven through the same wrappers that
launch them on a card.  This holds each kernel's indexing, masking and
pipelining to its plain torch version where there is no GPU:

- the few-rows and the many-rows kernel of ``csrc/resample_tile.cuh`` behind
  K7 / K8 and K5, on shapes that end inside a tile, a replicate block and a row
  tile, for every count-table type, an unaligned table, and chunks of several
  tiles (so that the double buffer and the loads that run ahead are used);
- K8 equal to K7 on its own count table bit for bit, K5's draws equal to its
  table consume bit for bit, K8's weight sums at e = 1 equal to K3's;
- K2 / K3 through the head-shift kernel, the shared contraction (the
  main path's 14 rows and the volume path's 6 in the few-rows tensor-core
  kernel for the draw and integer tables, fractional tables in the few-rows
  kernel, 21 rows in the many-rows kernel, float32 and bfloat16 streams) and
  the finalize kernel; K3 equal to K2 on its own count table bit for bit,
  narrow tables equal to int32 ones, counts past one bf16 digit and below 0;
  the finalize kernel alone against its plain version (exact after the
  float32 cast), the zero-weight replicate included;
- the in-kernel draw: its counts equal to their plain reproduction bit for
  bit, and its word -> count map (the level lookup of csrc/philox.cuh) equal
  to the 9-compare sum at every threshold +-2, at every level's first and last
  word and at 2^16 random words;
- K1 / K6 through the batched head shift, the 16-byte reduction kernel and the
  finalize kernel with a shift row per batch row: R no multiple of 4 or 8, an
  unaligned view, V = 1, 2, 5, bfloat16, weights and a zero-weight head,
  against the plain version and against the JAX package; the head shift and
  the strided finalize alone;
- K4 through the head shift with no value stream, the same reduction kernel
  with no value column and the u-moment finalize kernel: R no multiple of 4
  or 8, unaligned views (rows of mixed alignment; u and w of different
  alignment), bfloat16, weights and a zero-weight head, one row and several,
  orders 5, 6, 7 (8 unguarded power slots) and 9 (every slot guarded),
  against the plain version and against the JAX package; the
  head shift with no value stream alone;
- K5 past 16 rows on the tensor cores (28 and 448 rows), draws equal to the
  table consume bit for bit, counts past one bf16 digit, against the plain
  version and the JAX table bootstrap; its finalize kernel; the mma.sync
  stand-in of the emulator against a float64 matmul.

Tolerances: float32 kernels against float64 plain versions at the bars of
tests/test_torch_cuda.py (rtol 2e-3 / atol 1e-5 for the moment kernels,
rtol 2e-5 / atol 1e-5 for the perturbation sums).
"""

import numpy as np
import pytest
import torch
from _torch_parity import assert_close, tt

from thermoextrap_tpu_torch import emulate
from thermoextrap_tpu_torch.ops import moments_cuda as mc
from thermoextrap_tpu_torch.ops.resample import POISSON1_THRESHOLDS

RTOL32, ATOL32 = 2e-3, 1e-5
RTOL_P, ATOL_P = 2e-5, 1e-5


@pytest.fixture(scope="module")
def kernels():
    if not emulate.available():
        pytest.skip("needs g++ to compile the kernels for the CPU")
    with emulate.emulated() as lib:
        yield lib


@pytest.fixture
def rng():
    return np.random.default_rng(29)


@pytest.fixture
def few_blocks(monkeypatch):
    """Cut the samples into few chunks, so that a chunk holds several tiles."""
    monkeypatch.setattr(mc, "_TARGET_BLOCKS", 2)
    monkeypatch.setattr(mc, "_PERTURB_TARGET_BLOCKS", 2)


def _f32(a):
    return tt(a, torch.float32)


def _perturb_inputs(rng, r, v, na):
    e = _f32(rng.uniform(0.1, 1.0, (na, r)))
    e[:, rng.uniform(size=r) < 0.1] = 0.0
    return e, _f32(rng.normal(2.0, 0.5, (r, v)))


@pytest.mark.parametrize(
    ("r", "v", "na", "nrep", "dtype"),
    [
        (1, 1, 1, 1, torch.int8),  # the fewest rows a call can have (2)
        (255, 1, 5, 16, torch.int8),  # a tile less one sample; 10 rows
        (257, 1, 5, 129, torch.int16),  # a tile plus one; two replicate blocks
        (300, 2, 2, 9, torch.int32),
        (130, 3, 4, 40, torch.float32),  # 16 rows: every slot of the few-rows kernel
        (90, 1, 9, 5, torch.bfloat16),  # 18 rows: the many-rows kernel
        (70, 2, 171, 3, torch.int8),  # 513 rows: two row tiles
    ],
)
def test_k7_emulated_matches_plain(kernels, rng, r, v, na, nrep, dtype):
    e, x = _perturb_inputs(rng, r, v, na)
    freq = tt(rng.poisson(1.0, (nrep, r))).to(dtype)
    if dtype == torch.float32:
        freq = freq * 0.5 + 0.25
    got = mc._resample_perturb_cuda(e, x, nrep, freq=freq)
    assert got.shape == (na, nrep, v + 1) and got.dtype == torch.float32
    assert_close(got, mc.resample_perturb_plain(e.double(), x.double(), freq.double()), RTOL_P, ATOL_P)
    shifted = torch.empty(freq.numel() + 1, dtype=dtype)[1:].view(freq.shape)
    shifted.copy_(freq)
    assert shifted.data_ptr() % (4 * shifted.element_size()) != 0
    assert torch.equal(mc._resample_perturb_cuda(e, x, nrep, freq=shifted), got)


@pytest.mark.parametrize(("r", "v", "na", "nrep"), [(1500, 1, 5, 16), (1030, 2, 3, 70), (200, 2, 171, 9)])
def test_k8_emulated_equals_k7_on_its_table(kernels, rng, few_blocks, r, v, na, nrep):
    e, x = _perturb_inputs(rng, r, v, na)
    k8 = mc._resample_perturb_cuda(e, x, nrep, seed=11)
    counts = mc.poisson_counts_cuda(11, nrep, r, torch.device("cpu"))
    assert torch.equal(counts, mc._poisson_counts(11, nrep, r))
    assert torch.equal(k8, mc._resample_perturb_cuda(e, x, nrep, freq=counts))
    assert torch.equal(k8, mc._resample_perturb_cuda(e, x, nrep, freq=counts.to(torch.int8)))
    assert_close(k8, mc.resample_perturb_poisson_plain(e.double(), x.double(), nrep, seed=11), RTOL_P, ATOL_P)
    assert not torch.equal(k8, mc._resample_perturb_cuda(e, x, nrep, seed=12))


@pytest.mark.parametrize(
    ("nbatch", "r", "order", "nrep", "weighted", "dtype"),
    [
        (1, 1, 1, 1, False, torch.float32),
        (1, 1300, 7, 40, False, torch.float32),  # the <u> path's shape: few rows, several tiles a chunk
        (2, 700, 6, 130, True, torch.bfloat16),  # 14 rows, two replicate blocks
        (6, 333, 6, 129, False, torch.float32),  # 42 rows: many-rows kernel
        (74, 50, 6, 3, True, torch.float32),  # 518 rows: two row tiles
    ],
)
def test_k5_emulated_draws_equal_table_consume_and_match_plain(kernels, rng, few_blocks, nbatch, r, order, nrep, weighted, dtype):
    u = _f32(rng.normal(5.0, 1.0, (nbatch, r))).to(dtype)
    w = _f32(rng.uniform(0.5, 1.5, (nbatch, r))) if weighted else None
    table = mc._poisson_counts(9, nrep, r)
    k5 = mc._resample_u_cuda(u, w, nrep, order, seed=9)
    consume = mc._resample_u_cuda(u, w, nrep, order, freq=table)
    assert all(torch.equal(a, b) for a, b in zip(k5, consume))
    ref = mc.resample_umoments_plain(u.double(), None if w is None else w.double(), table, order)
    assert_close(k5, ref, RTOL32, 2e-5 if dtype == torch.bfloat16 else ATOL32)


def test_k8_and_k5_emulated_weight_sums_equal_k3(kernels, rng):
    r, nrep = 900, 12
    u, x = _f32(rng.normal(5.0, 1.0, r)), _f32(rng.normal(2.0, 0.5, (r, 1)))
    k3 = mc._resample_cuda(u, x, None, 3, nrep, seed=5)
    wsum8 = mc._resample_perturb_cuda(torch.ones(1, r), x, nrep, seed=5)[0, :, -1]
    wsum5 = mc._resample_u_cuda(u[None], None, nrep, 3, seed=5)[2][:, 0]
    assert torch.equal(wsum8, k3[4]) and torch.equal(wsum5, k3[4])


@pytest.mark.parametrize(("r", "v", "order", "weighted", "dtype"), [(700, 2, 4, True, torch.int32), (1025, 1, 6, False, torch.int8), (100, 17, 2, True, torch.float32)])
def test_k2_k3_emulated_three_launches_match_plain(kernels, rng, r, v, order, weighted, dtype):
    u, x = _f32(rng.normal(5.0, 1.0, r)), _f32(rng.normal(2.0, 0.5, (r, v)))
    w = _f32(rng.uniform(0.5, 1.5, r)) if weighted else None
    table = tt(rng.poisson(1.0, (6, r))).to(dtype)
    table[2] = 0  # a replicate of zero weight
    mc.reset_launches()
    out = mc._resample_cuda(u, x, w, order, 6, freq=table)
    assert mc.LAUNCHES["head_shift"] == 1 and mc.LAUNCHES["finalize"] == 1
    ref = mc.resample_comoments_plain(u.double(), x.double(), table.double(), order, None if w is None else w.double())
    assert all(bool(torch.isfinite(t).all()) for t in out)
    assert_close(out, ref, RTOL32, ATOL32)
    k3 = mc._resample_cuda(u, x, w, order, 6, seed=3)
    k2 = mc._resample_cuda(u, x, w, order, 6, freq=mc._poisson_counts(3, 6, r))
    assert all(torch.equal(a, b) for a, b in zip(k3, k2))


@pytest.mark.parametrize(
    ("r", "v", "order", "nrep", "weighted", "dtype", "table"),
    [
        (1299, 1, 6, 40, False, torch.float32, "draws"),  # the main path's 14 rows, several tiles a chunk
        (1299, 1, 6, 40, True, torch.bfloat16, "draws"),
        (1030, 2, 1, 9, True, torch.float32, "draws"),  # the volume path's 6 rows
        (1030, 2, 1, 9, False, torch.bfloat16, "draws"),
        (301, 5, 1, 9, True, torch.float32, "draws"),  # 12 rows of 6 columns: more row items than threads
        (333, 2, 6, 9, True, torch.float32, "draws"),  # 21 rows: the many-rows kernel
        (333, 2, 6, 9, False, torch.bfloat16, "draws"),
        (517, 1, 6, 37, True, torch.float32, "int16"),  # counts past one digit, and below 0
        (517, 1, 6, 37, False, torch.bfloat16, "float32"),  # fractional counts: the CUDA cores
    ],
)
def test_k2_k3_emulated_on_the_shared_contraction(kernels, rng, few_blocks, r, v, order, nrep, weighted, dtype, table):
    """K2 / K3 up to 16 rows with integer counts run on the few-rows
    tensor-core kernel (``LAUNCHES["comoment_mma"]``), fractional tables and
    21 rows on the CUDA cores: K3 equal to K2 on its own table and to an int8
    table bit for bit, tables past one bf16 digit (int16 and int32, equal to
    each other) and fractional tables against the float64 plain version."""
    u = _f32(rng.normal(5.0, 1.0, r)).to(dtype)
    x = _f32(rng.normal(2.0, 0.5, (r, v))).to(dtype)
    w = _f32(rng.uniform(0.5, 1.5, r)) if weighted else None
    wd = None if w is None else w.double()
    atol = 2e-5 if dtype == torch.bfloat16 else ATOL32
    seed = 0x7FFF00001234ABCD  # high key bits set
    counts = mc._poisson_counts(seed, nrep, r)
    mma = (v + 1) * (order + 1) <= mc._URS_CB and table != "float32"
    mc.reset_launches()
    if table == "draws":
        k3 = mc._resample_cuda(u, x, w, order, nrep, seed=seed)
        k2 = mc._resample_cuda(u, x, w, order, nrep, freq=counts)
        assert all(torch.equal(a, b) for a, b in zip(k3, k2))
        narrow = mc._resample_cuda(u, x, w, order, nrep, freq=counts.to(torch.int8))
        assert all(torch.equal(a, b) for a, b in zip(narrow, k2))
        assert mc.LAUNCHES["comoment_mma"] == (3 if mma else 0)
        ref = mc.resample_poisson_plain(u.double(), x.double(), nrep, order, wd, seed=seed)
        assert_close(k3, ref, RTOL32, atol)
        return
    if table == "int16":
        freq = counts.clone()
        freq[0] += 300
        freq[1] *= 201
        freq[2, 5] = -1
        freq[3, 7] = -700
        got = mc._resample_cuda(u, x, w, order, nrep, freq=freq.to(torch.int16))
        assert all(torch.equal(a, b) for a, b in zip(got, mc._resample_cuda(u, x, w, order, nrep, freq=freq)))
        assert mc.LAUNCHES["comoment_mma"] == 2
    else:
        freq = counts.float() + _f32(rng.uniform(0.0, 0.5, (nrep, r)))
        got = mc._resample_cuda(u, x, w, order, nrep, freq=freq)
        assert mc.LAUNCHES["comoment_mma"] == 0
    ref = mc.resample_comoments_plain(u.double(), x.double(), freq.double(), order, wd)
    assert_close(got, ref, RTOL32, atol)


@pytest.mark.parametrize(("seed", "r"), [(0, 1003), (11 | (7 << 40), 257), (2**63 + 5, 1), (-1, 4099)])
def test_poisson_counts_emulated_equal_plain(kernels, seed, r):
    got = mc.poisson_counts_cuda(seed, 5, r, torch.device("cpu"))
    assert torch.equal(got, mc._poisson_counts(seed, 5, r))


def test_poisson_map_emulated_equals_compare_sum(kernels, rng):
    t = torch.tensor(POISSON1_THRESHOLDS, dtype=torch.int64)
    near = (t[:, None] + torch.arange(-2, 3)).reshape(-1)
    firsts = torch.tensor([2**32 - 2 ** (32 - lv) for lv in range(33)])
    lasts = torch.tensor([2**32 - 2 ** (32 - lv) + 2 ** (31 - lv) - 1 for lv in range(32)])
    rand = torch.as_tensor(rng.integers(0, 2**32, 2**16), dtype=torch.int64)
    words = torch.cat([near, firsts, lasts, rand])
    got, stats = mc.poisson_map_cuda(words)
    ref = (words[:, None] > t[None]).sum(1).to(torch.int32)
    assert torch.equal(got, ref)
    assert stats.tolist() == [words.numel(), 0, int(ref.sum())]
    # a range of words that wraps past 2^32 - 1
    _, stats = mc.poisson_map_cuda(start=2**32 - 300, n=600, device=torch.device("cpu"))
    wrapped = torch.arange(2**32 - 300, 2**32 + 300) % 2**32
    assert stats.tolist() == [600, 0, int((wrapped[:, None] > t[None]).sum())]


@pytest.mark.parametrize(("v", "order", "nchunk"), [(1, 6, 196), (2, 6, 37), (40, 3, 3), (3, 15, 1), (1, 1, 5)])
def test_finalize_and_head_shift_emulated_match_plain(kernels, rng, v, order, nchunk):
    nrep = 5
    part = _f32(rng.uniform(-0.3, 0.7, (nchunk, nrep, (v + 1) * (order + 1))))
    part[:, :, 0] = part[:, :, 0].abs() + 0.5
    part[:, 2] = 0.0
    shift = _f32(rng.uniform(size=v + 1))
    got = mc.finalize_comoments_cuda(part, shift, order, v)
    ref = mc.finalize_comoments_plain(part, shift[:1], shift[1:], order, v)
    assert all(a.dtype == torch.float32 and a.shape == b.shape for a, b in zip(got, ref))
    assert_close(got, ref, 1e-6, 1e-30)
    assert torch.equal(got[2][:, 2], ref[2][:, 2]) and torch.equal(got[0][2], shift[1:]) and float(got[4][2]) == 0.0
    u, x, w = _f32(rng.normal(5.0, 1.0, 9000)), _f32(rng.normal(2.0, 0.5, (9000, v))), _f32(rng.uniform(0.5, 1.5, 9000))
    s_u, s_x = mc._head_shift(u[None], w[None], x[None])
    assert_close(mc.head_shift_cuda(u, x, w), torch.cat([s_u, s_x[0]]), 1e-6)
    w[: mc.HEAD_N] = 0.0
    assert torch.equal(mc.head_shift_cuda(u, x, w), torch.zeros(v + 1))


# -- K1 / K6: the 16-byte reduction between the batched head shift and the strided finalize --


@pytest.mark.parametrize(
    ("nbatch", "r", "v", "weighted", "dtype", "offset"),
    [
        (1, 4099, 1, False, torch.float32, 0),  # R no multiple of 4: a scalar tail
        (2, 3001, 2, True, torch.float32, 1),  # an unaligned view: scalar heads, rows of mixed alignment
        (3, 1003, 5, True, torch.float32, 0),  # V past the register tile: tiles of 4 columns
        (1, 2051, 1, False, torch.bfloat16, 3),  # bf16: 8 samples a load, unaligned, ragged
        (2, 9001, 2, True, torch.bfloat16, 0),  # batch row 1 has a zero-weight head
    ],
)
def test_k1_k6_emulated_three_launches_match_plain(kernels, rng, nbatch, r, v, weighted, dtype, offset):
    # a zero-weight head gives shift 0, so that row's mean is kept near 0:
    # float32 power sums about a shift far from the mean (u ~ 5, order 6)
    # lose the digits the bar asks for, in any float32 reduction
    mean = 0.3 if weighted and nbatch > 1 else 5.0
    u = _f32(rng.normal(mean, 1.0, nbatch * r + offset))[offset:].view(nbatch, r).to(dtype)
    x = _f32(rng.normal(2.0, 0.5, nbatch * r * v + offset))[offset:].view(nbatch, r, v).to(dtype)
    w = _f32(rng.uniform(0.5, 1.5, (nbatch, r))) if weighted else None
    if weighted and nbatch > 1:
        w[1, : mc.HEAD_N] = 0.0
    mc.reset_launches()
    out = mc._reduce_cuda(u, x, w, 6)
    assert {k: c for k, c in mc.LAUNCHES.items() if c} == {"head_shift": 1, "finalize": 1}
    assert [tuple(t.shape) for t in out] == [(nbatch, v), (nbatch,), (7, nbatch), (7, nbatch, v), (nbatch,)]
    ref = mc.reduce_comoments_plain(u.double(), x.double(), None if w is None else w.double(), 6)
    assert all(t.dtype == torch.float32 for t in out)
    assert_close(out, ref, RTOL32, 2e-5 if dtype == torch.bfloat16 else ATOL32)


@pytest.mark.parametrize(("r", "v", "weighted"), [(5003, 1, False), (2001, 3, True)])
def test_k1_emulated_matches_jax(kernels, rng, r, v, weighted):
    """The K1 kernel on the CPU against the JAX package's float64 reduction,
    at the float32 bar."""
    from thermoextrap_tpu.ops import moments as jm

    u, x = rng.normal(5.0, 1.0, r), rng.normal(2.0, 0.5, (r, v))
    w = rng.uniform(0.5, 1.5, r) if weighted else None
    u32, x32 = _f32(u), _f32(x)
    w32 = None if w is None else _f32(w)
    xave, uave, du, dxdu, _ = mc._reduce_cuda(u32[None], x32[None], None if w is None else w32[None], 6)
    ref = jm.reduce_central_comoments(np.asarray(u32.double()), np.asarray(x32.double()), 6, weight=None if w is None else np.asarray(w32.double()))
    assert_close((xave[0], uave[0], du[:, 0], dxdu[:, 0]), ref, RTOL32, ATOL32)


def test_batched_head_shift_and_strided_finalize_emulated(kernels, rng):
    """The head shift of each batch row against _head_shift (a zero-weight
    head gives 0); the finalize kernel with a shift row per batch row against
    its plain version and _shifted_epilogue; one shared shift (stride 0, K2 /
    K3) gives the bits of the same shift repeated on every row."""
    nbatch, r, v, order, nchunk = 3, 9000, 2, 6, 7
    u = _f32(rng.normal(5.0, 1.0, (nbatch, r)))
    x = _f32(rng.normal(2.0, 0.5, (nbatch, r, v)))
    w = _f32(rng.uniform(0.5, 1.5, (nbatch, r)))
    w[2, : mc.HEAD_N] = 0.0
    shift = mc.head_shift_cuda(u, x, w)
    s_u, s_x = mc._head_shift(u, w, x)
    assert shift.shape == (nbatch, v + 1)
    assert_close(shift, torch.cat([s_u[:, None], s_x], 1), 1e-6)
    assert torch.equal(shift[2], torch.zeros(v + 1))
    part = _f32(rng.uniform(-0.3, 0.7, (nchunk, nbatch, (v + 1) * (order + 1))))
    part[:, :, 0] = part[:, :, 0].abs() + 0.5
    part[:, 1] = 0.0  # a row of zero weight
    got = mc.finalize_comoments_cuda(part, shift, order, v)
    ref = mc.finalize_comoments_plain(part, shift[:, 0], shift[:, 1:], order, v)
    assert_close(got, ref, 1e-6, 1e-30)
    sums = part.double().sum(0)
    composed = mc._shifted_epilogue(
        sums[:, : order + 1].T, sums[:, order + 1 :].reshape(nbatch, v, order + 1).permute(2, 0, 1), shift[:, 0].double(), shift[:, 1:].double()
    )
    assert_close(got, composed, 1e-6, 1e-30)
    one = shift[0].clone()
    shared = mc.finalize_comoments_cuda(part, one, order, v)
    rows = mc.finalize_comoments_cuda(part, one.expand(nbatch, v + 1).contiguous(), order, v)
    assert all(torch.equal(a, b) for a, b in zip(shared, rows))


# -- K4: the u-only case of the same reduction, between the head shift and the u finalize -----


def _refuse(*args, **kwargs):
    raise AssertionError("a plain version was called on the kernel path")


@pytest.mark.parametrize(
    ("nbatch", "r", "order", "weighted", "dtype", "offset"),
    [
        (1, 4099, 7, False, torch.float32, 0),  # the x_is_u route's one row at order 7; a scalar tail
        (3, 3001, 6, False, torch.float32, 1),  # an unaligned view: scalar heads, rows of mixed alignment
        (2, 3001, 6, True, torch.float32, 1),  # u and w of different alignment: scalar loads
        (2, 2051, 7, False, torch.bfloat16, 3),  # bf16: 8 samples a load, unaligned, ragged
        (3, 9001, 6, True, torch.bfloat16, 0),  # batch row 1 has a zero-weight head
        (4, 8200, 6, True, torch.float32, 0),  # aligned rows, weighted, several blocks a row
        (2, 4103, 9, True, torch.float32, 0),  # past order 7: the kernel with every power slot guarded
    ],
)
def test_k4_emulated_three_launches_match_plain(kernels, rng, monkeypatch, nbatch, r, order, weighted, dtype, offset):
    # a zero-weight head gives shift 0, so that row's mean is kept near 0 (as
    # in the K1 / K6 cases: float32 sums about a far shift lose digits)
    mean = 0.3 if weighted and dtype == torch.bfloat16 else 5.0
    u = _f32(rng.normal(mean, 1.0, nbatch * r + offset))[offset:].view(nbatch, r).to(dtype)
    w = _f32(rng.uniform(0.5, 1.5, (nbatch, r))) if weighted else None
    if weighted and dtype == torch.bfloat16:
        w[1, : mc.HEAD_N] = 0.0
    mc.reset_launches()
    with monkeypatch.context() as m:
        for name in ("_head_shift", "_u_epilogue", "finalize_umoments_plain", "reduce_umoments_plain"):
            m.setattr(mc, name, _refuse)
        out = mc._reduce_u_cuda(u, w, order)
    assert {k: c for k, c in mc.LAUNCHES.items() if c} == {"head_shift": 1, "finalize_u": 1}
    assert [tuple(t.shape) for t in out] == [(nbatch,), (order + 1, nbatch), (nbatch,)]
    assert all(t.dtype == torch.float32 and bool(torch.isfinite(t).all()) for t in out)
    ref = mc.reduce_umoments_plain(u.double(), None if w is None else w.double(), order)
    assert_close(out, ref, RTOL32, 2e-5 if dtype == torch.bfloat16 else ATOL32)
    assert bool((out[1][0] == 1).all()) and bool((out[1][1] == 0).all())


@pytest.mark.parametrize(("nbatch", "r", "order", "weighted"), [(3, 2500, 5, True), (1, 5003, 7, False)])
def test_k4_emulated_matches_jax(kernels, rng, nbatch, r, order, weighted):
    """The K4 kernel on the CPU against the JAX package's Pallas kernel in
    interpret mode (tests/test_parallel.py:138's shapes and data), at the
    float32 bar and at K4's own (uave rtol 1e-6)."""
    from thermoextrap_tpu.ops import moments_pallas as jpallas

    u = rng.normal(-50.0, 2.0, (nbatch, r)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (nbatch, r)).astype(np.float32) if weighted else None
    juave, jdu = jpallas.reduce_central_umoments_batched(u, order, weight=w, interpret=True)
    uave, du, _ = mc._reduce_u_cuda(tt(u), None if w is None else tt(w), order)
    assert_close((uave, du), (juave, jdu), RTOL32, ATOL32)
    assert_close(uave, juave, 1e-6)


def test_head_shift_emulated_u_alone(kernels, rng):
    """The head shift with no value stream (V = 0, the K4 / K5 wrappers'
    first launch): s_u of each row against _head_shift, 0 for a zero-weight
    head, the same bits as the u column of a shift with values, bfloat16
    streams, and the flat form."""
    nbatch, r = 3, 9000
    u = _f32(rng.normal(5.0, 1.0, (nbatch, r)))
    x = _f32(rng.normal(2.0, 0.5, (nbatch, r, 2)))
    w = _f32(rng.uniform(0.5, 1.5, (nbatch, r)))
    w[1, : mc.HEAD_N] = 0.0
    mc.reset_launches()
    got = mc.head_shift_cuda(u, None, w)
    assert mc.LAUNCHES["head_shift"] == 1 and got.shape == (nbatch,) and got.dtype == torch.float32
    assert_close(got, mc._head_shift(u, w), 1e-6)
    assert float(got[1]) == 0.0
    assert torch.equal(got, mc.head_shift_cuda(u, x, w)[:, 0])
    ub = u.to(torch.bfloat16)
    assert_close(mc.head_shift_cuda(ub, None), mc._head_shift(ub.float(), None), 1e-6)
    flat = mc.head_shift_cuda(u[2], None)
    assert flat.shape == (1,)
    assert_close(flat, mc._head_shift(u[2:], None), 1e-6)


# -- K5 on the tensor cores: counts as exact bf16, rows as three bf16 terms ------------------


def test_mma_stand_in_matches_float64_matmul(kernels):
    """The warp-collective stand-in of mma.sync m16n8k16 (csrc/emulate) and
    the fragment layout of tx_mma_bf16_16816 against a float64 matmul of the
    same bf16 values."""
    gen = torch.Generator().manual_seed(3)
    a = torch.randn((16, 16), generator=gen).bfloat16()
    b = torch.randn((16, 8), generator=gen).bfloat16()
    c = torch.randn((16, 8), generator=gen)
    d = mc.mma_probe_cuda(a, b, c)
    assert d.shape == (16, 8) and d.dtype == torch.float32
    assert_close(d, a.double() @ b.double() + c.double(), 1e-6, 1e-6)
    ident = torch.eye(16)[:, :8].bfloat16()
    assert torch.equal(mc.mma_probe_cuda(a, ident, torch.zeros(16, 8)), a[:, :8].float())


@pytest.mark.parametrize(
    ("nbatch", "r", "order", "nrep", "weighted", "dtype"),
    [
        (4, 70, 6, 9, True, torch.float32),  # 28 rows: part of one block's 224
        (64, 40, 6, 5, False, torch.float32),  # the lnPi grid's 448 rows: two row blocks
        (64, 33, 6, 130, True, torch.bfloat16),  # two replicate blocks, a ragged tile
    ],
)
def test_k5_tensor_core_path_draws_equal_table_and_match_plain(kernels, rng, nbatch, r, order, nrep, weighted, dtype):
    assert mc._k5_on_tensor_cores(nbatch * (order + 1), order)
    u = _f32(rng.normal(5.0, 1.0, (nbatch, r))).to(dtype)
    w = _f32(rng.uniform(0.5, 1.5, (nbatch, r))) if weighted else None
    wd = None if w is None else w.double()
    table = mc._poisson_counts(21, nrep, r)
    mc.reset_launches()
    k5 = mc._resample_u_cuda(u, w, nrep, order, seed=21)
    assert {k: c for k, c in mc.LAUNCHES.items() if c} == {"head_shift": 1, "finalize_u": 1}
    consume = mc._resample_u_cuda(u, w, nrep, order, freq=table)
    assert all(torch.equal(a, b) for a, b in zip(k5, consume))
    atol = 2e-5 if dtype == torch.bfloat16 else ATOL32
    assert_close(k5, mc.resample_umoments_plain(u.double(), wd, table, order), RTOL32, atol)
    # counts past one bf16 digit (and a negative one) take the digit passes;
    # each replicate's weights stay spread over its samples
    big = table.clone()
    big[0] += 300
    big[1 % nrep] *= 70_001
    big[2 % nrep] += 1
    big[2 % nrep, 5] = -1
    got = mc._resample_u_cuda(u, w, nrep, order, freq=big)
    assert_close(got, mc.resample_umoments_plain(u.double(), wd, big, order), RTOL32, atol)


def test_k5_tensor_core_path_matches_jax_table_bootstrap(kernels, rng):
    """K5's kernel consuming an index bootstrap's count table against the JAX
    package's table bootstrap of the same float32 values."""
    from thermoextrap_tpu.ops import resample as jresample

    order, nbatch, r, nrep = 5, 5, 300, 7
    u = _f32(np.linspace(-1.0, 1.0, nbatch)[:, None] + rng.normal(5.0, 1.0, (nbatch, r)))
    freq = np.asarray(jresample.freq_from_indices(rng.integers(0, r, (nrep, r)), r))
    uave, du, _ = mc._resample_u_cuda(u, None, nrep, order, freq=tt(freq))
    ju, jdu = jresample.resample_central_umoments_batched(np.asarray(u.double()), freq, order)
    assert_close((uave, du), (ju, jdu), RTOL32, ATOL32)


@pytest.mark.parametrize(
    ("nchunk", "nrep", "nbatch", "order"),
    [(5, 6, 3, 6), (1, 2, 64, 7), (40, 3, 2, 15), (3, 64, 257, 2)],  # the last: 2 lanes a pair, not 32
)
def test_finalize_umoments_emulated_matches_plain(kernels, rng, nchunk, nrep, nbatch, order):
    """K5's finalize kernel against the composition it replaced (float64
    chunk sum, _u_epilogue, float32 cast); a replicate of zero weight takes
    the finite convention (uave = the shift, central moments 0)."""
    part = _f32(rng.uniform(-0.3, 0.7, (nchunk, nrep, nbatch * (order + 1))))
    part.view(nchunk, nrep, nbatch, order + 1)[..., 0] = part.view(nchunk, nrep, nbatch, order + 1)[..., 0].abs() + 0.5
    part[:, 1] = 0.0
    s_u = _f32(rng.normal(size=nbatch))
    mc.reset_launches()
    got = mc.finalize_umoments_cuda(part, s_u, order, nbatch)
    assert mc.LAUNCHES["finalize_u"] == 1
    sums = part.double().sum(0).reshape(nrep, nbatch, order + 1).permute(2, 0, 1)
    composed = tuple(t.float() for t in mc._u_epilogue(sums, s_u.double()))
    assert all(a.shape == b.shape and a.dtype == torch.float32 for a, b in zip(got, composed))
    assert_close(got, composed, 1e-6, 1e-30)
    assert_close(got, mc.finalize_umoments_plain(part, s_u, order, nbatch), 1e-6, 1e-30)
    assert torch.equal(got[0][1], s_u) and float(got[2][1].abs().max()) == 0.0
    assert bool((got[1][2:, 1] == 0).all()) and bool((got[1][0] == 1).all()) and bool((got[1][1] == 0).all())
