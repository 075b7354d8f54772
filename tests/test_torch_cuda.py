"""The CUDA kernels of the torch port against their plain torch versions, on
a GPU.  Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is False.

This file imports neither jax nor the JAX package, so it also runs on a
machine without them (``tests/conftest.py`` does import jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the float32 kernels against the float64 plain versions at the
bar of tests/test_parallel.py:87 (rtol 2e-3, atol 1e-5), K4 at the bar of
tests/test_parallel.py:158-161 (uave rtol 1e-6; du rtol 5e-3, atol 1e-4);
K1 / K6, K2 / K3, K4 and K5 each make three launches (head shift, kernel,
finalize) and reach no plain version on a CUDA tensor;
K3 against K2, and K5 against its own consume of the same count table,
which share one kernel body, exactly.  The finalize kernel of the K2 / K3 wrapper against its plain version
at 1e-6 relative (both recentre in float64, then cast), the head-shift kernel
at 1e-6 relative (float32 sums in another order).  K7 and K8 sum positive
float32 terms (a few hundred per thread, then float64): rtol 2e-5 / atol 1e-5,
the bar of tests/test_parallel.py:716-818; K8 against K7 on its own table,
and its weight sums at e = 1 against K3's, exactly.  The sharded path runs on
a world of one NCCL rank (``parallel.make_mesh(1, ...)``, ended with the
module): no kernel launch, the unsharded calls at the float32 bars.
"""

import numpy as np
import pytest
import torch
from _torch_parity import assert_close, cuda_device, npy, tt  # noqa: F401

from thermoextrap_tpu_torch import pipeline as tpipe
from thermoextrap_tpu_torch.ops import _build
from thermoextrap_tpu_torch.ops import moments_cuda as mc

pytestmark = pytest.mark.cuda

RTOL32, ATOL32 = 2e-3, 1e-5
BETAS = np.array([0.8, 1.0, 1.3])


@pytest.fixture
def rng():
    return np.random.default_rng(17)


def _samples(rng, r, v, batch=()):
    u = rng.normal(5.0, 1.0, batch + (r,))
    x = 2.0 + 0.3 * (u[..., None] - 5.0) + rng.normal(0.0, 0.5, batch + (r, v))
    return u, x


def _f32(a, device):
    return tt(a, torch.float32).to(device)


@pytest.mark.parametrize(("r", "v", "weighted"), [(1_000_037, 1, False), (20_000, 2, True), (100, 3, True)])
def test_k1_kernel_matches_plain(rng, cuda_device, r, v, weighted):
    u, x = _samples(rng, r, v)
    w = rng.uniform(0.5, 1.5, r) if weighted else None
    ref = mc.reduce_central_comoments_fused(tt(u), tt(x), 6, None if w is None else tt(w))
    mc.reset_launches()
    got = mc.reduce_central_comoments_fused(
        _f32(u, cuda_device), _f32(x, cuda_device), 6, None if w is None else tt(w).to(cuda_device)
    )
    torch.cuda.synchronize()
    assert mc.LAUNCHES["K1"] == 1
    assert all(g.dtype == torch.float32 and g.is_cuda for g in got)
    assert_close(got, ref, RTOL32, ATOL32)


def test_k1_kernel_bf16_and_f64_inputs(rng, cuda_device):
    """bf16 streams: against float64 of the quantized data (tests/test_parallel.py:520
    bar); float64 inputs are cast to float32 for the kernel."""
    u, x = _samples(rng, 300_000, 1)
    ub = tt(u).to(torch.bfloat16)
    xb = tt(x).to(torch.bfloat16)
    ref16 = mc.reduce_central_comoments_fused(ub.double(), xb.double(), 6)
    assert_close(mc.reduce_central_comoments_fused(ub.to(cuda_device), xb.to(cuda_device), 6), ref16, RTOL32, 2e-5)
    ref = mc.reduce_central_comoments_fused(tt(u), tt(x), 6)
    got = mc.reduce_central_comoments_fused(tt(u).to(cuda_device), tt(x).to(cuda_device), 6)
    assert got[0].dtype == torch.float32
    assert_close(got, ref, RTOL32, ATOL32)
    with pytest.raises(ValueError, match="mixed input dtypes"):
        mc.reduce_central_comoments_fused(ub.to(cuda_device), _f32(x, cuda_device), 6)


def test_k6_kernel_matches_plain(rng, cuda_device):
    u, x = _samples(rng, 50_000, 1, (20,))
    w = rng.uniform(0.5, 1.5, (20, 50_000))
    ref = mc.reduce_central_comoments_batched(tt(u), tt(x), 6, tt(w))
    mc.reset_launches()
    got = mc.reduce_central_comoments_batched(_f32(u, cuda_device), _f32(x, cuda_device), 6, tt(w).to(cuda_device))
    assert mc.LAUNCHES["K6"] == 1
    assert_close(got, ref, RTOL32, ATOL32)


@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.int32, torch.int64, torch.float32, torch.bfloat16])
def test_k2_kernel_matches_plain(rng, cuda_device, dtype):
    r, nrep = 100_003, 37
    u, x = _samples(rng, r, 2)
    w = rng.uniform(0.5, 1.5, r)
    table = torch.as_tensor(rng.poisson(1.0, (nrep, r))).to(dtype)
    ref = mc.resample_central_comoments_fused(tt(u), tt(x), table.double(), 6, tt(w))
    mc.reset_launches()
    got = mc.resample_central_comoments_fused(
        _f32(u, cuda_device), _f32(x, cuda_device), table.to(cuda_device), 6, tt(w).to(cuda_device)
    )
    assert mc.LAUNCHES["K2"] == 1
    assert_close(got, ref, RTOL32, ATOL32)


def test_k2_zero_replicate_row(rng, cuda_device):
    """The kernel path's all-zero count row takes the same finite convention
    as the plain path (no NaN)."""
    u, x = _samples(rng, 5000, 1)
    table = torch.ones((3, 5000), dtype=torch.int32)
    table[1] = 0
    ref = mc.resample_central_comoments_fused(tt(u), tt(x), table, 4)
    got = mc.resample_central_comoments_fused(_f32(u, cuda_device), _f32(x, cuda_device), table.to(cuda_device), 4)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert_close(got, ref, RTOL32, ATOL32)


def test_k3_kernel_counts_and_sums(rng, cuda_device):
    """K3's in-kernel counts equal their plain reproduction bit for bit; K3
    equals K2 on that table; K3 matches its plain version."""
    r, nrep = (1 << 16) + 3, 40
    counts = mc.poisson_counts_cuda(7, nrep, r, cuda_device)
    assert torch.equal(counts.cpu(), mc._poisson_counts(7, nrep, r))
    u, x = _samples(rng, r, 1)
    uc, xc = _f32(u, cuda_device), _f32(x, cuda_device)
    mc.reset_launches()
    k3 = mc.resample_central_comoments_poisson(uc, xc, nrep, 6, seed=7, return_wsum=True)
    assert mc.LAUNCHES["K3"] == 1
    k2 = mc.resample_central_comoments_fused(uc, xc, counts, 6)
    assert all(torch.equal(a, b) for a, b in zip(k3, k2))
    assert_close(k3, mc.resample_central_comoments_poisson(tt(u), tt(x), nrep, 6, seed=7, return_wsum=True), RTOL32, ATOL32)


@pytest.mark.parametrize(
    ("v", "order", "dtype"),
    [(1, 6, torch.float32), (1, 6, torch.bfloat16), (2, 1, torch.float32), (2, 6, torch.float32), (2, 6, torch.bfloat16)],
)
def test_k2_k3_shared_contraction_rows(rng, cuda_device, v, order, dtype):
    """14 and 6 rows (few-rows kernel), 21 rows (many-rows kernel): K3 equals
    K2 on its own table, narrow tables equal int32 ones, and K3 matches its
    plain version."""
    r, nrep = 100_003, 70
    u, x = _samples(rng, r, v)
    w = rng.uniform(0.5, 1.5, r)
    uc, xc, wc = _f32(u, cuda_device).to(dtype), _f32(x, cuda_device).to(dtype), _f32(w, cuda_device)
    seed = 0x7FFF00001234ABCD
    table = mc._poisson_counts(seed, nrep, r, cuda_device)
    k3 = mc.resample_central_comoments_poisson(uc, xc, nrep, order, wc, seed=seed)
    assert all(torch.equal(a, b) for a, b in zip(k3, mc.resample_central_comoments_fused(uc, xc, table, order, wc)))
    narrow = mc.resample_central_comoments_fused(uc, xc, table.to(torch.int8), order, wc)
    assert all(torch.equal(a, b) for a, b in zip(k3, narrow))
    ref = mc.resample_poisson_plain(uc.double(), xc.double(), nrep, order, wc.double(), seed=seed)
    assert_close(k3, ref[:4], RTOL32, 2e-5 if dtype == torch.bfloat16 else ATOL32)


def test_poisson_map_every_word(cuda_device):
    """The draw's level lookup equals the 9-compare sum on all 2^32 words."""
    from thermoextrap_tpu_torch.ops.resample import POISSON1_THRESHOLDS

    _, stats = mc.poisson_map_cuda(start=0, n=1 << 32, device=cuda_device)
    assert stats.tolist() == [1 << 32, 0, sum((1 << 32) - 1 - t for t in POISSON1_THRESHOLDS)]


def test_kernel_rejects_grad(rng, cuda_device):
    """A direct call of a wrapper with an input that requires grad raises:
    K1 / K2 / K4 / K6 point to their backward route, K3 / K5 / K7 / K8 have
    none."""
    u, x = _samples(rng, 1000, 1)
    tu = _f32(u, cuda_device).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="returns no graph"):
        mc.reduce_central_comoments_fused(tu, _f32(x, cuda_device), 4)
    with pytest.raises(NotImplementedError, match="forward only"):
        mc.resample_central_comoments_poisson(tu, _f32(x, cuda_device), 8, 4)
    with pytest.raises(ValueError, match="but xv on cpu"):
        mc.reduce_central_comoments_fused(_f32(u, cuda_device), tt(x), 4)


def _grad_scalar(out):
    """A fixed scalar of the outputs (the role of ``scalar`` in
    tests/test_parallel.py:340-344)."""
    total = 0.0
    for o in out:
        ramp = torch.arange(1.0, 1.0 + o.numel(), dtype=o.dtype, device=o.device).reshape(o.shape)
        total = total + torch.sin(o).sum() + (o**2 * ramp).sum()
    return total


@pytest.mark.parametrize("kernel", ["K1", "K1_weighted", "K2", "K4", "K6"])
def test_kernel_gradients_match_plain(rng, cuda_device, kernel):
    """Gradients through the kernel route on the card (float32 kernels, the
    backward in float64) against autograd of the float64 plain path on the
    card, at the bar of tests/test_parallel.py:364-367 (rtol 2e-3, atol 1e-5)
    with the absolute part taken relative to the largest entry: the
    gradients scale as 1 / R, so an absolute 1e-5 would hold nothing here."""
    from thermoextrap_tpu_torch.ops import dispatch
    from thermoextrap_tpu_torch.ops import moments as tm
    from thermoextrap_tpu_torch.ops import resample as trs

    r = 20_000
    u, x = _samples(rng, r, 1)
    w = rng.uniform(0.5, 1.5, r)
    freq = tt(rng.integers(0, 3, (16, r))).to(torch.int32).to(cuda_device)
    cases = {
        "K1": (lambda a, b: dispatch.reduce_central(a, b, 6), lambda a, b: tm.reduce_central_comoments(a, b, 6), (u, x)),
        "K1_weighted": (
            lambda a, b, c: dispatch.reduce_central(a, b, 6, weight=c),
            lambda a, b, c: tm.reduce_central_comoments(a, b, 6, weight=c),
            (u, x, w),
        ),
        "K2": (
            lambda a, b: dispatch.resample_central(a, b, freq, 4),
            lambda a, b: trs.resample_central_comoments(a, b, freq, 4),
            (u, x),
        ),
        "K4": (
            lambda a: dispatch.reduce_central_u(a.reshape(4, -1), 6),
            lambda a: tm.reduce_central_umoments(a.reshape(4, -1), 6),
            (u,),
        ),
        "K6": (
            lambda a, b: dispatch.reduce_central(a.reshape(4, -1), b.reshape(4, -1, 1), 4),
            lambda a, b: tm.reduce_central_comoments(a.reshape(4, -1), b.reshape(4, -1, 1), 4),
            (u, x),
        ),
    }
    route, plain, inputs = cases[kernel]
    got_in = [_f32(a, cuda_device).requires_grad_(True) for a in inputs]
    ref_in = [tt(a).to(cuda_device).requires_grad_(True) for a in inputs]
    mc.reset_launches()
    got = torch.autograd.grad(_grad_scalar(route(*got_in)), got_in)
    assert mc.LAUNCHES[kernel[:2]] == 1
    ref = torch.autograd.grad(_grad_scalar(plain(*ref_in)), ref_in)
    for g, f, a in zip(got, ref, got_in):
        assert g.dtype == a.dtype
        assert_close(g, f, RTOL32, ATOL32 * float(f.abs().max()))


def test_pipeline_on_gpu_matches_cpu(rng, cuda_device):
    """The pipeline runs K1 then K3 on CUDA input and agrees with the
    float64 CPU path to a tenth of its bootstrap error; a numpy weight works;
    x_is_u on the GPU runs K4 then K5 and agrees the same way."""
    nconfig = 200_000
    pos = -np.log(1.0 - rng.uniform(size=(nconfig, 20)) * (1.0 - np.exp(-1.0)))
    x, u = pos.mean(-1), pos.sum(-1)
    cpu = tpipe.make_extrap_pipeline(6, 1.0)(tt(u), tt(x), tt(BETAS))
    mc.reset_launches()
    pred, std = tpipe.make_extrap_pipeline(6, 1.0, nrep=64)(tt(u).to(cuda_device), tt(x).to(cuda_device), tt(BETAS))
    assert mc.LAUNCHES["K1"] == 1 and mc.LAUNCHES["K3"] == 1
    assert np.all(np.abs(npy(pred) - npy(cpu)) <= 0.1 * npy(std) + 1e-6)
    w = rng.uniform(0.5, 1.5, nconfig)
    wcpu = tpipe.make_extrap_pipeline(6, 1.0, weighted=True)(tt(u), tt(x), tt(BETAS), tt(w))
    wpred, wstd = tpipe.make_extrap_pipeline(6, 1.0, nrep=64, weighted=True)(
        tt(u).to(cuda_device), tt(x).to(cuda_device), tt(BETAS), w
    )
    assert np.all(np.abs(npy(wpred) - npy(wcpu)) <= 0.1 * npy(wstd) + 1e-6)
    bpred = tpipe.make_extrap_pipeline(6, 1.0, bf16=True)(tt(u).to(cuda_device), tt(x).to(cuda_device), tt(BETAS))
    assert np.all(np.abs(npy(bpred) - npy(cpu)) <= 2 * npy(std))
    ucpu = tpipe.make_extrap_pipeline(6, 1.0, x_is_u=True)(tt(u), tt(BETAS))
    mc.reset_launches()
    upred, ustd = tpipe.make_extrap_pipeline(6, 1.0, x_is_u=True, nrep=64)(tt(u).to(cuda_device), tt(BETAS))
    assert mc.LAUNCHES["K4"] == 1 and mc.LAUNCHES["K5"] == 1 and mc.LAUNCHES["K1"] == 0
    assert np.all(np.abs(npy(upred) - npy(ucpu)) <= 0.1 * npy(ustd) + 1e-6)


def _grid_samples(rng, nbatch, r):
    return np.linspace(-1.0, 1.0, nbatch)[:, None] + rng.normal(5.0, 1.0, (nbatch, r))


@pytest.mark.parametrize(
    ("shape", "order", "dtype", "weighted"),
    [
        ((64, 20_000), 6, torch.float32, False),
        ((64, 20_000), 6, torch.bfloat16, False),
        ((1_000_037,), 7, torch.float32, False),
        ((5, 3001), 6, torch.float32, True),
    ],
)
def test_k4_kernel_matches_plain(rng, cuda_device, shape, order, dtype, weighted):
    """K4 against its plain version in float64 on the same (quantized) data."""
    u = rng.normal(5.0, 1.0, shape)
    w = rng.uniform(0.5, 1.5, shape) if weighted else None
    ud = tt(u).to(dtype).to(cuda_device)
    wd = None if w is None else tt(w).to(cuda_device)
    ref = mc.reduce_central_umoments_batched(ud.double().cpu(), order, None if w is None else tt(w))
    mc.reset_launches()
    got = mc.reduce_central_umoments_batched(ud, order, wd)
    torch.cuda.synchronize()
    assert mc.LAUNCHES["K4"] == 1
    assert all(g.dtype == torch.float32 and g.is_cuda for g in got)
    assert_close(got[0], ref[0], 1e-6)
    assert_close(got[1], ref[1], 5e-3, 1e-4)


def test_k5_kernel_counts_table_and_rows(rng, cuda_device):
    """K5's draws equal its consume of the _poisson_counts table exactly; that
    consume matches the plain table version to float32 roundoff; identical
    rows give identical replicates; on one row K5's weight sums equal K3's."""
    r, nrep, order = (1 << 16) + 3, 40, 6
    u = _grid_samples(rng, 6, r)
    uc = _f32(u, cuda_device)
    table = mc._poisson_counts(9, nrep, r)
    mc.reset_launches()
    k5 = mc.resample_central_umoments_batched_poisson(uc, nrep, order, seed=9, return_wsum=True)
    assert mc.LAUNCHES["K5"] == 1
    consume = mc.resample_umoments_table_cuda(uc, table.to(cuda_device), order, return_wsum=True)
    assert_close(k5, consume, 1e-6, 1e-9)
    assert_close(consume, mc.resample_umoments_plain(tt(u), None, table, order), 1e-5, 1e-6)
    same = _f32(np.broadcast_to(u[0], (3, r)), cuda_device)
    rows = mc.resample_central_umoments_batched_poisson(same, nrep, order, seed=9)
    assert all(torch.equal(t[..., 1:], t[..., :1].expand_as(t[..., 1:])) for t in rows)
    k3 = mc.resample_central_comoments_poisson(uc[0], uc[0][:, None], nrep, order, seed=9, return_wsum=True)
    _, _, wsum1 = mc.resample_central_umoments_batched_poisson(uc[:1], nrep, order, seed=9, return_wsum=True)
    assert torch.equal(wsum1[:, 0], k3[4])


@pytest.mark.parametrize("weighted", [False, True])
def test_k5_kernel_matches_plain(rng, cuda_device, weighted):
    nbatch, r, nrep, order = 64, 20_000, 64, 6
    u = _grid_samples(rng, nbatch, r)
    w = rng.uniform(0.5, 1.5, (nbatch, r)) if weighted else None
    ref = mc.resample_central_umoments_batched_poisson(tt(u), nrep, order, None if w is None else tt(w), seed=4)
    got = mc.resample_central_umoments_batched_poisson(
        _f32(u, cuda_device), nrep, order, None if w is None else tt(w).to(cuda_device), seed=4
    )
    assert_close(got, ref, RTOL32, ATOL32)


def test_k5_kernel_matches_plain_one_row(rng, cuda_device):
    """The x_is_u route's shape: one row at order 7 with 256 replicates, the
    layout with one row-thread and sample lanes summed in the block."""
    r, nrep, order = 200_003, 256, 7
    nr, _ = mc._u_thread_split(order + 1, nrep)
    assert nr == 1
    u = rng.normal(5.0, 1.0, (1, r))
    ref = mc.resample_central_umoments_batched_poisson(tt(u), nrep, order, seed=11, return_wsum=True)
    got = mc.resample_central_umoments_batched_poisson(_f32(u, cuda_device), nrep, order, seed=11, return_wsum=True)
    assert_close(got, ref, RTOL32, ATOL32)


def test_u_pipeline_bf16_streams(rng, cuda_device, monkeypatch):
    """bf16=True on the x_is_u path hands K4 (the u-only case, V = 0, of the
    reduction kernel), K5 and their head shifts a bfloat16 stream."""
    u = rng.normal(3.0, 0.5, 100_000)
    lib = _build.library()
    flags = {}

    def spy(name, pos):
        fn = getattr(lib, name)

        def call(*args):
            flags.setdefault(name, []).append(args[pos])
            return fn(*args)

        monkeypatch.setattr(lib, name, call)

    spy("tx_reduce_comoments", 10)
    spy("tx_resample_umoments", 13)
    spy("tx_head_shift", 8)
    run = tpipe.make_extrap_pipeline(4, 1.0, x_is_u=True, nrep=32, bf16=True)
    pred, std = run(tt(u).to(cuda_device), tt(BETAS))
    torch.cuda.synchronize()
    assert flags == {"tx_reduce_comoments": [1], "tx_resample_umoments": [1], "tx_head_shift": [1, 1]}
    ref = tpipe.make_extrap_pipeline(4, 1.0, x_is_u=True)(tt(u).to(torch.bfloat16).double(), tt(BETAS))
    assert np.all(np.abs(npy(pred) - npy(ref)) <= 0.1 * npy(std) + 1e-6)


def test_lnpi_and_volume_pipelines_on_gpu(rng, cuda_device):
    """lnΠ runs K4 then K5, volume K1 then K3; both agree with the float64
    CPU path to a tenth of their bootstrap error."""
    n_grid, r = 16, 50_000
    uv = _grid_samples(rng, n_grid, r)
    lnpi0 = rng.normal(0.0, 1.0, n_grid)
    mudotn = 0.7 * np.arange(n_grid, dtype=float)
    cpu = tpipe.make_lnpi_pipeline(4, 1.0)(tt(uv), tt(lnpi0), tt(mudotn), tt(BETAS))
    mc.reset_launches()
    pred, std = tpipe.make_lnpi_pipeline(4, 1.0, nrep=64)(_f32(uv, cuda_device), lnpi0, mudotn, tt(BETAS))
    assert mc.LAUNCHES["K4"] == 1 and mc.LAUNCHES["K5"] == 1
    assert pred.shape == (3, n_grid)
    assert np.all(np.abs(npy(pred) - npy(cpu)) <= 0.1 * npy(std) + 1e-6)
    pos = -np.log(1.0 - rng.uniform(size=(r, 10)) * (1.0 - np.exp(-1.0)))
    x, wv = pos.mean(-1), -pos.sum(-1)
    vols = tt([0.9, 1.0, 1.1])
    vcpu = tpipe.make_volume_pipeline(1.0, ndim=1)(tt(wv), tt(x), tt(x), vols)
    mc.reset_launches()
    vpred, vstd = tpipe.make_volume_pipeline(1.0, ndim=1, nrep=64)(
        _f32(wv, cuda_device), _f32(x, cuda_device), _f32(x, cuda_device), vols
    )
    assert mc.LAUNCHES["K1"] == 1 and mc.LAUNCHES["K3"] == 1
    assert np.all(np.abs(npy(vpred) - npy(vcpu)) <= 0.1 * npy(vstd) + 1e-6)


# -- K7 / K8: the perturbation bootstrap ------------------------------------------------

RTOL_P, ATOL_P = 2e-5, 1e-5


def _perturb_inputs(rng, r, v, na, weighted):
    """Stabilized weights ``e (A, R)`` as the pipeline builds them, in float64
    on the CPU, with zeroed columns when ``weighted``."""
    u, x = _samples(rng, r, v)
    w = None
    if weighted:
        w = rng.uniform(0.5, 1.5, r) * (rng.uniform(size=r) > 0.2)
    e = tpipe._perturb_weights(tt(u), tt(np.linspace(-0.3, 0.3, na)), None if w is None else tt(w))
    return e, tt(x)


@pytest.mark.parametrize(
    ("r", "v", "na", "nrep", "weighted", "table"),
    [
        (1000, 1, 5, 16, False, torch.int8),
        (100_003, 2, 5, 37, True, torch.int8),
        (40_001, 2, 171, 9, True, torch.int32),  # 513 contribution rows: two row tiles
        (5000, 3, 4, 130, True, torch.float32),  # fractional counts, two replicate blocks
    ],
)
def test_k7_kernel_matches_plain(rng, cuda_device, r, v, na, nrep, weighted, table):
    e, x = _perturb_inputs(rng, r, v, na, weighted)
    freq = tt(rng.poisson(1.0, (nrep, r))).to(table)
    if table == torch.float32:
        freq = freq * 0.5 + 0.25
    ref = mc.resample_perturb_freq(e, x, freq)
    mc.reset_launches()
    got = mc.resample_perturb_freq(e.to(cuda_device), x.to(cuda_device), freq.to(cuda_device))
    torch.cuda.synchronize()
    assert mc.LAUNCHES["K7"] == 1 and mc.LAUNCHES["K8"] == 0
    assert got.dtype == torch.float32 and got.is_cuda and got.shape == (na, nrep, v + 1)
    assert_close(got, ref, RTOL_P, ATOL_P)


def test_k8_kernel_equals_k7_on_its_table_and_k3_weight_sums(rng, cuda_device):
    r, nrep = (1 << 16) + 3, 40
    e, x = _perturb_inputs(rng, r, 2, 5, True)
    ec, xc = e.to(cuda_device), x.to(cuda_device)
    mc.reset_launches()
    k8 = mc.resample_perturb_poisson(ec, xc, nrep, seed=9)
    assert mc.LAUNCHES["K8"] == 1 and mc.LAUNCHES["K7"] == 0
    counts = mc.poisson_counts_cuda(9, nrep, r, cuda_device)
    assert torch.equal(counts.cpu(), mc._poisson_counts(9, nrep, r))
    assert torch.equal(k8, mc.resample_perturb_freq(ec, xc, counts))
    assert_close(k8, mc.resample_perturb_poisson(e, x, nrep, seed=9), RTOL_P, ATOL_P)
    assert not torch.equal(k8, mc.resample_perturb_poisson(ec, xc, nrep, seed=10))
    ones = torch.ones((1, r), dtype=torch.float32, device=cuda_device)
    wsum8 = mc.resample_perturb_poisson(ones, xc, nrep, seed=9)[0, :, -1]
    u = _f32(rng.normal(size=r), cuda_device)
    k3 = mc.resample_central_comoments_poisson(u, xc, nrep, 2, seed=9, return_wsum=True)
    assert torch.equal(wsum8, k3[4])


def test_k7_k8_zero_rows_return_zero_sums(rng, cuda_device):
    """A replicate of all-zero counts and a target whose weights are all zero
    give zero sums in the kernel; the 0/0 is the pipeline's."""
    r = 3000
    u, x = _samples(rng, r, 1)
    w = np.zeros(r)
    e = tpipe._perturb_weights(tt(u), tt([0.1, -0.1]), tt(w))
    assert torch.equal(e, torch.zeros_like(e))
    e[1] = 1.0
    freq = tt(rng.poisson(1.0, (4, r))).to(torch.int8)
    freq[2] = 0
    got = mc.resample_perturb_freq(e.to(cuda_device), tt(x).to(cuda_device), freq.to(cuda_device))
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert torch.equal(got[1, 2], torch.zeros_like(got[1, 2]))
    assert bool((got[1, [0, 1, 3], -1] > 0).all())
    pred, std = tpipe.make_perturb_pipeline(1.0, nrep=8, weighted=True)(
        _f32(u, cuda_device), _f32(x, cuda_device), tt([1.1]), tt(w).to(cuda_device)
    )
    assert bool(torch.isnan(pred).all()) and bool(torch.isnan(std).all())


@pytest.mark.parametrize(("mode", "kernel"), [("device", "K8"), ("table", "K7")])
def test_perturb_pipeline_on_gpu_launches_its_kernel_only(rng, cuda_device, monkeypatch, mode, kernel):
    """Each mode launches exactly its kernel, never reaches a plain version
    on CUDA tensors, and agrees with the float64 CPU path to a tenth of its
    bootstrap error."""
    r = 50_000
    u, x = _samples(rng, r, 2)
    cpu = tpipe.make_perturb_pipeline(5.0)(tt(u), tt(x), tt(BETAS) + 4.0)

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version was called on a CUDA tensor")

    for name in ("resample_perturb_plain", "resample_perturb_poisson_plain", "_perturb_sums_plain"):
        monkeypatch.setattr(mc, name, refuse)
    mc.reset_launches()
    pred, std = tpipe.make_perturb_pipeline(5.0, nrep=64, poisson=mode)(
        _f32(u, cuda_device), _f32(x, cuda_device), tt(BETAS) + 4.0, seed=3
    )
    torch.cuda.synchronize()
    assert mc.LAUNCHES == {**dict.fromkeys(mc.LAUNCHES, 0), kernel: 1}
    assert pred.shape == (3, 2) and pred.dtype == torch.float64
    assert np.all(np.abs(npy(pred) - npy(cpu)) <= 0.1 * npy(std) + 1e-6)


def test_numpy_input_runs_on_the_default_device(rng, cuda_device, monkeypatch):
    """Arrays that are not tensors go to the card when it is the default."""
    import thermoextrap_tpu_torch as tx

    monkeypatch.setattr(tx.utils.device, "_DEVICE", None)
    u, x = _samples(rng, 20_000, 1)
    mc.reset_launches()
    pred = tpipe.make_extrap_pipeline(4, 1.0)(u.astype(np.float32), x.astype(np.float32), BETAS)
    assert mc.LAUNCHES["K1"] == 1 and pred.is_cuda


def test_streaming_pipelines_on_gpu(rng, cuda_device):
    """Four chunks through K1 + K3 (and K4 + K5 with x_is_u) give the
    one-shot prediction to float32 roundoff; the state keeps type and place."""
    r = 80_000
    u, x = _samples(rng, r, 1)
    uc, xc = _f32(u, cuda_device), _f32(x, cuda_device)
    one = tpipe.make_extrap_pipeline(4, 1.0)(uc, xc, tt(BETAS))
    state, update, predict = tpipe.make_streaming_extrap_pipeline(4, 1.0, val_shape=(1,), nrep=32, device=cuda_device)
    mc.reset_launches()
    for a, b in zip(uc.chunk(4), xc.chunk(4)):
        state = update(state, a, b)
    assert mc.LAUNCHES["K1"] == 4 and mc.LAUNCHES["K3"] == 4
    pred, std = predict(state, tt(BETAS))
    assert state[2] == 4 and state[0].xave.dtype == torch.float64 and state[1].dxdu.is_cuda
    assert_close(pred, one, 1e-6, 1e-9)
    assert bool((std > 0).all())
    one_u = tpipe.make_extrap_pipeline(4, 1.0, x_is_u=True)(uc, tt(BETAS))
    state, update, predict = tpipe.make_streaming_extrap_pipeline(4, 1.0, x_is_u=True, nrep=32, device=cuda_device)
    mc.reset_launches()
    for a in uc.chunk(4):
        state = update(state, a)
    assert mc.LAUNCHES["K4"] == 4 and mc.LAUNCHES["K5"] == 4
    assert_close(predict(state, tt(BETAS))[0], one_u, 1e-6, 1e-9)


def test_streaming_perturbation_on_gpu_bootstraps_through_k7(rng, cuda_device):
    """With replicates the streaming perturbation folds each chunk through
    K8 (the counts drawn in the kernel at the chunk's seed; K7 and its
    table are no longer on this path): one launch per chunk, the one-shot
    prediction to float32 roundoff and a sigma within 40% of the one-shot
    sigma (two independent 64-replicate draws, each sigma with a 9%
    standard error)."""
    r = 60_000
    u, x = _samples(rng, r, 1)
    uc, xc = _f32(u, cuda_device), _f32(x, cuda_device)
    betas = tt(BETAS) + 4.0
    one, one_std = tpipe.make_perturb_pipeline(5.0, nrep=64)(uc, xc, betas, seed=5)
    state, update, predict = tpipe.make_streaming_perturb_pipeline(
        5.0, betas, val_shape=(1,), nrep=64, seed=5, device=cuda_device
    )
    mc.reset_launches()
    for a, b in zip(uc.chunk(3), xc.chunk(3)):
        state = update(state, a, b)
    assert mc.LAUNCHES == {**dict.fromkeys(mc.LAUNCHES, 0), "K8": 3}
    pred, std = predict(state)
    assert state[5] == 3 and state[3].dtype == torch.float64 and state[3].is_cuda
    assert_close(pred, one, 1e-6, 1e-9)
    ratio = npy(std) / npy(one_std)
    assert np.all((ratio > 0.6) & (ratio < 1.4))


def test_streaming_perturbation_k8_route_matches_plain(rng, cuda_device):
    """One streaming perturbation chunk on the card: its replicate sums are
    K8's at the chunk's seed, held against K8's plain version (float64 on
    the card) at K7 / K8's bar; the ``xla_only`` route on the card draws the
    same counts (plain torch, no launch) and agrees at that bar."""
    r = 200_003
    u, x = _samples(rng, r, 2)
    uc, xc = _f32(u, cuda_device), _f32(x, cuda_device)
    betas = tt(BETAS) + 4.0
    state0, update, _ = tpipe.make_streaming_perturb_pipeline(5.0, betas, val_shape=(2,), nrep=32, seed=9, device=cuda_device)
    mc.reset_launches()
    st = update(state0, uc, xc)
    assert mc.LAUNCHES == {**dict.fromkeys(mc.LAUNCHES, 0), "K8": 1}
    e = tpipe._perturb_weights(uc.double(), (betas.to(cuda_device) - 5.0), None)
    ref = mc.resample_perturb_poisson_plain(e, xc.double(), 32, seed=tpipe._chunk_seed(9, 0))
    assert_close((st[3], st[4]), (ref[..., :2], ref[..., 2]), 2e-5, 1e-5)
    x0, xupdate, _ = tpipe.make_streaming_perturb_pipeline(
        5.0, betas, val_shape=(2,), nrep=32, seed=9, device=cuda_device, xla_only=True
    )
    mc.reset_launches()
    xs = xupdate(x0, uc, xc)
    assert not any(mc.LAUNCHES.values())
    assert_close((xs[3], xs[4]), (ref[..., :2], ref[..., 2]), 2e-5, 1e-5)


def test_artifacts_on_cuda_match_the_in_process_routes(rng, cuda_device, tmp_path):
    """A batch artifact and a streaming bundle, traced on the CPU, saved and
    loaded, run on CUDA tensors with no kernel launch: the extrapolation at
    the float32 bars of the K1 route, its replicates on K3's counts (the same
    seed) at that bar; the bundle equal to the in-process ``xla_only`` stream
    on the card."""
    from thermoextrap_tpu_torch import serving_export as se

    u, x = _samples(rng, 100_000, 1)
    uc, xc = _f32(u, cuda_device), _f32(x, cuda_device)
    betas = tt(BETAS) + 4.0
    path = tmp_path / "extrap.thexport"
    se.export_extrap_pipeline(4, 5.0, nrep=32).save(path)
    art = se.load_exported(path)
    mc.reset_launches()
    pred, std = art(uc, xc, betas, seed=3)
    torch.cuda.synchronize()
    assert not any(mc.LAUNCHES.values()) and pred.is_cuda and pred.dtype == torch.float32
    kpred, kstd = tpipe.make_extrap_pipeline(4, 5.0, nrep=32)(uc, xc, betas, seed=3)
    assert_close(pred, kpred.reshape(pred.shape), RTOL32, ATOL32)
    assert_close(std, kstd.reshape(std.shape), RTOL32, ATOL32)
    bundle = se.export_streaming_extrap_pipeline(4, 5.0, nrep=8, seed=2)
    s0, upd, prd = tpipe.make_streaming_extrap_pipeline(4, 5.0, nrep=8, seed=2, xla_only=True, dtype=torch.float32, device=cuda_device)
    st, bst = s0, bundle.init_state(cuda_device)
    mc.reset_launches()
    for a, b in zip(uc.chunk(3), xc.chunk(3)):
        st, bst = upd(st, a, b), bundle.update(bst, a, b)
    assert not any(mc.LAUNCHES.values()) and bst[0].is_cuda
    assert_close(bundle.predict(bst, betas), prd(st, betas), 1e-6, 1e-9)


# -- the helper kernels of the K2 / K3 wrapper, and the count table's load paths ---------


def _rel_err(got, ref):
    """Largest ``|got - ref| / |ref|`` over two tuples (0 where both agree)."""
    worst = 0.0
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype and bool(torch.isfinite(a).all())
        diff = (a.double() - b.double()).abs()
        worst = max(worst, float(torch.where(diff == 0, diff, diff / b.double().abs()).max()))
    return worst


def test_k2_k3_wrapper_is_three_launches(rng, cuda_device, monkeypatch):
    """Each K2 / K3 call launches the head shift, the bootstrap kernel and the
    finalize kernel once, and reaches no plain version on CUDA tensors."""
    u, x = _samples(rng, 30_000, 2)
    uc, xc = _f32(u, cuda_device), _f32(x, cuda_device)
    table = torch.as_tensor(rng.poisson(1.0, (9, 30_000)), dtype=torch.int8, device=cuda_device)

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version was called on a CUDA tensor")

    for name in ("_head_shift", "_shifted_epilogue", "finalize_comoments_plain"):
        monkeypatch.setattr(mc, name, refuse)
    mc.reset_launches()
    mc.resample_central_comoments_fused(uc, xc, table, 6)
    assert mc.LAUNCHES == {**dict.fromkeys(mc.LAUNCHES, 0), "K2": 1, "head_shift": 1, "finalize": 1}
    out = mc.resample_central_comoments_poisson(uc, xc, 9, 6, seed=3, return_wsum=True)
    torch.cuda.synchronize()
    assert mc.LAUNCHES == {**dict.fromkeys(mc.LAUNCHES, 0), "K2": 1, "K3": 1, "head_shift": 2, "finalize": 2}
    assert len(out) == 5 and out[4].shape == (9,) and all(t.dtype == torch.float32 for t in out)


@pytest.mark.parametrize(("v", "order", "nchunk"), [(1, 6, 196), (2, 6, 37), (40, 6, 3), (3, 15, 1), (1, 1, 5)])
def test_finalize_kernel_matches_plain(cuda_device, v, order, nchunk):
    """The finalize kernel against its plain version (1e-6 relative after the
    float32 cast: both recentre in float64); an all-zero replicate comes out
    equal exactly, with its means at the shift and weight 0."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    nrep = 6
    part = torch.rand((nchunk, nrep, (v + 1) * (order + 1)), generator=gen, device=cuda_device) - 0.3
    part[:, :, 0] = part[:, :, 0].abs() + 0.5
    part[:, 2] = 0.0
    shift = torch.rand(v + 1, generator=gen, device=cuda_device)
    mc.reset_launches()
    got = mc.finalize_comoments_cuda(part, shift, order, v)
    torch.cuda.synchronize()
    assert mc.LAUNCHES["finalize"] == 1
    ref = mc.finalize_comoments_plain(part, shift[:1], shift[1:], order, v)
    assert _rel_err(got, ref) <= 1e-6
    assert torch.equal(got[2][:, 2], ref[2][:, 2]) and torch.equal(got[3][:, 2], ref[3][:, 2])
    assert torch.equal(got[0][2], shift[1:]) and float(got[1][2]) == float(shift[0]) and float(got[4][2]) == 0.0
    assert torch.equal(got[0], mc.finalize_comoments_cuda(part, shift, order, v)[0])  # the same bits on every run
    with pytest.raises(ValueError, match="do not fit"):
        mc.finalize_comoments_cuda(part, shift[:-1], order, v)


def test_finalize_kernel_on_k2_partials(rng, cuda_device, monkeypatch):
    """On the partials of a real K2 call (the quick start's shape)."""
    r, nrep = 100_000, 100
    u, x = _samples(rng, r, 1)
    table = torch.as_tensor(rng.poisson(1.0, (nrep, r)), dtype=torch.int32, device=cuda_device)
    seen = {}
    finalize = mc.finalize_comoments_cuda

    def keep(part, shift, order, v):
        seen.update(part=part, shift=shift)
        return finalize(part, shift, order, v)

    monkeypatch.setattr(mc, "finalize_comoments_cuda", keep)
    got = mc.resample_central_comoments_fused(_f32(u, cuda_device), _f32(x, cuda_device), table, 6)
    part, shift = seen["part"], seen["shift"]
    assert part.shape == (mc._rows_launch(14, nrep, r, mc._TARGET_BLOCKS)[2], nrep, 14)
    ref = mc.finalize_comoments_plain(part, shift[:1], shift[1:], 6, 1)
    assert _rel_err(got, ref[:4]) <= 1e-6


@pytest.mark.parametrize(
    ("r", "v", "dtype", "weighted"),
    [(100_000, 1, torch.float32, False), (100_000, 3, torch.float32, True), (20_000, 3, torch.bfloat16, True), (1000, 2, torch.float32, True), (1, 1, torch.float32, False)],
)
def test_head_shift_kernel_matches_plain(rng, cuda_device, r, v, dtype, weighted):
    u, x = _samples(rng, r, v)
    uc, xc = tt(u).to(dtype).to(cuda_device), tt(x).to(dtype).to(cuda_device)
    wc = _f32(rng.uniform(0.5, 1.5, r), cuda_device) if weighted else None
    mc.reset_launches()
    got = mc.head_shift_cuda(uc, xc, wc)
    torch.cuda.synchronize()
    assert mc.LAUNCHES["head_shift"] == 1 and got.shape == (v + 1,) and got.dtype == torch.float32
    s_u, s_x = mc._head_shift(uc[None].float(), None if wc is None else wc[None], xc[None])
    assert _rel_err((got,), (torch.cat([s_u, s_x[0]]),)) <= 1e-6
    if weighted:
        wc[: mc.HEAD_N] = 0.0
        assert torch.equal(mc.head_shift_cuda(uc, xc, wc), torch.zeros(v + 1, device=cuda_device))


@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.int32, torch.float32, torch.bfloat16])
def test_k2_table_vector_and_scalar_loads(rng, cuda_device, dtype):
    """K2 reads its table by vector loads where a row's 4 entries are aligned
    and entry by entry elsewhere: a sample count that is no multiple of 4, a
    table that starts one entry past an aligned address and an aligned table
    all match the plain version, and the last two give the same bits."""
    nrep = 11
    for r in (4099, 4096):
        u, x = _samples(rng, r, 1)
        uc, xc = _f32(u, cuda_device), _f32(x, cuda_device)
        counts = tt(rng.poisson(1.0, (nrep, r)))
        table = (counts.float() * 0.5 + 0.25 if dtype == torch.float32 else counts.to(dtype)).to(cuda_device)
        ref = mc.resample_central_comoments_fused(tt(u), tt(x), table.cpu().double(), 6)
        got = mc.resample_central_comoments_fused(uc, xc, table, 6)
        assert_close(got, ref, RTOL32, ATOL32)
        shifted = torch.empty(table.numel() + 1, dtype=dtype, device=cuda_device)[1:].view(table.shape)
        shifted.copy_(table)
        assert shifted.is_contiguous() and shifted.data_ptr() % (4 * shifted.element_size()) != 0
        off = mc.resample_central_comoments_fused(uc, xc, shifted, 6)
        assert all(torch.equal(a, b) for a, b in zip(got, off))


# -- K5 / K7 / K8 on ragged shapes: the shared contraction kernel's edges ------------------


@pytest.mark.parametrize(
    ("r", "nrep", "na", "v"),
    [
        (1, 1, 1, 1),  # one sample, one replicate, the fewest rows a call can have (2)
        (63, 129, 5, 1),  # a tile less one sample; two replicate blocks; 10 rows
        (65, 1, 9, 1),  # a tile plus one sample; 18 rows (two row-threads)
        (129, 129, 171, 2),  # 513 rows: two row tiles
        (4097, 37, 5, 1),
    ],
)
def test_k7_k8_ragged_shapes(rng, cuda_device, r, nrep, na, v):
    """K7 against the float64 plain version and K8 equal to K7 on its own
    table bit for bit, where the samples end inside a tile, the replicates
    inside a block and the rows inside a row tile."""
    u, x = _samples(rng, r, v)
    e = tpipe._perturb_weights(tt(u), tt(np.linspace(-0.3, 0.3, na)), None)
    xv = tt(x)
    ec, xc = e.to(cuda_device), xv.to(cuda_device)
    for dtype in (torch.int8, torch.int32):
        freq = tt(rng.poisson(1.0, (nrep, r))).to(dtype)
        got = mc.resample_perturb_freq(ec, xc, freq.to(cuda_device))
        assert got.shape == (na, nrep, v + 1)
        assert_close(got, mc.resample_perturb_freq(e, xv, freq), RTOL_P, ATOL_P)
    k8 = mc.resample_perturb_poisson(ec, xc, nrep, seed=21)
    counts = mc.poisson_counts_cuda(21, nrep, r, cuda_device)
    assert torch.equal(k8, mc.resample_perturb_freq(ec, xc, counts))
    assert torch.equal(k8, mc.resample_perturb_freq(ec, xc, counts.to(torch.int8)))


@pytest.mark.parametrize(
    ("nbatch", "r", "nrep", "order"),
    [(1, 1, 1, 1), (1, 63, 129, 7), (3, 65, 1, 6), (74, 129, 9, 6), (6, 4097, 129, 6)],
)
def test_k5_ragged_shapes(rng, cuda_device, nbatch, r, nrep, order):
    """K5's draws equal its consume of the same count table exactly, and both
    match the plain table version, on shapes that end inside a tile, a
    replicate block and a row tile (74 x 7 = 518 rows)."""
    u = _grid_samples(rng, nbatch, r)
    uc = _f32(u, cuda_device)
    table = mc._poisson_counts(13, nrep, r)
    k5 = mc.resample_central_umoments_batched_poisson(uc, nrep, order, seed=13, return_wsum=True)
    consume = mc.resample_umoments_table_cuda(uc, table.to(cuda_device), order, return_wsum=True)
    assert all(torch.equal(a, b) for a, b in zip(k5, consume))
    assert_close(consume, mc.resample_umoments_plain(tt(u), None, table, order), RTOL32, ATOL32)


# -- K1 / K6: one 16-byte pass over all value columns, three launches; K5 on tensor cores --------


@pytest.mark.parametrize(
    ("v", "dtype", "offset", "r"),
    [
        (1, torch.float32, 0, 1_000_003),
        (2, torch.float32, 1, 200_001),  # unaligned view: rows start off a 16-byte boundary
        (5, torch.float32, 0, 100_003),  # past the 4 columns kept in registers
        (1, torch.bfloat16, 3, 300_007),
        (2, torch.bfloat16, 0, 1_000_000),
    ],
)
def test_k1_single_pass_columns_and_alignment(rng, cuda_device, v, dtype, offset, r):
    """K1 on V = 1, 2, 5 columns, float32 and bfloat16 streams, aligned and
    unaligned views, weighted, against its float64 plain version on the same
    (quantized) values."""
    u, x = _samples(rng, r + offset, v)
    uc = tt(u).to(dtype).to(cuda_device)[offset:]
    xc = tt(x).to(dtype).to(cuda_device)[offset:]
    wc = _f32(rng.uniform(0.5, 1.5, r), cuda_device)
    ref = mc.reduce_central_comoments_fused(uc.double().cpu(), xc.double().cpu(), 6, wc.double().cpu())
    mc.reset_launches()
    got = mc.reduce_central_comoments_fused(uc, xc, 6, wc)
    torch.cuda.synchronize()
    assert mc.LAUNCHES["K1"] == mc.LAUNCHES["head_shift"] == mc.LAUNCHES["finalize"] == 1
    assert_close(got, ref, RTOL32, 2e-5 if dtype == torch.bfloat16 else ATOL32)


def test_k1_k6_wrapper_is_three_launches(rng, cuda_device, monkeypatch):
    """Each K1 / K6 call launches the head shift, the reduction and the
    finalize kernel once, and reaches no plain version on CUDA tensors."""
    u, x = _samples(rng, 40_000, 1, (3,))
    uc, xc = _f32(u, cuda_device), _f32(x, cuda_device)

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version was called on a CUDA tensor")

    for name in ("_head_shift", "_shifted_epilogue", "finalize_comoments_plain", "reduce_comoments_plain"):
        monkeypatch.setattr(mc, name, refuse)
    mc.reset_launches()
    mc.reduce_central_comoments_fused(uc[0], xc[0], 6)
    assert mc.LAUNCHES == {**dict.fromkeys(mc.LAUNCHES, 0), "K1": 1, "head_shift": 1, "finalize": 1}
    out = mc.reduce_central_comoments_batched(uc, xc, 6)
    torch.cuda.synchronize()
    assert mc.LAUNCHES == {**dict.fromkeys(mc.LAUNCHES, 0), "K1": 1, "K6": 1, "head_shift": 2, "finalize": 2}
    assert [tuple(t.shape) for t in out] == [(3, 1), (3,), (7, 3), (7, 3, 1)]


def test_mma_probe_matches_float64(cuda_device):
    """The tensor cores' mma.sync through tx_mma_bf16_16816's fragment
    layout: products of bf16 values are exact, so a float64 matmul of the
    same values agrees to float32 roundoff of the sums."""
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    a = torch.randn((16, 16), generator=gen, device=cuda_device).bfloat16()
    b = torch.randn((16, 8), generator=gen, device=cuda_device).bfloat16()
    c = torch.randn((16, 8), generator=gen, device=cuda_device)
    assert_close(mc.mma_probe_cuda(a, b, c), a.double() @ b.double() + c.double(), 1e-6, 1e-6)
    small = torch.randint(0, 9, (16, 16), generator=gen, device=cuda_device).bfloat16()
    ident = torch.eye(16, device=cuda_device)[:, :8].bfloat16()
    assert torch.equal(mc.mma_probe_cuda(small, ident, torch.zeros(16, 8, device=cuda_device)), small[:, :8].float())


@pytest.mark.parametrize(("nbatch", "order"), [(4, 6), (64, 6), (64, 7)])  # 28, 448 and 512 rows
def test_k5_tensor_cores_draws_tables_and_large_counts(rng, cuda_device, nbatch, order):
    """K5 past 16 rows runs on the tensor cores: its draws equal its consume
    of the same table bit for bit, both match the float64 plain version, and
    a table with counts past 256 (a bf16 digit) and a negative one does too."""
    r, nrep = 50_003, 40
    assert mc._k5_on_tensor_cores(nbatch * (order + 1), order)
    u = _grid_samples(rng, nbatch, r)
    uc = _f32(u, cuda_device)
    table = mc._poisson_counts(17, nrep, r)
    k5 = mc.resample_central_umoments_batched_poisson(uc, nrep, order, seed=17, return_wsum=True)
    consume = mc.resample_umoments_table_cuda(uc, table.to(cuda_device), order, return_wsum=True)
    assert all(torch.equal(a, b) for a, b in zip(k5, consume))
    assert_close(consume, mc.resample_umoments_plain(tt(u), None, table, order), RTOL32, ATOL32)
    big = table.clone()
    big[0] += 300
    big[1] *= 70_001
    big[2] += 1
    big[2, 5] = -1
    got = mc.resample_umoments_table_cuda(uc, big.to(cuda_device), order, return_wsum=True)
    assert_close(got, mc.resample_umoments_plain(tt(u), None, big, order), RTOL32, ATOL32)


def test_k5_wrapper_is_two_launches(rng, cuda_device, monkeypatch):
    """A K5 call launches the bootstrap kernel and its finalize kernel once,
    after one head-shift launch (three launches in all), and reaches no plain
    head shift or epilogue on CUDA tensors."""
    uc = _f32(_grid_samples(rng, 8, 30_000), cuda_device)

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version was called on a CUDA tensor")

    for name in ("_head_shift", "_u_epilogue", "finalize_umoments_plain"):
        monkeypatch.setattr(mc, name, refuse)
    mc.reset_launches()
    out = mc.resample_central_umoments_batched_poisson(uc, 64, 6, seed=2, return_wsum=True)
    torch.cuda.synchronize()
    assert mc.LAUNCHES == {**dict.fromkeys(mc.LAUNCHES, 0), "K5": 1, "head_shift": 1, "finalize_u": 1}
    assert [tuple(t.shape) for t in out] == [(64, 8), (7, 64, 8), (64, 8)]


# -- K4: the u-only case of the 16-byte reduction, three launches ---------------------------


def test_k4_wrapper_is_three_launches(rng, cuda_device, monkeypatch):
    """Each K4 call launches the head shift, the reduction kernel and the
    u-moment finalize kernel once, and reaches no plain version on CUDA
    tensors, flat or batched."""
    uc = _f32(_grid_samples(rng, 3, 40_000), cuda_device)

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version was called on a CUDA tensor")

    for name in ("_head_shift", "_u_epilogue", "finalize_umoments_plain", "reduce_umoments_plain"):
        monkeypatch.setattr(mc, name, refuse)
    mc.reset_launches()
    flat = mc.reduce_central_umoments_batched(uc[0], 7)
    assert mc.LAUNCHES == {**dict.fromkeys(mc.LAUNCHES, 0), "K4": 1, "head_shift": 1, "finalize_u": 1}
    out = mc.reduce_central_umoments_batched(uc.view(3, 1, -1), 6)
    torch.cuda.synchronize()
    assert mc.LAUNCHES == {**dict.fromkeys(mc.LAUNCHES, 0), "K4": 2, "head_shift": 2, "finalize_u": 2}
    assert [tuple(t.shape) for t in flat] == [(), (8,)]
    assert [tuple(t.shape) for t in out] == [(3, 1), (7, 3, 1)]


@pytest.mark.parametrize(
    ("nbatch", "r", "order", "dtype", "offset", "weighted"),
    [
        (1, 1_000_003, 7, torch.float32, 0, False),  # a scalar tail
        (5, 200_001, 6, torch.float32, 1, False),  # unaligned view: rows of mixed alignment
        (3, 200_001, 6, torch.float32, 1, True),  # u and w of different alignment: scalar loads
        (2, 300_007, 7, torch.bfloat16, 3, False),
        (64, 20_000, 6, torch.bfloat16, 0, True),  # the grid's rows, weighted
    ],
)
def test_k4_alignment_and_streams(rng, cuda_device, nbatch, r, order, dtype, offset, weighted):
    """K4 on float32 and bfloat16 streams, aligned and unaligned views, with
    and without weights, against its float64 plain version on the same
    (quantized) values at K4's bar (tests/test_parallel.py:158-161).  The
    last row of a weighted case has a zero-weight head, so shift 0, and a
    mean near 0: float32 sums about a shift far from the mean lose digits in
    any float32 reduction."""
    u = _grid_samples(rng, nbatch, r)
    if weighted:
        u[-1] = rng.normal(0.3, 1.0, r)
    flat = tt(np.concatenate([np.zeros(offset), u.reshape(-1)])).to(dtype).to(cuda_device)
    uc = flat[offset:].view(nbatch, r)
    wc = _f32(rng.uniform(0.5, 1.5, (nbatch, r)), cuda_device) if weighted else None
    if weighted:
        wc[-1, : mc.HEAD_N] = 0.0
    ref = mc.reduce_central_umoments_batched(uc.double().cpu(), order, None if wc is None else wc.double().cpu())
    mc.reset_launches()
    got = mc.reduce_central_umoments_batched(uc, order, wc)
    torch.cuda.synchronize()
    assert mc.LAUNCHES["K4"] == mc.LAUNCHES["head_shift"] == mc.LAUNCHES["finalize_u"] == 1
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all()) for g in got)
    assert_close(got[0], ref[0], 1e-6)
    assert_close(got[1], ref[1], 5e-3, 1e-4)


def test_finalize_umoments_kernel_matches_plain(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    nchunk, nrep, nbatch, order = 66, 9, 64, 6
    part = torch.rand((nchunk, nrep, nbatch * (order + 1)), generator=gen, device=cuda_device) - 0.3
    part.view(nchunk, nrep, nbatch, order + 1)[..., 0] += 0.8
    part[:, 3] = 0.0
    s_u = torch.rand(nbatch, generator=gen, device=cuda_device) + 4.0
    got = mc.finalize_umoments_cuda(part, s_u, order, nbatch)
    ref = mc.finalize_umoments_plain(part, s_u, order, nbatch)
    assert _rel_err(got, ref) <= 1e-6
    assert torch.equal(got[0][3], s_u) and float(got[2][3].abs().max()) == 0.0


# -- the interpolation models, the streaming interpolation, checkpoints, the bucketed runner --


def _interp_states(rng, device, r, betas=(0.8, 1.3)):
    """One-shot moment states of two simulations, on ``device``."""
    from thermoextrap_tpu_torch import beta as tbeta
    from thermoextrap_tpu_torch.data import DataCentralMoments

    out = []
    for b in betas:
        u, x = _samples(rng, r, 1)
        uc, xc = _f32(u, device), _f32(x * b, device)
        out.append((uc, xc, tbeta.factory_extrapmodel(b, DataCentralMoments.from_vals(xc, uc, 4))))
    return out


def test_interp_models_on_gpu_match_cpu(rng, cuda_device):
    """The collection models on CUDA states give CUDA tensors, equal to the
    same models on the CPU copies of the samples at the float32 bar (the
    joint solve runs in float64 on the card)."""
    from thermoextrap_tpu_torch import beta as tbeta
    from thermoextrap_tpu_torch.data import DataCentralMoments
    from thermoextrap_tpu_torch.models.extrap import ExtrapWeightedModel, InterpModel, InterpModelPiecewise

    sims = _interp_states(rng, cuda_device, 200_000, betas=(0.8, 1.05, 1.3))
    gpu = [m for _, _, m in sims]
    cpu = [tbeta.factory_extrapmodel(m.alpha0, DataCentralMoments.from_vals(x.cpu().double(), u.cpu().double(), 4)) for u, x, m in sims]
    betas = tt(BETAS)
    for cls in (InterpModel, ExtrapWeightedModel, InterpModelPiecewise):
        got = cls(gpu[::2] if cls is InterpModel else gpu).predict(betas)
        want = cls(cpu[::2] if cls is InterpModel else cpu).predict(betas)
        assert got.is_cuda and got.shape == want.shape, cls.__name__
        assert_close(got, want, RTOL32, ATOL32)
    assert InterpModel(gpu[::2]).coefs().dtype == torch.float64


def test_streaming_interp_on_gpu_launches_and_matches_one_shot(rng, cuda_device):
    """Two states in four interleaved chunks: one K1 and one K3 per chunk
    (each with its head shift and finalize), the one-shot InterpModel's
    mean to float32 roundoff, finite positive sigmas, and distinct
    replicate draws in the two states."""
    from thermoextrap_tpu_torch.models.extrap import InterpModel

    sims = _interp_states(rng, cuda_device, 80_000)
    states, update, predict = tpipe.make_streaming_interp_pipeline(4, (0.8, 1.3), val_shape=(1,), nrep=32, seed=7, device=cuda_device)
    mc.reset_launches()
    for k in range(2):
        for i, (u, x, _) in enumerate(sims):
            states = update(states, i, u.chunk(2)[k], x.chunk(2)[k])
    pred, std = predict(states, tt(BETAS))
    torch.cuda.synchronize()
    want = {**dict.fromkeys(mc.LAUNCHES, 0), "K1": 4, "K3": 4, "head_shift": 8, "finalize": 8}
    assert mc.LAUNCHES == want
    assert pred.is_cuda and std.is_cuda and pred.dtype == torch.float64
    assert_close(pred, InterpModel([m for _, _, m in sims]).predict(tt(BETAS)), 1e-6, 1e-9)
    assert bool(torch.isfinite(std).all()) and bool((std > 0).all())
    assert not torch.equal(states[0][1].wsum, states[1][1].wsum)


def test_checkpoint_restores_onto_the_card(rng, cuda_device, tmp_path, monkeypatch):
    """A streaming state saved from the card restores onto it (the template's
    device) and resumes to the uninterrupted result exactly; the npz
    checkpoint loads onto the card too."""
    from thermoextrap_tpu_torch.data import DataCentralMoments
    from thermoextrap_tpu_torch.utils import checkpoint as ck
    from thermoextrap_tpu_torch.utils import device as tdevice

    u, x = _samples(rng, 90_000, 1)
    uc, xc = _f32(u, cuda_device), _f32(x, cuda_device)
    state0, update, predict = tpipe.make_streaming_extrap_pipeline(4, 1.0, val_shape=(1,), nrep=16, seed=3, device=cuda_device)
    full = state0
    for a, b in zip(uc.chunk(3), xc.chunk(3)):
        full = update(full, a, b)
    ck.save_pytree(tmp_path / "mid", update(state0, uc.chunk(3)[0], xc.chunk(3)[0]))
    resumed = ck.restore_pytree(tmp_path / "mid", state0)
    assert resumed[0].dxdu.is_cuda and resumed[2] == 1
    for a, b in zip(uc.chunk(3)[1:], xc.chunk(3)[1:]):
        resumed = update(resumed, a, b)
    for a, b in zip(predict(resumed, tt(BETAS)), predict(full, tt(BETAS))):
        assert torch.equal(a, b)
    full[0].save(tmp_path / "mean")
    # load goes to the default device, which the parity helper pins to the CPU
    monkeypatch.setattr(tdevice, "_DEVICE", cuda_device)
    back = DataCentralMoments.load(tmp_path / "mean")
    assert back.dxdu.is_cuda and torch.equal(back.dxdu, full[0].dxdu)


def test_bucketed_runner_on_gpu_pads_on_the_card(rng, cuda_device, monkeypatch):
    """A padded request stays on the card (no host copy), launches one K1
    and one K3 (K4 and K5 with x_is_u), and gives the unpadded call's mean
    to float32 roundoff."""
    r = 100_003
    u, x = _samples(rng, r, 1)
    uc, xc = _f32(u, cuda_device), _f32(x, cuda_device)
    serve = tpipe.make_bucketed_extrap_runner(4, 1.0, nrep=32)
    up, xp, wp = tpipe.bucket_pad(uc, xc, None, serve.buckets)
    assert up.is_cuda and up.shape == (1 << 17,) and wp.dtype == torch.float32 and float(wp[r:].sum()) == 0.0
    monkeypatch.setattr(torch.Tensor, "numpy", lambda *a: pytest.fail("a padded request went through host numpy"))
    mc.reset_launches()
    pred, std = serve(uc, xc, tt(BETAS), seed=5)
    torch.cuda.synchronize()
    assert mc.LAUNCHES["K1"] == 1 and mc.LAUNCHES["K3"] == 1
    monkeypatch.undo()
    assert_close(pred, tpipe.make_extrap_pipeline(4, 1.0)(uc, xc, tt(BETAS)), 1e-6, 1e-9)
    assert bool((std > 0).all())
    serve_u = tpipe.make_bucketed_extrap_runner(4, 1.0, x_is_u=True, nrep=32)
    mc.reset_launches()
    pred_u, _ = serve_u(uc, tt(BETAS))
    torch.cuda.synchronize()
    assert mc.LAUNCHES["K4"] == 1 and mc.LAUNCHES["K5"] == 1
    assert_close(pred_u, tpipe.make_extrap_pipeline(4, 1.0, x_is_u=True)(uc, tt(BETAS)), 1e-6, 1e-9)


# -- MBAR and the ingest runtime on the card ---------------------------------------------------


def test_mbar_on_gpu_matches_cpu(cuda_device):
    """MBAR on CUDA float32 tensors returns CUDA tensors and equals the CPU
    float64 port at float32 bars: free energies to 1e-4, expectations and
    overlap rows to 1e-4 relative, the bootstrap's mean to its own sigma."""
    from thermoextrap_tpu_torch.models import mbar as tm

    rng = np.random.default_rng(3)
    sig = np.array([1.0, 1.5, 2.2])
    xs = np.concatenate([rng.normal(0.0, s, 100_000) for s in sig])
    u_kn, n_k = xs[None] ** 2 / (2 * sig[:, None] ** 2), np.full(3, 100_000.0)
    u_t = xs[None] ** 2 / (2 * np.array([1.2, 1.9])[:, None] ** 2)
    x_n = np.stack([xs, xs**2], axis=1)
    uc, utc, xc = (_f32(a, cuda_device) for a in (u_kn, u_t, x_n))
    f, it, res = tm.mbar_solve_info(uc, n_k)
    f64 = tm.mbar_solve(tt(u_kn), n_k)
    assert f.is_cuda and res.is_cuda and f.dtype == torch.float32 and float(res) <= 1e-5 and isinstance(it, int)
    assert_close(f, f64, 0.0, 1e-4)
    grid = tm.mbar_expectations_grid(uc, n_k, f, utc, xc)
    assert grid.is_cuda
    assert_close(grid, tm.mbar_expectations_grid(tt(u_kn), n_k, f64, tt(u_t), tt(x_n)), 1e-4, 1e-5)
    alphas = tm.mbar_expectations_alphas(uc, n_k, f, [1 / 1.2**2, 1 / 1.9**2], _f32(xs**2 / 2, cuda_device), xc, chunk=1)
    assert_close(alphas, grid, 1e-5, 1e-6)
    o = tm.mbar_overlap(uc, n_k, f)
    assert o.is_cuda and bool((o.sum(dim=1) - 1).abs().max() < 1e-4)
    theta = tm.mbar_covariance(uc, n_k, f)
    assert theta.is_cuda and theta.dtype == torch.float64
    dfe = tm.mbar_fe_uncertainties(theta)
    assert np.isfinite(dfe).all() and np.all(np.diag(dfe) == 0)
    mean, std = tm.mbar_bootstrap_expectations(uc, n_k, utc, xc, nrep=8, rng=5, rep_chunk=4)
    assert mean.is_cuda and bool((std > 0).all()) and bool(((mean - grid).abs() <= 4 * std).all())
    again = tm.mbar_bootstrap_expectations(uc, n_k, utc, xc, nrep=8, rng=5, rep_chunk=3)
    assert torch.equal(mean, again[0]) and torch.equal(std, again[1])
    g = tm.statistical_inefficiency(_f32(xs, cuda_device))
    assert g.is_cuda and abs(float(g) - float(tm.statistical_inefficiency(xs))) < 1e-3 * float(g)


def test_mbar_model_on_gpu(cuda_device):
    from thermoextrap_tpu_torch import DataValues
    from thermoextrap_tpu_torch import beta as tbeta
    from thermoextrap_tpu_torch import idealgas as tideal
    from thermoextrap_tpu_torch.models.extrap import MBARModel

    states, states64 = [], []
    for i, b in enumerate((0.8, 1.2)):
        x, u = tideal.generate_data((50_000, 10), b, rng=torch.Generator(device=cuda_device).manual_seed(i), dtype=torch.float32)
        states.append(tbeta.factory_extrapmodel(b, DataValues.from_vals(x, u, order=0), order=0))
        states64.append(tbeta.factory_extrapmodel(b, DataValues.from_vals(x.double().cpu(), u.double().cpu(), order=0), order=0))
    pred = MBARModel(states).predict(tt(BETAS))
    assert pred.is_cuda and pred.dtype == torch.float32
    mean, std = MBARModel(states).predict_ci(tt(BETAS), nrep=8, seed=1)
    assert mean.is_cuda and bool((std > 0).all())
    assert bool(((pred.double().cpu() - MBARModel(states64).predict(tt(BETAS))).abs() <= 0.1 * std.double().cpu()).all())


def test_prefetch_stages_on_a_side_stream(cuda_device):
    """Chunks staged onto the card by the worker's stream equal their source
    after a deliberately slow consumer: each chunk is read behind a long
    kernel on the consumer's stream, so a missing wait would read it before
    its copy landed and a missing ``record_stream`` would let a later copy
    reuse its memory while it is still to be read."""
    from thermoextrap_tpu_torch import io_stream

    sources = [np.full(1 << 20, float(i), dtype=np.float32) + np.arange(1 << 20, dtype=np.float32) for i in range(8)]
    seen = []
    for i, (a, b) in enumerate(io_stream.prefetch_chunks(sources, load=lambda s: (s, s[:1000] * 2), depth=2, device=cuda_device)):
        assert a.is_cuda and b.is_cuda
        torch.cuda._sleep(20_000_000)  # the consumer's stream is busy while the worker copies on
        seen.append((a * 1.0, b.clone()))
        del a, b
        if i % 2:
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    for (a, b), s in zip(seen, sources):
        assert np.array_equal(npy(a), s) and np.array_equal(npy(b), s[:1000] * 2)


def test_file_fed_stream_on_gpu_launches_and_equals_in_memory(cuda_device, tmp_path):
    """``.npy`` chunks through ``read_npy_chunks(device=card)`` and
    ``ingest_stream`` launch one K1 and one K3 per chunk and give the
    in-memory stream's state exactly, also with ``fan_in=2``."""
    from thermoextrap_tpu_torch import io_stream

    rng = np.random.default_rng(11)
    u, x = _samples(rng, 300_000, 1)
    table = np.stack([u, x[:, 0]], axis=1).astype(np.float32)
    paths = []
    for k, part in enumerate(np.split(table, 3)):
        paths.append(tmp_path / f"c{k}.npy")
        np.save(paths[-1], part)
    state0, update, predict = tpipe.make_streaming_extrap_pipeline(4, 1.0, nrep=16, seed=3, device=cuda_device)
    mc.reset_launches()
    state = io_stream.ingest_stream(update, state0, io_stream.read_npy_chunks(paths, columns=(0, 1), device=cuda_device))
    torch.cuda.synchronize()
    want = {**dict.fromkeys(mc.LAUNCHES, 0), "K1": 3, "K3": 3, "head_shift": 6, "finalize": 6}
    assert mc.LAUNCHES == want
    mem = state0
    for part in np.split(table, 3):
        mem = update(mem, _f32(part[:, 0], cuda_device), _f32(part[:, 1], cuda_device))
    fan = io_stream.ingest_stream(update, state0, io_stream.read_npy_chunks(paths, columns=(0, 1), device=cuda_device), fan_in=2)
    for got in (state, fan):
        for a, b in zip(predict(got, tt(BETAS)), predict(mem, tt(BETAS))):
            assert torch.equal(a, b)


def test_native_engine_refuses_card_tensors(cuda_device):
    """The host engine raises on a CUDA tensor; under ``set_impl("native")``
    a CUDA tensor keeps its kernel route (K1)."""
    from thermoextrap_tpu_torch import native
    from thermoextrap_tpu_torch.ops import dispatch

    u = torch.linspace(0, 1, 1000, device=cuda_device)
    with pytest.raises(ValueError, match="cuda"):
        native.reduce_central_comoments(u, u[:, None], 3)
    mc.reset_launches()
    with dispatch.use_impl("native"):
        out = dispatch.reduce_central(u, u[:, None], 3)
    torch.cuda.synchronize()
    assert out[0].is_cuda and mc.LAUNCHES["K1"] == 1


# -- the derivative GPR on the card ----------------------------------------------------


def _gpr_sine_data():
    """Noisy sine and derivative data (tests/test_gps.py:256-282's shape)."""
    rng = np.random.default_rng(0)
    xs = np.linspace(0.0, 2.0 * np.pi, 8)
    X = np.concatenate([np.stack([xs, np.zeros(8)], axis=1), np.stack([xs, np.ones(8)], axis=1)])
    Y = np.concatenate([np.sin(xs) + rng.normal(0, 0.02, 8), np.cos(xs) + rng.normal(0, 0.05, 8)])[:, None]
    cov = np.diag(np.concatenate([np.full(8, 0.02**2), np.full(8, 0.05**2)]))
    return X, Y, cov


def test_gpr_on_the_card_matches_the_cpu(cuda_device, monkeypatch):
    """The GPR core runs on the card in float64 (the default device) and
    agrees with the same model under ``host_f64``: the LML and its gradient,
    and ``predict_f``, to 1e-8 of their largest entry (the gradient against
    the value's magnitude as well, since it vanishes at the optimum); the
    two fits' NLL to 1e-6 relative."""
    from thermoextrap_tpu_torch.gpr_active import gp_models, kernels
    from thermoextrap_tpu_torch.utils import device as tdevice
    from thermoextrap_tpu_torch.utils.compute import host_f64

    monkeypatch.setattr(tdevice, "_DEVICE", cuda_device)
    data = _gpr_sine_data()
    card = gp_models.HeteroscedasticGPR(data, kernel=kernels.RBFDerivKernel(), likelihood_kwargs={"p": 1.0})
    res = card.train()
    with host_f64():
        cpu = gp_models.HeteroscedasticGPR(data, kernel=kernels.RBFDerivKernel(), likelihood_kwargs={"p": 1.0})
        cpu_res = cpu.train()
        cpu.set_parameters(card.parameters())
        cval, cgrad = cpu._lml_fns()["neg_vag"](torch.as_tensor(res.x), *cpu._bound_args())
        cmean, cvar = cpu.predict_f(data[0])
    assert res.fun == pytest.approx(cpu_res.fun, rel=1e-6)
    val, grad = card._lml_fns()["neg_vag"](torch.as_tensor(res.x), *card._bound_args())
    mean, var = card.predict_f(data[0])
    assert val.is_cuda and mean.is_cuda and mean.dtype == torch.float64
    assert abs(float(val) - float(cval)) <= 1e-8 * abs(float(cval))
    assert float((grad.cpu() - cgrad).abs().max()) <= 1e-8 * max(float(cgrad.abs().max()), abs(float(cval)))
    assert float((mean.cpu() - cmean).abs().max()) <= 1e-8 * float(cmean.abs().max())
    assert float((var.cpu() - cvar).abs().max()) <= 1e-8 * card.parameters()["kernel/var"]


def test_gpr_staging_launches_k1_and_k2(cuda_device, monkeypatch):
    """An ideal-gas state made on the card reduces through K1 and its
    bootstrap through K2, once each, in ``input_GP_from_state``."""
    from thermoextrap_tpu_torch.gpr_active import active_utils, ig_active
    from thermoextrap_tpu_torch.utils import device as tdevice

    monkeypatch.setattr(tdevice, "_DEVICE", cuda_device)
    state = ig_active.extrap_IG(1.2, rng=3, nconfig=20_000, npart=100)
    assert state.data.uv.is_cuda
    mc.reset_launches()
    x, y, cov = active_utils.input_GP_from_state(state, n_rep=50)
    torch.cuda.synchronize()
    want = {**dict.fromkeys(mc.LAUNCHES, 0), "K1": 1, "K2": 1, "head_shift": 2, "finalize": 2}
    assert mc.LAUNCHES == want
    assert y.shape == (4, 1) and cov.shape == (1, 4, 4) and np.all(np.isfinite(cov))


# -- the active-learning half of the GPR on the card ---------------------------------------


def test_active_loop_on_the_card(cuda_device, monkeypatch, tmp_path):
    """The reference's loop at phase 26's grid, start and order (two
    iterations, smaller states): K1 = K2 = the states of each fit summed,
    no other kernel; the final fit rebuilt on the CPU from its staged inputs
    agrees to 1e-8; ALC and ``ErrorStability`` on the card equal the CPU's
    (the same beta; the metric to 1e-5: its KL terms nearly cancel, so it
    magnifies the two devices' rounding of the posterior covariance)."""
    from scipy import linalg

    from thermoextrap_tpu_torch.gpr_active import active_utils, ig_active
    from thermoextrap_tpu_torch.utils import device as tdevice
    from thermoextrap_tpu_torch.utils.compute import host_f64

    monkeypatch.setattr(tdevice, "_DEVICE", cuda_device)
    fits, staged = [], []
    real_create, real_stage = active_utils.create_GPR, active_utils.input_GP_from_state

    def create(states, **kw):
        fits.append(len(states))
        return real_create(states, **kw)

    def stage(*a, **k):
        staged.append(real_stage(*a, **k))
        return staged[-1]

    monkeypatch.setattr(active_utils, "create_GPR", create)
    monkeypatch.setattr(active_utils, "input_GP_from_state", stage)
    stop = active_utils.StopCriteria([active_utils.MaxRelGlobalVar(tol=1e-12), active_utils.MaxIter()], n_grid=1000)
    mc.reset_launches()
    data_list, hist = active_utils.active_learning(
        [0.5, 2.5],
        ig_active.SimulateIG(nconfig=2_000, npart=200),
        active_utils.UpdateALMbrute(rng=0, n_grid=1000),
        base_dir=str(tmp_path),
        stop_criteria=stop,
        max_iter=2,
        max_order=3,
    )
    torch.cuda.synchronize()
    n = sum(fits)
    assert fits[0] == 2 and fits[-1] == len(data_list) and len(fits) == len(hist["loss"]) == 3
    assert mc.LAUNCHES == {**dict.fromkeys(mc.LAUNCHES, 0), "K1": n, "K2": n, "head_shift": 2 * n, "finalize": 2 * n}
    assert all(type(v) is float for v in hist["loss"])

    last = staged[-fits[-1] :]
    x = np.vstack([d[0] for d in last])
    y = np.vstack([d[1] for d in last])
    cov = np.array([linalg.block_diag(*[d[2][0] for d in last])])
    card = active_utils.create_base_GP_model((x, y, cov))
    card.set_parameters(hist["params"][-1])
    grid = np.column_stack([np.linspace(0.5, 2.5, 1000), np.zeros(1000)])
    mean, var = card.predict_f(grid)
    assert mean.is_cuda and mean.dtype == torch.float64
    betas = [d.beta for d in data_list]
    alc = active_utils.UpdateALCbrute(n_candidates=20, n_grid=1000)(card, betas)
    estab = active_utils.ErrorStability(tol=0.1)
    estab.calc_metric(None, None, card)
    with host_f64():
        cpu = active_utils.create_base_GP_model((x, y, cov))
        cpu.set_parameters(hist["params"][-1])
        cmean, cvar = cpu.predict_f(grid)
        assert abs(float(card.log_marginal_likelihood()) - float(cpu.log_marginal_likelihood())) <= 1e-8 * abs(float(cpu.log_marginal_likelihood()))
        assert alc[0] == active_utils.UpdateALCbrute(n_candidates=20, n_grid=1000)(cpu, betas)[0]
        assert abs(float(estab.calc_metric(None, None, cpu)) - 1.0) <= 1e-5
    assert float(((mean.cpu() - cmean).abs() / torch.maximum(cmean.abs(), cvar.sqrt())).max()) <= 1e-8


def test_freeze_predictor_on_the_card(cuda_device, monkeypatch):
    """The freeze runs in float64 on the card; float32 serving holds the
    bars of tests/test_gpr_serving.py:64-92 against ``predict_f`` there, and
    a float64 freeze equals it to 1e-12 of the largest entry."""
    from thermoextrap_tpu_torch.gpr_active import gp_models, kernels, serving
    from thermoextrap_tpu_torch.utils import device as tdevice

    monkeypatch.setattr(tdevice, "_DEVICE", cuda_device)
    X, Y, cov = _gpr_sine_data()
    model = gp_models.HeteroscedasticGPR((X, Y, cov), kernel=kernels.RBFDerivKernel(), likelihood_kwargs={"p": 1.0})
    model.train()
    xt = np.linspace(0.5, 5.5, 1000)
    mean_ref, var_ref = model.predict_f(np.stack([xt, np.zeros_like(xt)], 1))
    mean, var = serving.freeze_predictor(model)(xt)
    assert mean.is_cuda and mean.dtype == torch.float32 and bool((var >= 0).all())
    kvar = model.parameters()["kernel/var"]
    assert bool(((mean.double() - mean_ref).abs() <= 3e-5 + 3e-4 * mean_ref.abs()).all())
    assert bool(((var.double() - var_ref).abs() <= 5e-6 * kvar + 3e-3 * var_ref.abs()).all())
    mean64, var64 = serving.freeze_predictor(model, dtype=torch.float64)(torch.tensor(xt, device=cuda_device))
    assert float((mean64 - mean_ref).abs().max()) <= 1e-12 * float(mean_ref.abs().max())
    assert float((var64 - var_ref).abs().max()) <= 1e-12 * kvar


def test_fully_heteroscedastic_gpr_on_the_card(cuda_device, monkeypatch):
    """``FullyHeteroscedasticGPR`` on ``sine_active.make_data`` data (14
    points, drawn on the card) fits on the card, and its LML and
    predictions equal the CPU model's at its parameters to 1e-8."""
    from thermoextrap_tpu_torch.gpr_active import experimental, sine_active
    from thermoextrap_tpu_torch.utils import device as tdevice
    from thermoextrap_tpu_torch.utils.compute import host_f64

    monkeypatch.setattr(tdevice, "_DEVICE", cuda_device)
    xs, ys, yerr = sine_active.make_data(np.linspace(0.0, 3.0, 14), max_order=0, rng=3)
    data = (xs[:, :1], np.hstack([ys, yerr, np.full_like(ys, 100.0)]))

    def model():
        return experimental.FullyHeteroscedasticGPR(data, experimental.StationaryKernel(1, "rbf"))

    card = model()
    res = card.train(max_iter=120)
    xnew = np.linspace(0.0, 3.0, 50)[:, None]
    got = [card.log_marginal_likelihood(), *card.predict_f(xnew), *card.predict_noise(xnew)]
    assert np.isfinite(res.fun) and all(g.is_cuda for g in got)
    with host_f64():
        cpu = model()
        cpu.set_parameters(card.parameters())
        ref = [cpu.log_marginal_likelihood(), *cpu.predict_f(xnew), *cpu.predict_noise(xnew)]
    for g, r in zip(got, ref):
        assert float((g.cpu() - r).abs().max()) <= 1e-8 * float(r.abs().max())


@pytest.fixture(scope="module")
def card_mesh():
    """A world of one NCCL rank on the card, 2-D ``(rep, rec)``; the process
    group ends with the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    import torch.distributed as dist

    from thermoextrap_tpu_torch.parallel import make_mesh

    mesh = make_mesh(1, ("rep", "rec"), device="cuda")
    yield mesh
    dist.destroy_process_group()


def test_mesh_pipelines_on_the_card(rng, cuda_device, card_mesh):
    """The mesh= route on a world of one NCCL rank: no kernel launch, the
    unsharded call's prediction (K1 / K4) at the float32 bar, the bootstrap
    on the card's count table equal to the plain bootstrap of that table,
    and the perturbation route equal to its unsharded table mode."""
    from thermoextrap_tpu_torch.ops import resample
    from thermoextrap_tpu_torch.parallel import reduce_central_comoments_sharded, resample_central_comoments_sharded, shard_rec

    u, x = _samples(rng, 200_000, 2)
    uc, xc = _f32(u, cuda_device), _f32(x, cuda_device)
    mc.reset_launches()
    pred, std = tpipe.make_extrap_pipeline(4, 5.0, nrep=32, mesh=card_mesh)(shard_rec(uc, card_mesh), xc, BETAS + 4.0, seed=3)
    upred, ustd = tpipe.make_extrap_pipeline(4, 5.0, x_is_u=True, nrep=32, mesh=card_mesh)(uc, BETAS + 4.0, seed=3)
    moments = reduce_central_comoments_sharded(uc, xc, 4, card_mesh)
    torch.cuda.synchronize()
    assert not any(mc.LAUNCHES.values()), mc.LAUNCHES
    assert pred.is_cuda and bool((std > 0).all()) and bool((ustd > 0).all())
    assert_close(pred, tpipe.make_extrap_pipeline(4, 5.0)(uc, xc, BETAS + 4.0), 1e-5, 1e-6)
    assert_close(upred, tpipe.make_extrap_pipeline(4, 5.0, x_is_u=True)(uc, BETAS + 4.0), 1e-5, 1e-6)
    assert_close(moments, mc.reduce_central_comoments_fused(tt(u), tt(x), 4), RTOL32, ATOL32)
    table = tpipe._multinomial_freq(3, 32, 200_000, cuda_device)
    got = [t.full_tensor() for t in resample_central_comoments_sharded(uc, xc, table, 4, card_mesh)]
    assert_close(got, resample.resample_central_comoments(uc.double(), xc.double(), table, 4), RTOL32, ATOL32)


def test_mbar_sharded_on_the_card(cuda_device, card_mesh):
    """Sharded MBAR on the world of one NCCL rank (N = 300003, not a
    multiple of anything) equals the unsharded calls on the card."""
    from thermoextrap_tpu_torch.models import mbar as tm
    from thermoextrap_tpu_torch.parallel import mbar_expectations_grid_sharded, mbar_solve_sharded

    rng = np.random.default_rng(4)
    sig = np.array([1.0, 1.5, 2.2])
    xs = np.concatenate([rng.normal(0.0, s, 100_001) for s in sig])
    uc = _f32(xs[None] ** 2 / (2 * sig[:, None] ** 2), cuda_device)
    n_k = np.full(3, 100_001.0)
    f, it, res = mbar_solve_sharded(uc, n_k, card_mesh)
    f1, it1, _ = tm.mbar_solve_info(uc, n_k)
    assert f.is_cuda and float(res) <= 1e-5
    assert_close(f, f1, 0.0, 1e-5)
    utc = _f32(xs[None] ** 2 / (2 * np.array([1.2, 1.9])[:, None] ** 2), cuda_device)
    xc = _f32(np.stack([xs, xs**2], axis=1), cuda_device)
    assert_close(mbar_expectations_grid_sharded(uc, n_k, f, utc, xc, card_mesh), tm.mbar_expectations_grid(uc, n_k, f, utc, xc), 1e-5, 1e-6)


def test_grid_sharded_on_the_card(rng, cuda_device, card_mesh):
    """The sharded batched u-moment reduction and grid bootstrap on the world of
    one NCCL rank (the bootstrap's ``einsum`` sums are not contiguous, which
    NCCL's all-reduce refuses) equal the plain functions on the same table."""
    from thermoextrap_tpu_torch.ops import moments, resample
    from thermoextrap_tpu_torch.parallel import reduce_central_umoments_batched_sharded, resample_central_umoments_batched_sharded

    uvg = torch.as_tensor(rng.normal(0.0, 1.0, (6, 50_000)) + np.linspace(-1, 1, 6)[:, None], device=cuda_device)
    table = tpipe._multinomial_freq(5, 32, 50_000, cuda_device)
    mc.reset_launches()
    grid = reduce_central_umoments_batched_sharded(uvg, 6, card_mesh)
    boot = [t.full_tensor() for t in resample_central_umoments_batched_sharded(uvg, table, 6, card_mesh)]
    torch.cuda.synchronize()
    assert not any(mc.LAUNCHES.values()), mc.LAUNCHES
    assert_close(grid, moments.reduce_central_umoments(uvg, 6), 1e-10, 1e-12)
    assert_close(boot, resample.resample_central_umoments_batched(uvg, table, 6), 1e-10, 1e-12)
