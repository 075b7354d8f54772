"""The CUDA kernels of the torch port against their plain torch versions, on
a GPU.  Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is False.

This file imports neither jax nor the JAX package, so it also runs on a
machine without them (``tests/conftest.py`` does import jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the float32 kernels against the float64 plain versions at the
bar of tests/test_parallel.py:87 (rtol 2e-3, atol 1e-5); K3 against K2 on
the same count table, which share one kernel body, at float32 roundoff.
"""

import numpy as np
import pytest
import torch
from _torch_parity import assert_close, cuda_device, npy, tt  # noqa: F401

from thermoextrap_tpu_torch import pipeline as tpipe
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
    assert_close(k3[:4], k2, 1e-6, 1e-9)
    assert_close(k3, mc.resample_central_comoments_poisson(tt(u), tt(x), nrep, 6, seed=7, return_wsum=True), RTOL32, ATOL32)


def test_kernel_rejects_grad(rng, cuda_device):
    u, x = _samples(rng, 1000, 1)
    tu = _f32(u, cuda_device).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="forward only"):
        mc.reduce_central_comoments_fused(tu, _f32(x, cuda_device), 4)
    with pytest.raises(ValueError, match="but xv on cpu"):
        mc.reduce_central_comoments_fused(_f32(u, cuda_device), tt(x), 4)


def test_pipeline_on_gpu_matches_cpu(rng, cuda_device):
    """The pipeline runs K1 then K3 on CUDA input and agrees with the
    float64 CPU path to a tenth of its bootstrap error; a numpy weight works;
    x_is_u on the GPU raises, naming the kernels it needs."""
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
    with pytest.raises(NotImplementedError, match="K4"):
        tpipe.make_extrap_pipeline(6, 1.0, x_is_u=True)(tt(u).to(cuda_device), tt(BETAS))
