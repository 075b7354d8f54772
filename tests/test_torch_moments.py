"""K1 / K6 (the shifted single-pass reduction) and the two-pass reduction of
the torch port against the JAX package.

- float64: the port's two-pass path and the plain versions of K1 / K6
  against ``thermoextrap_tpu.ops.moments.reduce_central_comoments`` at
  rtol 1e-10 (central moments are shift invariant, so the shifted single
  pass is exact up to roundoff);
- float32: the plain versions against the JAX Pallas kernels in interpret
  mode at the bar of tests/test_parallel.py (rtol 2e-3, atol 1e-5);
"""

import numpy as np
import pytest
import torch
from _torch_parity import assert_close, npy, tt

from thermoextrap_tpu.ops import moments as jm
from thermoextrap_tpu.ops.moments_pallas import (
    reduce_central_comoments_batched as j_batched,
)
from thermoextrap_tpu.ops.moments_pallas import (
    reduce_central_comoments_fused as j_fused,
)
from thermoextrap_tpu_torch.models import mbar
from thermoextrap_tpu_torch.ops import _build, dispatch, moments_cuda as mc
from thermoextrap_tpu_torch.ops import moments as tm

RTOL64 = 1e-10
ATOL64 = 1e-12
RTOL32, ATOL32 = 2e-3, 1e-5  # tests/test_parallel.py:87


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _samples(rng, r, v, batch=()):
    u = rng.normal(5.0, 1.0, batch + (r,))
    x = 2.0 + 0.3 * (u[..., None] - 5.0) + rng.normal(0.0, 0.5, batch + (r, v))
    return u, x


# -- float64 parity --------------------------------------------------------------


@pytest.mark.parametrize(
    ("r", "v", "weighted"),
    [(1000, 1, False), (1000 + 37, 2, True), (9000, 1, True), (127, 3, False)],
)
def test_k1_plain_matches_jax_f64(rng, r, v, weighted):
    """K1's plain version, the dispatch CPU path and the two-pass port all
    equal the JAX two-pass reduction (R not divisible by 128 included)."""
    u, x = _samples(rng, r, v)
    w = rng.uniform(0.5, 1.5, r) if weighted else None
    ref = jm.reduce_central_comoments(u, x, 6, weight=w)
    tw = None if w is None else tt(w)
    assert_close(mc.reduce_central_comoments_fused(tt(u), tt(x), 6, tw), ref, RTOL64, ATOL64)
    assert_close(tm.reduce_central_comoments(tt(u), tt(x), 6, weight=tw), ref, RTOL64, ATOL64)
    assert_close(dispatch.reduce_central(tt(u), tt(x), 6, weight=tw), ref, RTOL64, ATOL64)


def test_k1_plain_val_shape_and_scalar_x(rng):
    u, x = _samples(rng, 500, 6)
    x = x.reshape(500, 2, 3)
    ref = jm.reduce_central_comoments(u, x, 4, val_ndim=2)
    assert_close(mc.reduce_central_comoments_fused(tt(u), tt(x), 4), ref, RTOL64, ATOL64)
    ref0 = jm.reduce_central_comoments(u, x[:, 0, 0], 4, val_ndim=0)
    assert_close(mc.reduce_central_comoments_fused(tt(u), tt(x[:, 0, 0]), 4), ref0, RTOL64, ATOL64)


@pytest.mark.parametrize(("batch", "v", "weighted"), [((4,), 1, False), ((2, 3), 2, True)])
def test_k6_plain_matches_jax_f64(rng, batch, v, weighted):
    u, x = _samples(rng, 700, v, batch)
    w = rng.uniform(0.5, 1.5, batch + (700,)) if weighted else None
    ref = jm.reduce_central_comoments(u, x, 5, weight=w)
    tw = None if w is None else tt(w)
    assert_close(mc.reduce_central_comoments_batched(tt(u), tt(x), 5, tw), ref, RTOL64, ATOL64)
    assert_close(dispatch.reduce_central(tt(u), tt(x), 5, weight=tw), ref, RTOL64, ATOL64)


def test_zero_weight_head_no_nan(rng):
    """A zero-weight prefix longer than the 8192-sample shift head falls
    back to shift 0 and stays exact (tests/test_parallel.py:917)."""
    r = 10_000
    u, x = _samples(rng, r, 1)
    w = np.zeros(r)
    w[9_000:] = 1.0
    ref = jm.reduce_central_comoments(u, x, 4, weight=w)
    got = mc.reduce_central_comoments_fused(tt(u), tt(x), 4, tt(w))
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert_close(got, ref, RTOL64, ATOL64)
    s_u, s_x = mc._head_shift(tt(u)[None], tt(w)[None], tt(x)[None])
    assert float(s_u[0]) == 0.0 and float(s_x[0, 0]) == 0.0


def test_raw_reduction_matches_jax(rng):
    u, x = _samples(rng, 400, 2, (3,))
    w = rng.uniform(0.5, 1.5, (3, 400))
    ref = jm.reduce_raw_comoments(u, x, 5, weight=w)
    assert_close(tm.reduce_raw_comoments(tt(u), tt(x), 5, weight=tt(w)), ref, RTOL64, ATOL64)
    assert_close(dispatch.reduce_raw(tt(u), tt(x), 5, weight=tt(w)), ref, RTOL64, ATOL64)
    assert_close(tm.u_power_stack(tt(u), 4), jm.u_power_stack(u, 4), RTOL64)


# -- float32 against the Pallas kernels in interpret mode ------------------------


@pytest.mark.parametrize(("r", "v", "weighted"), [(1000, 2, False), (4000 + 5, 1, True)])
def test_k1_plain_matches_pallas_interpret_f32(rng, r, v, weighted):
    u, x = _samples(rng, r, v)
    u, x = u.astype(np.float32), x.astype(np.float32)
    w = rng.uniform(0.5, 1.5, r).astype(np.float32) if weighted else None
    ref = j_fused(u, x, 6, weight=w, interpret=True)
    got = mc.reduce_central_comoments_fused(tt(u), tt(x), 6, None if w is None else tt(w))
    assert all(g.dtype == torch.float32 for g in got)
    assert_close(got, ref, RTOL32, ATOL32)


def test_k6_plain_matches_pallas_interpret_f32(rng):
    u, x = _samples(rng, 1029, 1, (2,))
    u, x = u.astype(np.float32), x.astype(np.float32)
    ref = j_batched(u, x, 4, interpret=True)
    assert_close(mc.reduce_central_comoments_batched(tt(u), tt(x), 4), ref, RTOL32, ATOL32)


def test_bf16_streams_and_mixed_dtype_error(rng):
    """bf16 is an explicit opt-in for both streams: the plain version
    computes in f32 on the quantized data; one bf16 stream alone raises."""
    u, x = _samples(rng, 2000, 1)
    ub = tt(u).to(torch.bfloat16)
    xb = tt(x).to(torch.bfloat16)
    ref = jm.reduce_central_comoments(npy(ub), npy(xb), 6)
    assert_close(mc.reduce_central_comoments_fused(ub, xb, 6), ref, RTOL32, 2e-5)
    with pytest.raises(ValueError, match="mixed input dtypes"):
        mc.reduce_central_comoments_fused(ub, tt(x, torch.float32), 6)
    with pytest.raises(ValueError, match="mixed input dtypes"):
        mc.reduce_central_comoments_batched(tt(u)[None], xb[None], 6)


# -- dispatch, launch counts, autograd and the build ------------------------------


def test_wrappers_reject_bad_inputs(rng):
    """Mismatched sample axes or devices raise before any reshape or launch;
    only tensors that require grad are refused as kernel inputs."""
    u, x = _samples(rng, 300, 1)
    with pytest.raises(ValueError, match="does not lead"):
        mc.reduce_central_comoments_fused(tt(u), tt(x)[:299], 3)
    with pytest.raises(ValueError, match="does not lead"):
        mc.reduce_central_comoments_batched(tt(u).reshape(3, 100), tt(x).reshape(100, 3, 1), 3)
    with pytest.raises(ValueError, match="but xv on meta"):
        mc.resample_central_comoments_poisson(tt(u), torch.empty(300, 1, device="meta"), 4, 3)
    with pytest.raises(ValueError, match="cuda or cpu"):
        mc.reduce_central_comoments_fused(torch.empty(300, device="meta"), torch.empty(300, 1, device="meta"), 3)
    mc._check_cuda_inputs(tt(u), np.ones(3), None)
    with pytest.raises(NotImplementedError, match="forward only"):
        mc._check_cuda_inputs(tt(u), tt(x).requires_grad_(True))


def test_cpu_path_launches_no_kernel(rng):
    u, x = _samples(rng, 300, 1)
    mc.reset_launches()
    mc.reduce_central_comoments_fused(tt(u), tt(x), 3)
    mc.reduce_central_comoments_batched(tt(u)[None], tt(x)[None], 3)
    dispatch.reduce_central(tt(u), tt(x), 3)
    mc.reduce_central_umoments_batched(tt(u), 3)
    mc.resample_central_umoments_batched_poisson(tt(u)[None], 4, 3)
    mc.resample_perturb_freq(torch.ones(2, 300), tt(x).float(), torch.ones(4, 300))
    mc.resample_perturb_poisson(torch.ones(2, 300), tt(x).float(), 4)
    mc.resample_central_comoments_fused(tt(u), tt(x), torch.ones(4, 300), 3)
    mc.resample_central_comoments_poisson(tt(u), tt(x), 4, 3)
    mbar.mbar_expectations_alphas(np.stack([u, 2 * u]), [150, 150], [0.0, 0.5], [1.0, 1.5], u, x)
    mbar.mbar_solve(np.stack([u, 2 * u]), [150, 150])
    assert mc.LAUNCHES == {
        **{f"K{i}": 0 for i in range(1, 9)},
        "head_shift": 0,
        "finalize": 0,
        "finalize_u": 0,
        "comoment_mma": 0,
        "mbar_alphas": 0,
        "mbar_solve": 0,
    }


def test_dispatch_impl_control(rng):
    u, x = _samples(rng, 300, 1)
    ref = jm.reduce_central_comoments(u, x, 3)
    with dispatch.use_impl("cuda"):  # kernel wrappers: plain versions on CPU
        assert_close(dispatch.reduce_central(tt(u), tt(x), 3), ref, RTOL64, ATOL64)
        with dispatch.use_impl("torch"):
            assert dispatch._FORCE == "torch"
        assert dispatch._FORCE == "cuda"
    assert dispatch._FORCE is None
    with pytest.raises(ValueError, match="impl must be"):
        dispatch.set_impl("pallas")
    # x_is_u on CPU: comoments of (u, u) satisfy dxdu[n] = du[n+1]
    uave, _, du, dxdu = dispatch.reduce_central(tt(u), tt(u), 4, val_ndim=0, x_is_u=True)
    np.testing.assert_allclose(npy(dxdu[1:4]), npy(du[2:5]), rtol=RTOL64)


def test_plain_path_differentiates(rng):
    """The CPU path is differentiable by autograd: d uave / d u_j = w_j / W."""
    u, x = _samples(rng, 200, 1)
    w = rng.uniform(0.5, 1.5, 200)
    tu = tt(u).requires_grad_(True)
    _, uave, _, _ = mc.reduce_central_comoments_fused(tu, tt(x), 4, tt(w))
    uave.backward()
    np.testing.assert_allclose(npy(tu.grad), w / w.sum(), rtol=RTOL64)


def test_failed_build_raises(monkeypatch, tmp_path):
    """A failed nvcc run raises with its output; nothing falls back."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.library()
    assert not list(tmp_path.glob("*.so"))


def test_build_digest_tracks_sources():
    cu, cuh = _build._sources()
    assert {p.name for p in cu} == {
        "comoments_reduce.cu",
        "comoments_resample.cu",
        "finalize.cu",
        "mbar_alphas.cu",
        "mbar_solve.cu",
        "perturb_resample.cu",
        "umoments_resample.cu",
    }
    assert {p.name for p in cuh} == {"common.cuh", "philox.cuh", "resample_tile.cuh"}
    assert len(_build._digest()) == 16


def test_drawcost_reads_sass_listing():
    """The instruction histogram behind the draw's operation count: opcodes
    per function, predicates skipped, wide multiplies kept apart."""
    from thermoextrap_tpu_torch import drawcost

    sass = """
	Function : draw_probe
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                  /* 0x00000a00ff017b82 */
                                                                           /* 0x000fe20000000800 */
        /*0010*/                   IMAD.WIDE.U32 R2, R3, -0x2daee0ad, RZ ; /* 0x0 */
        /*0020*/              @!P0 IMAD.MOV.U32 R4, RZ, RZ, R2 ;           /* 0x0 */
        /*0030*/                   ISETP.GT.U32.AND P0, PT, R1, UR4, PT ;  /* 0x0 */
        /*0040*/               @P0 VIADD R5, R5, 0x1 ;                     /* 0x0 */
        /*0050*/                   LOP3.LUT R6, R6, R7, R8, 0x96, !PT ;    /* 0x0 */
        /*0060*/                   EXIT ;                                  /* 0x0 */
	Function : base_probe
        /*0000*/                   I2FP.F32.S32 R0, R0 ;                   /* 0x0 */
"""
    hist = drawcost._histograms(sass)
    assert hist == {
        "draw_probe": {"LDC": 1, "IMAD.WIDE": 1, "IMAD": 1, "ISETP": 1, "VIADD": 1, "LOP3": 1, "EXIT": 1},
        "base_probe": {"I2FP": 1},
    }
    assert '#include "philox.cuh"' in drawcost._PROBE
