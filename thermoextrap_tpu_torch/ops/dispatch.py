"""Route each moment call by the device of its tensors.

A CUDA tensor goes to the hand-written kernels (:mod:`.moments_cuda`); a CPU
tensor takes the plain float64 two-pass path (:mod:`.moments`,
:mod:`.resample`).  :func:`set_impl` / :func:`use_impl` force one side for
every call: ``"torch"`` the plain path on any device, ``"cuda"`` the kernel
wrappers (which still run their plain versions on CPU tensors).
"""

from __future__ import annotations

import contextlib

import torch

from . import moments, moments_cuda, resample

__all__ = ["reduce_central", "reduce_raw", "resample_central", "set_impl", "use_impl"]

_FORCE: str | None = None  # None = by device; "torch" | "cuda"


def set_impl(impl: str | None) -> None:
    """Force an implementation globally (``None`` restores the choice by device)."""
    global _FORCE
    if impl not in (None, "torch", "cuda"):
        msg = f"impl must be None, 'torch' or 'cuda'; got {impl!r}"
        raise ValueError(msg)
    _FORCE = impl


@contextlib.contextmanager
def use_impl(impl: str | None):
    """Scoped :func:`set_impl`, restored on exit."""
    prev = _FORCE
    set_impl(impl)
    try:
        yield
    finally:
        set_impl(prev)


def _use_kernels(uv) -> bool:
    if _FORCE is not None:
        return _FORCE == "cuda"
    return uv.device.type == "cuda"


def _unported_u_kernel():
    msg = (
        "x_is_u reductions on the GPU need the batched u-moment kernels K4 "
        "(reduce_central_umoments_batched) and K5 "
        "(resample_central_umoments_batched_poisson), which are not ported "
        "yet; run the x_is_u path on CPU tensors"
    )
    return NotImplementedError(msg)


def reduce_central(uv, xv, order, weight=None, val_ndim=1, x_is_u=False):
    """Central comoments ``(xave, uave, du, dxdu)`` of ``uv (*batch, R)``,
    ``xv (*batch, R, *val)``; the contract of
    :func:`.moments.reduce_central_comoments`."""
    if _use_kernels(uv):
        if x_is_u or xv is uv:
            if uv.device.type == "cuda":
                raise _unported_u_kernel()
        elif uv.ndim == 1:
            return moments_cuda.reduce_central_comoments_fused(uv, xv, order, weight)
        else:
            return moments_cuda.reduce_central_comoments_batched(uv, xv, order, weight)
    return moments.reduce_central_comoments(uv, xv, order, weight=weight, val_ndim=val_ndim)


def reduce_raw(uv, xv, order, weight=None, val_ndim=1):
    """Raw comoments ``(u, xu)``: the plain path on every device (raw moments
    only make numerical sense in float64 and for parity checks)."""
    return moments.reduce_raw_comoments(uv, xv, order, weight=weight, val_ndim=val_ndim)


def resample_central(uv, xv, freq, order, weight=None):
    """Per-replicate central comoments from a count table ``freq (nrep, R)``."""
    if _use_kernels(uv):
        return moments_cuda.resample_central_comoments_fused(uv, xv, freq, order, weight)
    freq = torch.as_tensor(freq, device=uv.device)
    return resample.resample_central_comoments(uv, xv, freq, order, weight=weight)
