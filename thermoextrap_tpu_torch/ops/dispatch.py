"""Route each moment call by the device of its tensors.

A CUDA tensor goes to the hand-written kernels (:mod:`.moments_cuda`); a CPU
tensor takes the plain float64 two-pass path (:mod:`.moments`,
:mod:`.resample`).  :func:`set_impl` / :func:`use_impl` force one side for
every call: ``"torch"`` the plain path on any device, ``"cuda"`` the kernel
wrappers (which still run their plain versions on CPU tensors).

A third backend, ``"native"``, sends host arrays (CPU tensors and numpy
arrays) to the compiled C++ engine of :mod:`..native` (float64, the
cmomy / numba role) and hands its results back as float64 CPU tensors; a
call with a tensor on the card keeps its kernel route, as the reference
sends only host-transferable arrays to its engine.  So ``set_impl("native")``
is safe to leave on globally.

On the kernel route an input that requires grad (under grad mode) takes the
autograd Functions of :mod:`.moments_autograd` around K1, K2, K4 and K6,
whose backward passes are plain torch; every other call is the kernel
wrapper itself.
"""

from __future__ import annotations

import contextlib

import torch

from ..utils.trace import span
from . import moments, moments_autograd, resample

__all__ = ["reduce_central", "reduce_central_u", "reduce_raw", "resample_central", "set_impl", "use_impl"]

_FORCE: str | None = None  # None = by device; "torch" | "cuda" | "native"


def set_impl(impl: str | None) -> None:
    """Force an implementation globally (``None`` restores the choice by device)."""
    global _FORCE
    if impl not in (None, "torch", "cuda", "native"):
        msg = f"impl must be None, 'torch', 'cuda' or 'native'; got {impl!r}"
        raise ValueError(msg)
    _FORCE = impl


@contextlib.contextmanager
def use_impl(impl: str | None):
    """Scoped :func:`set_impl`, restored on exit.

    >>> with use_impl("torch"):
    ...     pass  # calls in here take the plain torch path
    """
    prev = _FORCE
    set_impl(impl)
    try:
        yield
    finally:
        set_impl(prev)


def _use_kernels(uv) -> bool:
    if _FORCE in ("torch", "cuda"):
        return _FORCE == "cuda"
    return uv.device.type == "cuda"


def _use_native(*arrays) -> bool:
    """True when the forced native backend serves this call: no operand is
    a tensor off the CPU."""
    if _FORCE != "native":
        return False
    return not any(isinstance(a, torch.Tensor) and a.device.type != "cpu" for a in arrays)


def _native(name: str, *args, **kws):
    """The native engine's function ``name``, its outputs as float64 CPU tensors."""
    from .. import native

    return tuple(torch.from_numpy(o) for o in getattr(native, name)(*args, **kws))


def reduce_central(uv, xv, order, weight=None, val_ndim=1, x_is_u=False):
    """Central comoments ``(xave, uave, du, dxdu)`` of ``uv (*batch, R)``,
    ``xv (*batch, R, *val)``; the contract of
    :func:`.moments.reduce_central_comoments`.  With ``x_is_u`` (or ``xv is
    uv``) the kernel route reads u once: K4 at ``order + 1`` gives the
    comoments by the shift view ``dxdu[n] = du[n+1]``.  A ``te.reduce``
    span."""
    with span("te.reduce"):
        if _use_native(uv, xv, weight):
            # comoments of (u, u-shaped x) already satisfy the x_is_u contract
            return _native("reduce_central_comoments", uv, xv, order, weight=weight, val_ndim=val_ndim)
        if _use_kernels(uv):
            if x_is_u or xv is uv:
                uave, du_full = moments_autograd.reduce_central_umoments_batched_ad(uv, weight, order + 1)
                return uave, uave, du_full[: order + 1], du_full[1 : order + 2]
            if uv.ndim == 1:
                return moments_autograd.reduce_central_comoments_fused_ad(uv, xv, weight, order)
            return moments_autograd.reduce_central_comoments_batched_ad(uv, xv, weight, order)
        return moments.reduce_central_comoments(uv, xv, order, weight=weight, val_ndim=val_ndim)


def reduce_central_u(uv, order, weight=None):
    """Central u-moments ``(uave (*batch,), du (order+1, *batch))`` of every
    row of ``uv (*batch, R)``: K4, or the float64 two-pass.  A
    ``te.reduce`` span."""
    with span("te.reduce"):
        if _use_native(uv, weight):
            _x, uave, du, _dxdu = _native("reduce_central_comoments", uv, uv, order, weight=weight, val_ndim=0)
            return uave, du
        if _use_kernels(uv):
            return moments_autograd.reduce_central_umoments_batched_ad(uv, weight, order)
        return moments.reduce_central_umoments(uv, order, weight=weight)


def reduce_raw(uv, xv, order, weight=None, val_ndim=1):
    """Raw comoments ``(u, xu)``: the plain path on every device (raw moments
    only make numerical sense in float64 and for parity checks), or the
    native engine for a flat host stream."""
    if _use_native(uv, xv, weight) and uv.ndim == 1:
        return _native("reduce_raw_comoments", uv, xv, order, weight=weight, val_ndim=val_ndim)
    return moments.reduce_raw_comoments(uv, xv, order, weight=weight, val_ndim=val_ndim)


def resample_central(uv, xv, freq, order, weight=None):
    """Per-replicate central comoments from a count table ``freq (nrep, R)``."""
    if _use_native(uv, xv, freq, weight):
        return _native("resample_central_comoments", uv, xv, freq, order, weight=weight)
    if _use_kernels(uv):
        return moments_autograd.resample_central_comoments_fused_ad(uv, xv, freq, order, weight)
    freq = torch.as_tensor(freq, device=uv.device)
    return resample.resample_central_comoments(uv, xv, freq, order, weight=weight)
