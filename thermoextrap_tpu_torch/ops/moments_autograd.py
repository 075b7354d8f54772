r"""The backward route of the kernels K1, K2, K4 and K6.

Counterpart of the ``custom_vjp`` entries of
``thermoextrap_tpu/ops/moments_pallas.py``: each ``*_ad`` function below
runs the kernel wrapper of :mod:`.moments_cuda` forward, unchanged, and
differentiates in plain torch, as the reference's backward passes are XLA
code outside its kernels:

==================================================  =====  =============================================
entry                                               kernel backward
==================================================  =====  =============================================
:func:`reduce_central_comoments_fused_ad`            K1     closed-form cotangents (``_fused_ad_bwd``)
:func:`reduce_central_comoments_batched_ad`          K6     autograd of the plain two-pass
:func:`reduce_central_umoments_batched_ad`           K4     autograd of the plain two-pass
:func:`resample_central_comoments_fused_ad`          K2     autograd of the plain table product
==================================================  =====  =============================================

The backward passes work in float64 from the saved inputs (and, for K1,
the forward's outputs), whatever the kernel's stream type, and cast each
gradient to its input's dtype.  A ``None`` weight gets a ``None`` gradient;
the count table of K2 gets none.  With no input that requires grad (or with
grad mode off) an entry is the wrapper call itself, so the serving path
launches the same kernels as before.  The Poisson draws (K3, K5) and the
perturbation kernels (K7, K8) have no backward, as in the reference.
"""

from __future__ import annotations

import torch

from . import moments, moments_cuda, resample

__all__ = [
    "reduce_central_comoments_batched_ad",
    "reduce_central_comoments_fused_ad",
    "reduce_central_umoments_batched_ad",
    "resample_central_comoments_fused_ad",
]

_F64 = torch.float64


def _needs_grad(*arrays) -> bool:
    """True when grad mode is on and a tensor among ``arrays`` requires grad."""
    return torch.is_grad_enabled() and any(isinstance(a, torch.Tensor) and a.requires_grad for a in arrays)


def _weight_tensor(w, uv):
    return None if w is None else torch.as_tensor(w, device=uv.device)


def _cast_like(grads, inputs):
    return tuple(None if g is None else g.to(a.dtype) for g, a in zip(grads, inputs))


def _plain_vjp(fn, inputs, cts):
    """Gradients of ``fn(*inputs)`` against the cotangents ``cts``, by
    autograd in float64; ``None`` inputs get ``None``."""
    with torch.enable_grad():
        leaves = [None if a is None else a.detach().to(_F64).requires_grad_() for a in inputs]
        outs = fn(*leaves)
        live = [a for a in leaves if a is not None]
        grads = iter(torch.autograd.grad(outs, live, [c.to(_F64) for c in cts], allow_unused=True))
    return _cast_like([None if a is None else next(grads) for a in leaves], inputs)


def _horner(coefs, t):
    """``sum_n coefs[n] t^n`` for ``coefs (order+1, *c)`` and samples ``t
    (R,)``: ``(R, *c)``."""
    tt = t.reshape(t.shape + (1,) * (coefs.ndim - 1))
    acc = torch.zeros_like(tt) + coefs[-1]
    for c in reversed(coefs[:-1]):
        acc = acc * tt + c
    return acc


def _fused_bwd(uv, xv, w, out, cts, order: int):
    r"""The closed-form cotangents of K1 (``_fused_ad_bwd``,
    moments_pallas.py:2189-2255), each sum over the order a polynomial in
    ``t = u - uave`` evaluated by Horner's rule, in float64:

    - ``du_j = (w_j/W) [g_uave + A(t_j) - c_1 + sum_v s_jv B_v(t_j) - c_2]``
    - ``dx_jv = (w_j/W) [g_xave,v + C_v(t_j) - c_3,v]``
    - ``dw_j = [sum_v s_jv (g_xave,v + C_v(t_j) - c_3,v) + g_uave t_j + D(t_j)
      - c_4 - t_j c_1 - c_5 - t_j c_2] / W``

    with ``s = x - xave``, ``A = sum n g_du[n] t^{n-1}``, ``B_v = sum n
    g_dxdu[n, v] t^{n-1}``, ``C_v = sum g_dxdu[n, v] t^n``, ``D = sum g_du[n]
    t^n`` and the constants ``c_1 = sum n g_du[n] du[n-1]``, ``c_2 = sum n
    g_dxdu[n] . dxdu[n-1]``, ``c_3 = sum g_dxdu[n] du[n]``, ``c_4 = sum
    g_du[n] du[n]``, ``c_5 = sum g_dxdu[n] . dxdu[n]``."""
    r = uv.shape[0]
    xave, uave, du, dxdu = (o.to(_F64) for o in out)
    gxave, guave, gdu, gdxdu = (c.to(_F64) for c in cts)
    v = xave.numel()
    xave, gxave = xave.reshape(v), gxave.reshape(v)
    dxdu, gdxdu = dxdu.reshape(order + 1, v), gdxdu.reshape(order + 1, v)

    u = uv.to(_F64)
    wt = torch.ones_like(u) if w is None else torch.broadcast_to(w.to(_F64), u.shape)
    wsum = wt.sum()
    wn = wt / wsum
    t = u - uave
    s = xv.reshape(r, v).to(_F64) - xave

    n = torch.arange(order + 1, dtype=_F64, device=u.device)
    a_coef = (n * gdu)[1:]
    b_coef = (n[:, None] * gdxdu)[1:]
    c1 = (a_coef * du[:-1]).sum()
    c2 = (b_coef * dxdu[:-1]).sum()
    c3 = (gdxdu * du[:, None]).sum(0)

    gu = wn * (guave + _horner(a_coef, t) - c1 + (s * _horner(b_coef, t)).sum(1) - c2)
    cx = _horner(gdxdu, t) - c3 + gxave
    gx = (wn[:, None] * cx).reshape(xv.shape)
    if w is None:
        return _cast_like((gu, gx, None), (uv, xv, None))
    c4 = (gdu * du).sum()
    c5 = (gdxdu * dxdu).sum()
    gw = ((s * cx).sum(1) + (guave - c1 - c2) * t + _horner(gdu, t) - c4 - c5) / wsum
    return _cast_like((gu, gx, gw), (uv, xv, w))


class _FusedReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, uv, xv, w, order):
        out = moments_cuda.reduce_central_comoments_fused(uv, xv, order, weight=w)
        ctx.order = order
        ctx.save_for_backward(uv, xv, w, *out)
        return out

    @staticmethod
    def backward(ctx, *cts):
        uv, xv, w, *out = ctx.saved_tensors
        gu, gx, gw = _fused_bwd(uv, xv, w, out, cts, ctx.order)
        return gu, gx, gw, None


class _BatchedReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, uv, xv, w, order):
        ctx.order = order
        ctx.save_for_backward(uv, xv, w)
        return moments_cuda.reduce_central_comoments_batched(uv, xv, order, weight=w)

    @staticmethod
    def backward(ctx, *cts):
        uv, xv, w = ctx.saved_tensors
        val_ndim = xv.ndim - uv.ndim

        def f(u, x, ww):
            return moments.reduce_central_comoments(u, x, ctx.order, weight=ww, val_ndim=val_ndim)

        return (*_plain_vjp(f, (uv, xv, w), cts), None)


class _UReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, uv, w, order):
        ctx.order = order
        ctx.save_for_backward(uv, w)
        return moments_cuda.reduce_central_umoments_batched(uv, order, weight=w)

    @staticmethod
    def backward(ctx, *cts):
        uv, w = ctx.saved_tensors

        def f(u, ww):
            return moments.reduce_central_umoments(u, ctx.order, weight=ww)

        return (*_plain_vjp(f, (uv, w), cts), None)


class _FusedResample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, uv, xv, freq, w, order):
        ctx.order = order
        ctx.save_for_backward(uv, xv, freq, w)
        return moments_cuda.resample_central_comoments_fused(uv, xv, freq, order, weight=w)

    @staticmethod
    def backward(ctx, *cts):
        uv, xv, freq, w = ctx.saved_tensors

        def f(u, x, ww):
            return resample.resample_central_comoments(u, x, freq, ctx.order, weight=ww)

        gu, gx, gw = _plain_vjp(f, (uv, xv, w), cts)
        return gu, gx, None, gw, None


def reduce_central_comoments_fused_ad(uv, xv, w, order: int):
    """K1 (:func:`.moments_cuda.reduce_central_comoments_fused`) with the
    closed-form backward; ``w`` may be ``None``."""
    if not _needs_grad(uv, xv, w):
        return moments_cuda.reduce_central_comoments_fused(uv, xv, order, weight=w)
    return _FusedReduce.apply(uv, xv, _weight_tensor(w, uv), order)


def reduce_central_comoments_batched_ad(uv, xv, w, order: int):
    """K6 (:func:`.moments_cuda.reduce_central_comoments_batched`), its
    backward autograd of :func:`.moments.reduce_central_comoments`."""
    if not _needs_grad(uv, xv, w):
        return moments_cuda.reduce_central_comoments_batched(uv, xv, order, weight=w)
    return _BatchedReduce.apply(uv, xv, _weight_tensor(w, uv), order)


def reduce_central_umoments_batched_ad(uv, w, order: int):
    """K4 (:func:`.moments_cuda.reduce_central_umoments_batched`), its
    backward autograd of :func:`.moments.reduce_central_umoments`."""
    if not _needs_grad(uv, w):
        return moments_cuda.reduce_central_umoments_batched(uv, order, weight=w)
    return _UReduce.apply(uv, _weight_tensor(w, uv), order)


def resample_central_comoments_fused_ad(uv, xv, freq, order: int, weight=None):
    """K2 (:func:`.moments_cuda.resample_central_comoments_fused`), its
    backward autograd of :func:`.resample.resample_central_comoments`; the
    count table ``freq`` gets no gradient."""
    if not _needs_grad(uv, xv, weight):
        return moments_cuda.resample_central_comoments_fused(uv, xv, freq, order, weight=weight)
    freq = torch.as_tensor(freq, device=uv.device)
    return _FusedResample.apply(uv, xv, freq, _weight_tensor(weight, uv), order)
