"""The hand-written CUDA kernel of MBAR's α grid, ``csrc/mbar_alphas.cu``.

:func:`mbar_alphas_cuda` is :func:`..models.mbar.mbar_expectations_alphas`
on CUDA tensors: the mixture log denominator, each target's log-sum-exp and
its weighted sums in one pass over the samples (a main and a combine launch
per group of up to 8 value columns), so that no ``(A, N)``, ``(K, N)`` or
column-major copy of the samples is ever written.  It replaces no TPU
kernel: the JAX package leaves the grid to XLA's fusion.  The plain torch
version is :func:`..models.mbar._alphas_plain`, which CPU and ``meta``
tensors take; a CUDA tensor launches the kernel or raises.  Each call adds
one to ``LAUNCHES["mbar_alphas"]``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, moments_cuda

__all__ = ["mbar_alphas_cuda"]

_THREADS = 256  # TX_MBAR_THREADS of csrc/mbar_alphas.cu: targets of a block
_TILE = 512  # TX_MBAR_TILE: samples a block stages at a time
_MAX_VG = 8  # TX_MBAR_MAX_VG: value columns of a group
# blocks of the persistent grid, shared among the groups of 256 targets:
# two waves of as many as the card holds at once (tx_mbar_alphas_blocks; two
# waves ran 3% faster than one at K 4, N 1e8, A 256 on an H100), or this many
# where it is set
_TARGET_BLOCKS = None
_WAVES = 2


@functools.cache
def _resident_blocks(v: int, is_double: int, device_index) -> int:
    blocks = ctypes.c_int(0)
    status = _build.library().tx_mbar_alphas_blocks(v, is_double, device_index, ctypes.addressof(blocks))
    _build.check(status, "tx_mbar_alphas_blocks")
    return max(1, blocks.value)


def mbar_alphas_cuda(u_kn, c_k, alphas, u_base, x_n, log_sample_weight=None):
    """``<x>`` at the targets ``α_a · u_base``: ``u_kn (K, N)``, ``c_k (K,)
    = log n_k + f_k``, ``alphas (A,)``, ``u_base (N,)``, ``x_n (N, ...)``
    (row major; a 1-D ``x_n`` is one column) and ``log_sample_weight (N,)``
    or None, all of one type, float32 or float64, on one device.  Returns
    ``(A, V)`` in that type."""
    moments_cuda._check_cuda_inputs(u_kn, c_k, alphas, u_base, x_n, log_sample_weight)
    k, n = u_kn.shape
    x = x_n.reshape(n, -1)
    a, v = alphas.shape[0], x.shape[1]
    ops = [u_kn, c_k, alphas, u_base, x] + ([] if log_sample_weight is None else [log_sample_weight])
    dt, dev = u_kn.dtype, u_kn.device
    if dt not in (torch.float32, torch.float64):
        msg = f"the MBAR kernel takes float32 or float64, not {dt}"
        raise TypeError(msg)
    if any(t.dtype != dt or t.device != dev for t in ops):
        msg = "the MBAR kernel's operands must share u_kn's type and device"
        raise ValueError(msg)
    if c_k.shape != (k,) or u_base.shape != (n,) or (log_sample_weight is not None and log_sample_weight.shape != (n,)):
        msg = f"shapes do not agree: u_kn {tuple(u_kn.shape)}, c_k {tuple(c_k.shape)}, u_base {tuple(u_base.shape)}"
        raise ValueError(msg)
    if n < 1 or k < 1 or a < 1 or v < 1:
        msg = f"need a sample, a state, a target and a column; got K {k}, N {n}, A {a}, V {v}"
        raise ValueError(msg)
    u_kn, c_k, alphas, u_base, x = (t.contiguous() for t in (u_kn, c_k, alphas, u_base, x))
    lsw = None if log_sample_weight is None else log_sample_weight.contiguous()
    groups = -(-a // _THREADS)
    is_double = int(dt == torch.float64)
    blocks = _WAVES * _resident_blocks(v, is_double, dev.index) if _TARGET_BLOCKS is None else _TARGET_BLOCKS
    nbx = max(1, min(-(-n // _TILE), blocks // groups))
    part = torch.empty(groups * nbx * _THREADS * (2 + min(v, _MAX_VG)), dtype=torch.float64, device=dev)
    out = torch.empty((a, v), dtype=dt, device=dev)
    status = _build.library().tx_mbar_alphas(
        u_kn.data_ptr(),
        c_k.data_ptr(),
        alphas.data_ptr(),
        u_base.data_ptr(),
        x.data_ptr(),
        None if lsw is None else lsw.data_ptr(),
        part.data_ptr(),
        out.data_ptr(),
        n,
        k,
        a,
        v,
        nbx,
        is_double,
        dev.index,
        moments_cuda._stream_ptr(dev),
    )
    _build.check(status, "tx_mbar_alphas")
    moments_cuda.LAUNCHES["mbar_alphas"] += 1
    return out
