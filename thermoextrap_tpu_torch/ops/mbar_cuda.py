"""The hand-written CUDA kernels of MBAR: the α grid, ``csrc/mbar_alphas.cu``,
and the hybrid solve, ``csrc/mbar_solve.cu``.

:func:`mbar_alphas_cuda` is :func:`..models.mbar.mbar_expectations_alphas`
on CUDA tensors: the mixture log denominator, each target's log-sum-exp and
its weighted sums in one pass over the samples (a main and a combine launch
per group of up to 8 value columns), so that no ``(A, N)``, ``(K, N)`` or
column-major copy of the samples is ever written.  It replaces no TPU
kernel: the JAX package leaves the grid to XLA's fusion.  The plain torch
version is :func:`..models.mbar._alphas_plain`, which CPU and ``meta``
tensors take; a CUDA tensor launches the kernel or raises.  Each call adds
one to ``LAUNCHES["mbar_alphas"]``.

:class:`MbarSolve` is one hybrid solve of 2 to :data:`SOLVE_MAX_K` states,
what :func:`..models.mbar.mbar_solve_info` runs on CUDA tensors: each pass
over ``u_kn`` evaluates both candidates of an iteration, keeps one and
builds the next pair on the card, so the host loop reads one flag a pass
and no ``(K, N)`` temporary is made.  It too replaces no TPU kernel (XLA
runs the reference's ``while_loop``); the plain version is
:func:`..models.mbar._solve`.  Each pass adds one to
``LAUNCHES["mbar_solve"]``: a solve of ``n_iter`` iterations makes
``n_iter + 1``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, moments_cuda

__all__ = ["SOLVE_MAX_K", "MbarSolve", "kernel_device", "mbar_alphas_cuda"]

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


SOLVE_MAX_K = 8  # TX_SOLVE_MAX_K of csrc/mbar_solve.cu: states the solve kernel takes
# blocks of the solve's persistent grid: one wave of as many as the card holds
# at once (tx_mbar_solve_blocks), or this many where it is set
_SOLVE_BLOCKS = None
_SOLVE_THREADS = 256  # TX_SOLVE_THREADS


def kernel_device(t) -> bool:
    """Whether ``t`` lies where the MBAR kernels run: on a CUDA device (the
    CPU, under :func:`..emulate.emulated`)."""
    return t.device.type == "cuda"


@functools.cache
def _solve_blocks(k: int, is_double: int, device_index) -> int:
    blocks = ctypes.c_int(0)
    status = _build.library().tx_mbar_solve_blocks(k, is_double, device_index, ctypes.addressof(blocks))
    _build.check(status, "tx_mbar_solve_blocks")
    return max(1, blocks.value)


class MbarSolve:
    """One hybrid MBAR solve of ``u_kn (K, N)`` on its device, a pass over
    the samples an iteration.  ``log_n_k (K,)`` and ``log_sample_weight
    (N,)`` (or None; ``-inf`` drops a sample) share ``u_kn``'s type, float32
    or float64, and device; ``2 <= K <=`` :data:`SOLVE_MAX_K`.  Building it
    runs the opening pass at ``f = 0``; :meth:`step` runs one iteration.
    ``active`` (a 0-d int64 tensor on the device) says whether the loop goes
    on: the residual is above ``tol`` and ``n_iter < max_iter``.  ``f (K,)``,
    ``res`` (0-d, ``max |S_k - 1|``) and ``n_iter`` (0-d int64) are the kept
    candidate's, as the torch route's loop would have them."""

    def __init__(self, u_kn, log_n_k, tol: float, max_iter: int, log_sample_weight=None):
        moments_cuda._check_cuda_inputs(u_kn, log_n_k, log_sample_weight)
        dt, dev = u_kn.dtype, u_kn.device
        if dt not in (torch.float32, torch.float64):
            msg = f"the MBAR kernel takes float32 or float64, not {dt}"
            raise TypeError(msg)
        ops = [log_n_k] + ([] if log_sample_weight is None else [log_sample_weight])
        if any(t.dtype != dt or t.device != dev for t in ops):
            msg = "the MBAR kernel's operands must share u_kn's type and device"
            raise ValueError(msg)
        if u_kn.ndim != 2 or not 2 <= u_kn.shape[0] <= SOLVE_MAX_K or u_kn.shape[1] < 1:
            msg = f"the MBAR solve kernel takes u_kn (K, N) with 2 <= K <= {SOLVE_MAX_K}, N >= 1; got {tuple(u_kn.shape)}"
            raise ValueError(msg)
        k, n = u_kn.shape
        if log_n_k.shape != (k,) or (log_sample_weight is not None and log_sample_weight.shape != (n,)):
            lsw = None if log_sample_weight is None else tuple(log_sample_weight.shape)
            msg = f"shapes do not agree: u_kn {tuple(u_kn.shape)}, log_n_k {tuple(log_n_k.shape)}, log_sample_weight {lsw}"
            raise ValueError(msg)
        is_double = int(dt == torch.float64)
        blocks = _solve_blocks(k, is_double, dev.index) if _SOLVE_BLOCKS is None else _SOLVE_BLOCKS
        nb = max(1, min(-(-n // _SOLVE_THREADS), blocks))
        self._u, self._log_n_k = u_kn.contiguous(), log_n_k.contiguous()
        self._lsw = None if log_sample_weight is None else log_sample_weight.contiguous()
        self._cand = torch.empty(3 * k, dtype=dt, device=dev)
        self._fc = torch.empty(2 * k, dtype=torch.float64, device=dev)
        self._part = torch.empty(nb * (2 * (k + k * (k + 1) // 2) + 1), dtype=torch.float64, device=dev)
        self.f = torch.empty(k, dtype=dt, device=dev)
        self.res = torch.empty((), dtype=dt, device=dev)
        self._flags = torch.empty(2, dtype=torch.int64, device=dev)
        self.n_iter, self.active = self._flags[0], self._flags[1]
        self._shape = (n, k, nb)
        self._tol, self._max_iter, self._is_double = float(tol), int(max_iter), is_double
        self._pass(first=1)

    def step(self) -> None:
        """One iteration: both candidates in one pass, the kept one, the next pair."""
        self._pass(first=0)

    def _pass(self, first: int) -> None:
        n, k, nb = self._shape
        status = _build.library().tx_mbar_solve(
            self._u.data_ptr(),
            None if self._lsw is None else self._lsw.data_ptr(),
            self._log_n_k.data_ptr(),
            self._cand.data_ptr(),
            self._fc.data_ptr(),
            self._part.data_ptr(),
            self.f.data_ptr(),
            self.res.data_ptr(),
            self._flags.data_ptr(),
            n,
            k,
            nb,
            first,
            self._tol,
            self._max_iter,
            self._is_double,
            self._u.device.index,
            moments_cuda._stream_ptr(self._u.device),
        )
        _build.check(status, "tx_mbar_solve")
        moments_cuda.LAUNCHES["mbar_solve"] += 1
