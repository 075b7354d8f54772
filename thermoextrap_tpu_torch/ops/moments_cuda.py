r"""Hand-written CUDA kernels for the (co)moment reduction and bootstrap,
with the plain torch version of each beside it.

Counterpart of ``thermoextrap_tpu/ops/moments_pallas.py``: the kernels of
the β-extrapolation main path, of the lnΠ / ⟨u⟩ ensembles and of the
perturbation bootstrap:

======  =================================================  ===============================
kernel  wrapper here                                       CUDA source
======  =================================================  ===============================
K1      :func:`reduce_central_comoments_fused`              ``csrc/comoments_reduce.cu``
K6      :func:`reduce_central_comoments_batched`            ``csrc/comoments_reduce.cu``
K2      :func:`resample_central_comoments_fused`            ``csrc/comoments_resample.cu``
K3      :func:`resample_central_comoments_poisson`          ``csrc/comoments_resample.cu``
K4      :func:`reduce_central_umoments_batched`             ``csrc/comoments_reduce.cu``
K5      :func:`resample_central_umoments_batched_poisson`   ``csrc/umoments_resample.cu``
K7      :func:`resample_perturb_freq`                       ``csrc/perturb_resample.cu``
K8      :func:`resample_perturb_poisson`                    ``csrc/perturb_resample.cu``
======  =================================================  ===============================

Every kernel but K7 / K8 runs between two helper kernels of
``csrc/finalize.cu``: the head shift (:func:`head_shift_cuda`, one shift row
per batch row for K1 / K6, the u shift alone of each row for K4 / K5; plain
version :func:`_head_shift`) and the finalize pass over the chunk or block
partials (:func:`finalize_comoments_cuda`, with one shared shift for K2 / K3
and a shift row per batch row for K1 / K6; :func:`finalize_umoments_cuda`
for K5's replicates and for K4's sample blocks as the chunks of one
replicate; plain versions :func:`finalize_comoments_plain`,
:func:`finalize_umoments_plain`), so their wrapper is three launches and
issues no tensor arithmetic from Python.  K4 is the u-only case (no value
column) of the K1 / K6 kernel.

Every wrapper runs its kernel on a CUDA tensor and its plain torch version on
a CPU tensor; any other device raises.  On the card the sample streams are
float32 or bfloat16 (float64 is cast to float32 first), weights are float32,
accumulation is float32 and the results are float32.  The plain versions keep
float64.  Both share one algorithm: the shift is the weighted mean of the
first :data:`HEAD_N` samples (:func:`_head_shift`), the kernel sums shifted
powers, and one epilogue (:func:`_shifted_epilogue`, or :func:`_u_epilogue`
for the u-moment kernels K4 and K5) recentres the sums exactly.  Each
wrapper adds one to ``LAUNCHES[name]`` when it launches its kernel.  K7 and
K8 take no shift: they sum the streamed reweighting factors as they are.  K2,
K3, K5, K7 and K8 share the contraction of ``csrc/resample_tile.cuh``, which
runs up to 16 contribution rows in its few-rows kernel and more in its
many-rows kernel (:func:`_rows_launch` gives the launch shape of either);
K5 past 16 rows runs on the tensor cores instead (:func:`_k5_on_tensor_cores`,
:func:`_mma_launch`; counts as exact bf16, rows as the three bf16 terms of
:func:`split_bf16x3`, the ``mma.sync`` helper held by
:func:`mma_probe_cuda`), and
the in-kernel Poisson draw of ``csrc/philox.cuh`` (:func:`poisson_map_cuda`
holds its word → count map against the 9-compare sum).  The
wrappers are forward only.  K1, K2, K4 and K6 are differentiated through
:mod:`.moments_autograd` (plain torch backward passes); a CUDA input that
requires grad raises in a direct call of those four under grad mode, and in
any call of K3, K5, K7 or K8.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..utils import trace
from . import _build
from .convert import fix_central_du, fix_central_dxdu, shift_raw_comoments, shift_raw_moments
from .resample import POISSON1_THRESHOLDS, _philox4x32_10, philox_poisson1_counts, seed_tensor, signed64  # noqa: F401

__all__ = [
    "HEAD_N",
    "LAUNCHES",
    "finalize_comoments_cuda",
    "finalize_comoments_plain",
    "finalize_umoments_cuda",
    "finalize_umoments_plain",
    "head_shift_cuda",
    "mma_probe_cuda",
    "poisson_counts_cuda",
    "poisson_map_cuda",
    "reduce_central_comoments_batched",
    "reduce_central_comoments_fused",
    "reduce_central_umoments_batched",
    "reduce_comoments_plain",
    "reduce_umoments_plain",
    "resample_central_comoments_fused",
    "resample_central_comoments_poisson",
    "resample_central_umoments_batched_poisson",
    "resample_comoments_plain",
    "resample_perturb_freq",
    "resample_perturb_plain",
    "resample_perturb_poisson",
    "resample_perturb_poisson_plain",
    "resample_poisson_plain",
    "resample_umoments_plain",
    "resample_umoments_poisson_plain",
    "resample_umoments_table_cuda",
    "reset_launches",
    "split_bf16x3",
]

HEAD_N = 8192  # samples behind the shift estimate
MAX_ORDER = 15  # TX_MAX_ORDER of csrc/common.cuh
LAUNCHES = trace.register("launches", {
    "K1": 0,
    "K2": 0,
    "K3": 0,
    "K4": 0,
    "K5": 0,
    "K6": 0,
    "K7": 0,
    "K8": 0,
    "head_shift": 0,  # helper kernels (csrc/finalize.cu): of every wrapper but K7 / K8
    "finalize": 0,  # of the K1 / K2 / K3 / K6 wrappers
    "finalize_u": 0,  # of the K4 / K5 wrappers
})

_REDUCE_THREADS = 256  # TX_REDUCE_THREADS of comoments_reduce.cu (K1, K4, K6)
_URS_THREADS = 256  # TX_URS_THREADS of resample_tile.cuh (K2, K3, K5, K7, K8)
_URS_RB = 4  # TX_URS_RB
_URS_CB = 16  # TX_URS_CB
_URS_TILE = 32  # TX_URS_TILE: sample tile of the many-rows kernel
_FEW_TILE = 256  # TX_FEW_TILE: sample tile of the few-rows kernel (up to _URS_CB rows)
_MMA_REPS = 128  # TX_MMA_REPS: replicates of a block of the tensor-core kernel
_MMA_ROWS = 224  # TX_MMA_ROWS: rows of such a block
_MMA_S = 32  # TX_MMA_S: its sample tile
_TARGET_BLOCKS = 1056  # 8 blocks of 256 threads on each of the H100's 132 SMs
# K7/K8 cut the samples four times finer: a thread's serial float32 sum of
# positive terms then runs over a few hundred samples at R = 1e7, which holds
# the sums to ~1e-7 relative once the partials are added in float64
_PERTURB_TARGET_BLOCKS = 4 * _TARGET_BLOCKS

# count-table codes of tx_resample_comoments and tx_resample_perturb
_COUNT_KIND = {
    torch.int8: 0,
    torch.int16: 1,
    torch.int32: 2,
    torch.float32: 3,
    torch.bfloat16: 4,
}
_POISSON_KIND = 5
# the table types K2 takes past the few-rows kernel's 16 rows; the rest are
# widened to these first (the same counts, so the same sums)
_WIDE_TABLE = {torch.int8: torch.int32, torch.int16: torch.int32, torch.bfloat16: torch.float32}

def reset_launches() -> None:
    """Set every kernel launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# shared pieces of the kernel and plain paths
# ---------------------------------------------------------------------------


def _stream_dtype(uv, xv):
    """bfloat16 is an opt-in for BOTH sample streams; one alone raises."""
    if (uv.dtype == torch.bfloat16) != (xv.dtype == torch.bfloat16):
        msg = (
            f"mixed input dtypes {uv.dtype}/{xv.dtype}: cast both uv and xv "
            "to bfloat16 to opt into the half-traffic stream, or neither"
        )
        raise ValueError(msg)
    return torch.bfloat16 if uv.dtype == torch.bfloat16 else torch.float32


def _plain_dtype(uv, xv):
    """Compute type of the plain versions: float64 stays, the rest is float32."""
    _stream_dtype(uv, xv)
    return torch.float64 if torch.float64 in (uv.dtype, xv.dtype) else torch.float32


def _head_shift(u2, w2, x3=None, head_n: int = HEAD_N):
    """Per-row shift ``s_u (nbatch,)``, or ``(s_u, s_x (nbatch, V))`` when
    ``x3`` is given: the weighted mean of the first ``head_n`` samples of
    ``u2 (nbatch, R)``, ``x3 (nbatch, R, V)``, computed in ``u2``'s type.  A
    head of zero weight gives shift 0 (the recentring is exact for any finite
    shift; 0/0 would poison every output)."""
    head = min(head_n, u2.shape[1])
    uh = u2[:, :head]
    wh = torch.ones_like(uh) if w2 is None else w2[:, :head].to(uh.dtype)
    hsum = wh.sum(-1)
    ok = hsum > 0
    safe = torch.where(ok, hsum, torch.ones_like(hsum))
    zero = torch.zeros((), dtype=uh.dtype, device=uh.device)
    s_u = torch.where(ok, (wh * uh).sum(-1) / safe, zero)
    if x3 is None:
        return s_u
    xh = x3[:, :head].to(uh.dtype)
    s_x = torch.where(ok[:, None], (wh[:, :, None] * xh).sum(1) / safe[:, None], zero)
    return s_u, s_x


def _normalized_u(sum_u):
    """Raw u-moments ``sum_u / sum_u[0]`` with the finite convention of a row
    of zero total weight (an all-zero bootstrap replicate): ``[1, 0, ...]``.
    Returns ``(m, safe)``, ``safe`` the divisor used."""
    wsum = sum_u[0]
    ok = wsum > 0
    safe = torch.where(ok, wsum, torch.ones_like(wsum))
    m = sum_u / safe
    m = torch.cat([torch.where(ok, m[0], torch.ones_like(m[0]))[None], m[1:]], dim=0)
    return m, safe


def _u_epilogue(sum_u, s_u):
    """Shifted raw u power sums ``sum_u (order+1, *b)`` about ``s_u (*b)`` →
    exact central u-moments ``(uave (*b), du (order+1, *b), wsum (*b))``
    with ``du[0] = 1``, ``du[1] = 0``; a zero-weight row takes the finite
    convention of :func:`_normalized_u`."""
    m, _ = _normalized_u(sum_u)
    return m[1] + s_u, fix_central_du(shift_raw_moments(m, m[1])), sum_u[0]


def _shifted_epilogue(sum_u, sum_x, s_u, s_x):
    r"""Shifted raw power sums → exact central comoments.

    ``sum_u (order+1, *b)`` holds ``sum w du^n`` and ``sum_x (order+1, *b,
    V)`` holds ``sum w du^n dx`` about the shift ``s_u (*b)``,
    ``s_x (*b, V)``.  Returns ``(xave (*b, V), uave (*b), du (order+1, *b),
    dxdu (order+1, *b, V), wsum (*b))``.  A row of zero total weight (an
    all-zero bootstrap replicate) takes the finite convention of the plain
    bootstrap: raw moments ``[1, 0, ...]``, so its means are the shift and
    its central moments vanish.
    """
    m, safe = _normalized_u(sum_u)
    c = sum_x / safe[..., None]
    uave = m[1] + s_u
    xave = c[0] + s_x
    du = shift_raw_moments(m, m[1])
    x_du = shift_raw_comoments(c, m[1][..., None])
    dxdu = x_du - c[0][None] * du[..., None]
    return xave, uave, fix_central_du(du), fix_central_dxdu(dxdu), sum_u[0]


def _check_cuda_inputs(*tensors, backward: bool = False):
    """Raise on an input that requires grad.  K3, K5, K7 and K8 are forward
    only, as in the reference.  K1, K2, K4 and K6 (``backward=True``) have a
    backward route, :mod:`.moments_autograd` (which :mod:`.dispatch` takes),
    whose forward runs with grad mode off: a direct wrapper call under grad
    mode would hand back outputs cut from the graph, so it raises."""
    if backward and not torch.is_grad_enabled():
        return
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.requires_grad:
            if backward:
                msg = (
                    "this kernel wrapper returns no graph; differentiate through "
                    "ops.dispatch or ops.moments_autograd, or detach the inputs"
                )
            else:
                msg = (
                    "this CUDA kernel is forward only, as in the reference; "
                    "detach the inputs or run on CPU"
                )
            raise NotImplementedError(msg)


def _device_kind(uv, xv=None, nlead: int = 0) -> str:
    """``"cpu"`` or ``"cuda"``; raises unless ``xv`` (when given) lies on
    ``uv``'s device and its leading ``nlead`` axes are ``uv``'s (batch and
    sample) axes."""
    kind = uv.device.type
    if kind not in ("cpu", "cuda"):
        msg = f"the moment kernels run on cuda or cpu tensors, not {uv.device}"
        raise ValueError(msg)
    if xv is None:
        return kind
    if xv.device != uv.device:
        msg = f"uv is on {uv.device} but xv on {xv.device}"
        raise ValueError(msg)
    if tuple(xv.shape[:nlead]) != tuple(uv.shape[-nlead:]):
        msg = f"xv {tuple(xv.shape)} does not lead with the sample axes of uv {tuple(uv.shape)}"
        raise ValueError(msg)
    return kind


def _stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream




def _weight_rows(weight, shape, device):
    if weight is None:
        return None
    w = torch.as_tensor(weight, device=device)
    return torch.broadcast_to(w, shape)


def _count_table(freq, nrep: int, r: int, device, *, wide: bool = False):
    """A count table as the kernels stream it: ``(table, kind code)``;
    ``wide`` widens the narrow types to :data:`_WIDE_TABLE`'s."""
    freq = torch.as_tensor(freq, device=device)
    if freq.shape != (nrep, r):
        msg = f"freq must have shape {(nrep, r)}, got {tuple(freq.shape)}"
        raise ValueError(msg)
    if freq.dtype not in _COUNT_KIND:
        # wide or unsigned integer tables stream as int32; other float
        # tables as float32 (fractional counts must stay fractional)
        freq = freq.to(torch.float32 if freq.is_floating_point() else torch.int32)
    if wide:
        freq = freq.to(_WIDE_TABLE.get(freq.dtype, freq.dtype))
    freq = freq.contiguous()
    return freq, _COUNT_KIND[freq.dtype]


# ---------------------------------------------------------------------------
# K1 / K6: shifted single-pass reduction
# ---------------------------------------------------------------------------


def reduce_comoments_plain(u2, x3, w2, order: int):
    """Plain torch version of K1/K6 on ``u2 (nbatch, R)``, ``x3 (nbatch, R,
    V)``, ``w2 (nbatch, R)`` or None: head shift, shifted power sums, shared
    epilogue.  Returns the epilogue's 5-tuple with batch axis ``nbatch``."""
    dtype = _plain_dtype(u2, x3)
    u = u2.to(dtype)
    x = x3.to(dtype)
    w = None if w2 is None else w2.to(dtype)
    s_u, s_x = _head_shift(u, w, x)
    du = u - s_u[:, None]
    dx = x - s_x[:, None, :]
    p = torch.ones_like(u) if w is None else w
    rows_u, rows_x = [], []
    for _ in range(order + 1):
        rows_u.append(p.sum(-1))
        rows_x.append((p[..., None] * dx).sum(-2))
        p = p * du
    return _shifted_epilogue(torch.stack(rows_u), torch.stack(rows_x), s_u, s_x)


def _reduce_blocks(nbatch: int, r: int) -> int:
    """Sample blocks of the K1/K4/K6 kernel per batch row: ~4096 samples a
    block or more, about two waves of 8 blocks on each SM in all (fewer,
    longer blocks amortise a block's closing sums over more samples: K4 at
    the lnΠ grid), at most 1024 a row (the finalize kernels sum them per
    row)."""
    return max(1, min(1024, math.ceil(r / (_REDUCE_THREADS * 16)), math.ceil(2 * _TARGET_BLOCKS / nbatch)))


def _reduce_cuda(u2, x3, w2, order: int):
    """The K1 / K6 wrapper on CUDA tensors: checks and casts, then three
    launches (the head shift of each batch row, the reduction kernel, the
    finalize kernel with a shift row per batch row) and no tensor arithmetic
    in between; returns the epilogue's 5-tuple (float32)."""
    _check_cuda_inputs(u2, x3, w2, backward=True)
    if order > MAX_ORDER:
        msg = f"order {order} exceeds the kernel's maximum {MAX_ORDER}"
        raise ValueError(msg)
    sdt = _stream_dtype(u2, x3)
    u = u2.to(sdt).contiguous()
    x = x3.to(sdt).contiguous()
    w = None if w2 is None else w2.to(torch.float32).contiguous()
    nbatch, r = u.shape
    v = x.shape[2]
    shift = head_shift_cuda(u, x, w)
    nblk = _reduce_blocks(nbatch, r)
    part = torch.empty((nblk, nbatch, (v + 1) * (order + 1)), dtype=torch.float32, device=u.device)
    status = _build.library().tx_reduce_comoments(
        u.data_ptr(),
        x.data_ptr(),
        None if w is None else w.data_ptr(),
        shift.data_ptr(),
        part.data_ptr(),
        nbatch,
        r,
        v,
        order,
        nblk,
        int(sdt == torch.bfloat16),
        u.device.index,
        _stream_ptr(u.device),
    )
    _build.check(status, "tx_reduce_comoments")
    return finalize_comoments_cuda(part, shift, order, v)


def _reduce(u2, x3, w2, order: int, name: str):
    if u2.device.type == "cpu":
        return reduce_comoments_plain(u2, x3, w2, order)
    out = _reduce_cuda(u2, x3, w2, order)
    LAUNCHES[name] += 1
    return out


def reduce_central_comoments_fused(uv, xv, order: int, weight=None):
    r"""K1: central comoments of the flat stream ``uv (R,)``, ``xv (R,
    *val)``; returns ``(xave (*val), uave (), du (order+1,), dxdu (order+1,
    *val))``, the contract of :func:`.moments.reduce_central_comoments`."""
    r = uv.shape[0]
    _device_kind(uv, xv, 1)
    val_shape = tuple(xv.shape[1:])
    w = _weight_rows(weight, (r,), uv.device)
    xave, uave, du, dxdu, _ = _reduce(
        uv.reshape(1, r), xv.reshape(1, r, -1), None if w is None else w.reshape(1, r), order, "K1"
    )
    return (
        xave[0].reshape(val_shape),
        uave[0],
        du[:, 0],
        dxdu[:, 0].reshape((order + 1, *val_shape)),
    )


def reduce_central_comoments_batched(uv, xv, order: int, weight=None):
    r"""K6: central comoments with batch axes, ``uv (*batch, R)``,
    ``xv (*batch, R, *val)``, a shift per batch row; the contract of
    :func:`.moments.reduce_central_comoments`."""
    batch = tuple(uv.shape[:-1])
    r = uv.shape[-1]
    _device_kind(uv, xv, uv.ndim)
    val_shape = tuple(xv.shape[uv.ndim :])
    u2 = uv.reshape(-1, r)
    nbatch = u2.shape[0]
    w = _weight_rows(weight, tuple(uv.shape), uv.device)
    xave, uave, du, dxdu, _ = _reduce(
        u2, xv.reshape(nbatch, r, -1), None if w is None else w.reshape(nbatch, r), order, "K6"
    )
    return (
        xave.reshape(batch + val_shape),
        uave.reshape(batch),
        du.reshape((order + 1, *batch)),
        dxdu.reshape((order + 1, *batch, *val_shape)),
    )


# ---------------------------------------------------------------------------
# K2 / K3: bootstrap sums, counts from a table or drawn in the kernel
# ---------------------------------------------------------------------------


def _poisson_counts(seed: int, nrep: int, nrec: int, device=None, *, start: int = 0):
    """The Poisson(1) counts K3 draws for samples ``start .. start+nrec-1``
    (``start`` a multiple of 4), as an int32 table ``(nrep, nrec)`` on
    ``device``: :func:`.resample.philox_poisson1_counts` on an integer
    seed."""
    if start % 4:
        msg = f"start must be a multiple of 4, got {start}"
        raise ValueError(msg)
    return philox_poisson1_counts(seed_tensor(seed, device), nrep, nrec, start=start)


def _plain_streams(uv, x2, weight):
    """Compute-type streams and their head shift for the plain bootstrap."""
    dtype = _plain_dtype(uv, x2)
    u = uv.to(dtype)
    x = x2.to(dtype)
    w = _weight_rows(weight, u.shape, u.device)
    w = None if w is None else w.to(dtype)
    s_u, s_x = _head_shift(u[None], None if w is None else w[None], x[None])
    return u, x, w, s_u[0], s_x[0]


def _resample_sums_plain(u, x, w, counts, s_u, s_x, order: int):
    """``counts (nrep, n) @`` the shifted contribution rows of ``n`` samples:
    ``(sum_u (order+1, nrep), sum_x (order+1, nrep, V))``."""
    du = u - s_u
    dx = x - s_x
    f = counts.to(device=u.device, dtype=u.dtype)
    p = torch.ones_like(u) if w is None else w
    rows_u, rows_x = [], []
    for _ in range(order + 1):
        rows_u.append(f @ p)
        rows_x.append(f @ (p[:, None] * dx))
        p = p * du
    return torch.stack(rows_u), torch.stack(rows_x)


def resample_comoments_plain(uv, x2, counts, order: int, weight=None):
    """Plain torch version of K2: head shift, ``counts (nrep, R) @`` shifted
    contribution rows, shared epilogue.  ``uv (R,)``, ``x2 (R, V)``.
    Returns the epilogue's 5-tuple with batch axis ``nrep``."""
    u, x, w, s_u, s_x = _plain_streams(uv, x2, weight)
    nrep = counts.shape[0]
    sum_u, sum_x = _resample_sums_plain(u, x, w, counts, s_u, s_x, order)
    return _shifted_epilogue(sum_u, sum_x, s_u.expand(nrep), s_x.expand(nrep, -1))


def resample_poisson_plain(uv, x2, nrep: int, order: int, weight=None, *, seed: int = 0, chunk: int = 1 << 20):
    """Plain torch version of K3: K2's plain sums on :func:`_poisson_counts`,
    drawn and consumed ``chunk`` samples at a time so that the ``(nrep, R)``
    table never exists whole."""
    u, x, w, s_u, s_x = _plain_streams(uv, x2, weight)
    r = u.shape[0]
    chunk = max(4, chunk // 4 * 4)
    sum_u = sum_x = 0
    for j0 in range(0, r, chunk):
        j1 = min(r, j0 + chunk)
        counts = _poisson_counts(seed, nrep, j1 - j0, u.device, start=j0)
        su, sx = _resample_sums_plain(
            u[j0:j1], x[j0:j1], None if w is None else w[j0:j1], counts, s_u, s_x, order
        )
        sum_u = sum_u + su
        sum_x = sum_x + sx
    return _shifted_epilogue(sum_u, sum_x, s_u.expand(nrep), s_x.expand(nrep, -1))


def finalize_comoments_plain(part, s_u, s_x, order: int, v: int):
    """Plain torch version of the finalize kernel: the chunk partials
    ``part (nchunk, nrep, (v+1)(order+1))`` of K2 / K3 (or the block partials
    of K1 / K6, a batch row in the place of a replicate) summed in float64
    and recentred exactly about the shift ``s_u (1,)``, ``s_x (v,)`` (or a
    shift per row, ``s_u (nrep,)``, ``s_x (nrep, v)``).  Returns the
    epilogue's 5-tuple with batch axis ``nrep``, in float32 (float64
    partials keep float64)."""
    nrep = part.shape[1]
    sums = part.double().sum(0)  # (nrep, m), deterministic second pass
    sum_u = sums[:, : order + 1].T
    sum_x = sums[:, order + 1 :].reshape(nrep, v, order + 1).permute(2, 0, 1)
    out = _shifted_epilogue(
        sum_u, sum_x, s_u.double().expand(nrep), s_x.double().expand(nrep, v)
    )
    dtype = torch.float64 if part.dtype == torch.float64 else torch.float32
    return tuple(t.to(dtype) for t in out)


def head_shift_cuda(u, x, w=None):
    """Launch the head-shift kernel on the kernel operands ``u (R,)``,
    ``x (R, V)`` or None and ``w (R,)`` float32 or None, or on batch rows
    ``u (nbatch, R)``, ``x (nbatch, R, V)`` or None, ``w (nbatch, R)``
    (streams both float32 or both bfloat16, contiguous).  Returns the float32
    shift ``(V+1,)`` (``(nbatch, V+1)`` for batch rows): ``s_u`` then ``s_x``
    of each row; with ``x`` None (V = 0, K4 / K5) ``s_u`` alone, ``(1,)``, or
    ``(nbatch,)`` for batch rows (:func:`_head_shift` is the plain
    version)."""
    # shapes only, no views: the K2 / K3 wrapper is host bound at small R
    batched = u.ndim == 2
    nbatch, r = u.shape if batched else (1, u.shape[0])
    v = 0 if x is None else x.shape[-1]
    if not batched:
        shape = (v + 1,)
    else:
        shape = (nbatch,) if x is None else (nbatch, v + 1)
    shift = torch.empty(shape, dtype=torch.float32, device=u.device)
    status = _build.library().tx_head_shift(
        u.data_ptr(),
        None if x is None else x.data_ptr(),
        None if w is None else w.data_ptr(),
        shift.data_ptr(),
        min(HEAD_N, r),
        v,
        nbatch,
        r,
        int(u.dtype == torch.bfloat16),
        u.device.index,
        _stream_ptr(u.device),
    )
    _build.check(status, "tx_head_shift")
    LAUNCHES["head_shift"] += 1
    return shift


def finalize_comoments_cuda(part, shift, order: int, v: int):
    """Launch the finalize kernel on the chunk partials ``part (nchunk, nrep,
    (v+1)(order+1))`` float32 and the shift of :func:`head_shift_cuda`: one
    ``(v+1,)`` shift for every replicate (K2 / K3), or a row ``(nrep, v+1)``
    per batch row (K1 / K6).  :func:`finalize_comoments_plain` is the plain
    version.  Returns the epilogue's 5-tuple with batch axis ``nrep``,
    float32."""
    nchunk, nrep, m = part.shape
    rows = shift.shape == (nrep, v + 1)
    if m != (v + 1) * (order + 1) or not (rows or shift.shape == (v + 1,)) or not part.is_contiguous():
        msg = f"part {tuple(part.shape)} / shift {tuple(shift.shape)} do not fit order {order}, V {v}"
        raise ValueError(msg)

    # the five outputs are views of one allocation (one call of the caching
    # allocator instead of five: the wrapper is host bound at small R)
    shapes = ((nrep, v), (nrep,), (order + 1, nrep), (order + 1, nrep, v), (nrep,))
    sizes = [math.prod(shape) for shape in shapes]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=part.device)
    xave, uave, du, dxdu, wsum = (t.view(shape) for t, shape in zip(flat.split(sizes), shapes))
    status = _build.library().tx_finalize_comoments(
        part.data_ptr(),
        shift.data_ptr(),
        v + 1 if rows else 0,
        xave.data_ptr(),
        uave.data_ptr(),
        du.data_ptr(),
        dxdu.data_ptr(),
        wsum.data_ptr(),
        nchunk,
        nrep,
        v,
        order,
        part.device.index,
        _stream_ptr(part.device),
    )
    _build.check(status, "tx_finalize_comoments")
    LAUNCHES["finalize"] += 1
    return xave, uave, du, dxdu, wsum


def _resample_cuda(uv, x2, weight, order: int, nrep: int, *, freq=None, seed=0):
    """The K2 / K3 wrapper on CUDA tensors: checks and casts, then three
    launches (head shift, the bootstrap contraction of
    ``csrc/resample_tile.cuh`` with table counts when ``freq`` is given and
    in-kernel Poisson counts otherwise, finalize) and no tensor arithmetic
    in between; returns the epilogue's 5-tuple."""
    _check_cuda_inputs(uv, x2, weight, freq, backward=freq is not None)
    if order > MAX_ORDER:
        msg = f"order {order} exceeds the kernel's maximum {MAX_ORDER}"
        raise ValueError(msg)
    sdt = _stream_dtype(uv, x2)
    u = uv.to(sdt).contiguous()
    x = x2.to(sdt).contiguous()
    r, v = x.shape
    w = _weight_rows(weight, (r,), u.device)
    w = None if w is None else w.to(torch.float32).contiguous()
    m = (v + 1) * (order + 1)
    if freq is None:
        kind = _POISSON_KIND
        fptr = None
    else:
        freq, kind = _count_table(freq, nrep, r, u.device, wide=m > _URS_CB)
        fptr = freq.data_ptr()
    shift = head_shift_cuda(u, x, w)
    nr, npt, nchunk, chunk = _rows_launch(m, nrep, r, _TARGET_BLOCKS)
    part = torch.empty((nchunk, nrep, m), dtype=torch.float32, device=u.device)
    status = _build.library().tx_resample_comoments(
        u.data_ptr(),
        x.data_ptr(),
        None if w is None else w.data_ptr(),
        fptr,
        shift.data_ptr(),
        shift.data_ptr() + 4,
        part.data_ptr(),
        r,
        v,
        order,
        nrep,
        nchunk,
        chunk,
        nr,
        npt,
        int(sdt == torch.bfloat16),
        kind,
        signed64(seed),
        _thresholds(),
        u.device.index,
        _stream_ptr(u.device),
    )
    _build.check(status, "tx_resample_comoments")
    return finalize_comoments_cuda(part, shift, order, v)


def split_bf16x3(v):
    """A float32 tensor as three bfloat16 terms ``(b0, b1, b2)``: ``b0 =
    bf16(v)``, ``b1 = bf16(v - b0)``, ``b2 = bf16(v - b0 - b1)`` (round to
    nearest even, each difference exact in float32), the rows of K5's
    tensor-core kernel (``tx_split_bf16x3`` of csrc/common.cuh); ``b0 + b1 +
    b2`` carries ``v`` to ~24 bits."""
    v = v.to(torch.float32)
    terms = []
    for _ in range(3):
        b = v.to(torch.bfloat16)
        terms.append(b)
        v = v - b.to(torch.float32)
    return tuple(terms)


def mma_probe_cuda(a, b, c):
    """``a (16, 16) @ b (16, 8) + c`` on the tensor cores by one warp's
    ``mma.sync.m16n8k16`` through the fragment layout of
    ``tx_mma_bf16_16816`` (csrc/common.cuh): ``a``, ``b`` bfloat16, ``c``
    float32, contiguous, on one device.  Returns ``(16, 8)`` float32: the
    parity hook of the helper that K5's tensor-core kernel uses."""
    if a.shape != (16, 16) or b.shape != (16, 8) or c.shape != (16, 8):
        msg = f"need a (16, 16), b (16, 8), c (16, 8); got {tuple(a.shape)}, {tuple(b.shape)}, {tuple(c.shape)}"
        raise ValueError(msg)
    a = a.to(torch.bfloat16).contiguous()
    b = b.to(torch.bfloat16).contiguous()
    c = c.to(torch.float32).contiguous()
    d = torch.empty((16, 8), dtype=torch.float32, device=c.device)
    status = _build.library().tx_mma_probe(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(), c.device.index, _stream_ptr(c.device)
    )
    _build.check(status, "tx_mma_probe")
    return d


@functools.cache
def _thresholds():
    """The Poisson(1) thresholds as the kernels take them (a C array)."""
    return (ctypes.c_uint * len(POISSON1_THRESHOLDS))(*POISSON1_THRESHOLDS)


def _resample_outputs(out, nrep, order, val_shape, return_wsum=False):
    xave, uave, du, dxdu, wsum = out
    res = (
        xave.reshape((nrep, *val_shape)),
        uave,
        du,
        dxdu.reshape((order + 1, nrep, *val_shape)),
    )
    return res + (wsum,) if return_wsum else res


def resample_central_comoments_fused(uv, xv, freq, order: int, weight=None):
    r"""K2: per-replicate central comoments from a count table
    ``freq (nrep, R)`` (int8/16/32 and float32/bfloat16 stream as they are;
    other types are converted).  ``uv (R,)``, ``xv (R, *val)``; returns
    ``(xave (nrep, *val), uave (nrep,), du (order+1, nrep), dxdu (order+1,
    nrep, *val))``."""
    r = uv.shape[0]
    val_shape = tuple(xv.shape[1:])
    nrep = freq.shape[0]
    kind = _device_kind(uv, xv, 1)
    x2 = xv.reshape(r, -1)
    if kind == "cpu":
        out = resample_comoments_plain(uv, x2, torch.as_tensor(freq), order, weight)
    else:
        out = _resample_cuda(uv, x2, weight, order, nrep, freq=freq)
        LAUNCHES["K2"] += 1
    return _resample_outputs(out, nrep, order, val_shape)


def resample_central_comoments_poisson(
    uv, xv, nrep: int, order: int, weight=None, *, seed: int = 0, return_wsum: bool = False
):
    r"""K3: the K2 bootstrap with Poisson(1) counts drawn inside the kernel
    from ``seed`` (:func:`resample_poisson_plain` is its plain version), so
    the ``(nrep, R)`` table never exists.  Same return contract as K2;
    ``return_wsum=True`` appends the per-replicate total weight ``(nrep,)``."""
    r = uv.shape[0]
    val_shape = tuple(xv.shape[1:])
    kind = _device_kind(uv, xv, 1)
    x2 = xv.reshape(r, -1)
    if kind == "cpu":
        out = resample_poisson_plain(uv, x2, nrep, order, weight, seed=seed)
    else:
        out = _resample_cuda(uv, x2, weight, order, nrep, seed=seed)
        LAUNCHES["K3"] += 1
    return _resample_outputs(out, nrep, order, val_shape, return_wsum)


def poisson_counts_cuda(seed: int, nrep: int, nrec: int, device):
    """The counts K3 draws, written out by the card as an int32 table
    ``(nrep, nrec)``: the parity hook against :func:`_poisson_counts`."""
    out = torch.empty((nrep, nrec), dtype=torch.int32, device=device)
    lib = _build.library()
    status = lib.tx_poisson_counts(
        out.data_ptr(),
        nrec,
        nrep,
        signed64(seed),
        _thresholds(),
        out.device.index,
        _stream_ptr(out.device),
    )
    _build.check(status, "tx_poisson_counts")
    return out


def poisson_map_cuda(words=None, *, start: int = 0, n: int = 0, device=None):
    """The in-kernel draw's word → count map (the level lookup of
    ``csrc/philox.cuh``) held against the 9-compare sum by the card: the
    parity hook of the map.  On the uint32 words ``words`` (an int64 tensor
    of values below 2^32), or on the ``n`` words ``start .. start + n - 1``
    (mod 2^32) when ``words`` is None.  Returns ``(counts, stats)``:
    ``counts`` the map's count of each given word (int32; None for a range)
    and ``stats`` the int64 triple (words seen, words where the map and the
    compare sum differ, sum of the map's counts)."""
    if words is not None:
        device = words.device
        n = words.numel()
        words = words.to(torch.int64).reshape(-1).to(torch.int32).contiguous()  # the uint32 bits
        out = torch.empty(n, dtype=torch.int32, device=device)
    else:
        out = None
    stats = torch.zeros(3, dtype=torch.int64, device=device)
    status = _build.library().tx_poisson_map(
        None if words is None else words.data_ptr(),
        start,
        n,
        None if out is None else out.data_ptr(),
        stats.data_ptr(),
        _thresholds(),
        stats.device.index,
        _stream_ptr(stats.device),
    )
    _build.check(status, "tx_poisson_map")
    return out, stats


# ---------------------------------------------------------------------------
# K4: batched u-moment reduction
# ---------------------------------------------------------------------------


def _u_rows(uv, weight):
    """``uv (*batch, R)`` and its weight as ``(nbatch, R)`` rows (weight
    broadcast to ``uv``'s shape, or None)."""
    r = uv.shape[-1]
    w = _weight_rows(weight, tuple(uv.shape), uv.device)
    return uv.reshape(-1, r), None if w is None else w.reshape(-1, r)


def _u_stream(u2, w2):
    """Kernel operands of K4 and K5: the stream in its type (bfloat16 stays,
    the rest is float32), float32 weights, and the float32 shift ``(nbatch,)``
    of each row from the head-shift kernel (its first launch)."""
    sdt = torch.bfloat16 if u2.dtype == torch.bfloat16 else torch.float32
    u = u2.to(sdt).contiguous()
    w = None if w2 is None else w2.to(torch.float32).contiguous()
    return u, w, head_shift_cuda(u, None, w), int(sdt == torch.bfloat16)


def _plain_u_rows(u2, w2):
    """Compute-type rows (float64 stays, the rest is float32) and their head
    shift for the plain versions of K4 and K5."""
    dtype = torch.float64 if u2.dtype == torch.float64 else torch.float32
    u = u2.to(dtype)
    w = None if w2 is None else w2.to(dtype)
    return u, w, _head_shift(u, w)


def reduce_umoments_plain(u2, w2, order: int):
    """Plain torch version of K4 on ``u2 (nbatch, R)``, ``w2 (nbatch, R)``
    or None: head shift, shifted power sums, shared epilogue.  Returns
    ``(uave (nbatch,), du (order+1, nbatch), wsum (nbatch,))``."""
    u, w, s_u = _plain_u_rows(u2, w2)
    du = u - s_u[:, None]
    p = torch.ones_like(u) if w is None else w
    rows = []
    for _ in range(order + 1):
        rows.append(p.sum(-1))
        p = p * du
    return _u_epilogue(torch.stack(rows), s_u)


def _reduce_u_cuda(u2, w2, order: int):
    """The K4 wrapper on CUDA tensors: checks and casts, then three launches
    (the head shift of each row, the K1 / K6 reduction kernel with no value
    column, the u-moment finalize kernel with the sample blocks as the chunks
    of one replicate) and no tensor arithmetic in between; returns ``(uave
    (nbatch,), du (order+1, nbatch), wsum (nbatch,))``, float32."""
    _check_cuda_inputs(u2, w2, backward=True)
    if order > MAX_ORDER:
        msg = f"order {order} exceeds the kernel's maximum {MAX_ORDER}"
        raise ValueError(msg)
    u, w, s_u, bf16 = _u_stream(u2, w2)
    nbatch, r = u.shape
    nblk = _reduce_blocks(nbatch, r)
    part = torch.empty((nblk, 1, nbatch * (order + 1)), dtype=torch.float32, device=u.device)
    status = _build.library().tx_reduce_comoments(
        u.data_ptr(),
        None,
        None if w is None else w.data_ptr(),
        s_u.data_ptr(),
        part.data_ptr(),
        nbatch,
        r,
        0,
        order,
        nblk,
        bf16,
        u.device.index,
        _stream_ptr(u.device),
    )
    _build.check(status, "tx_reduce_comoments")
    uave, du, wsum = finalize_umoments_cuda(part, s_u, order, nbatch)
    return uave[0], du[:, 0], wsum[0]


def reduce_central_umoments_batched(uv, order: int, weight=None):
    r"""K4: central u-moments of every row of ``uv (*batch, R)`` (flat
    ``(R,)`` too), each row shifted by its own head mean.  Returns ``(uave
    (*batch,), du (order+1, *batch))`` with ``du[0] = 1``, ``du[1] = 0``.
    The kernel reads the u stream (bfloat16 streams as it is) and the
    weights only."""
    batch = tuple(uv.shape[:-1])
    u2, w2 = _u_rows(uv, weight)
    if _device_kind(uv) == "cpu":
        uave, du, _ = reduce_umoments_plain(u2, w2, order)
    else:
        uave, du, _ = _reduce_u_cuda(u2, w2, order)
        LAUNCHES["K4"] += 1
    return uave.reshape(batch), du.reshape((order + 1, *batch))


# ---------------------------------------------------------------------------
# K5: batched u-moment bootstrap, counts shared by every batch row
# ---------------------------------------------------------------------------


def _resample_u_sums_plain(u, w, counts, s_u, order: int):
    """``counts (nrep, n) @`` the shifted u rows of ``u (nbatch, n)``:
    ``sums (order+1, nrep, nbatch)``."""
    du = u - s_u[:, None]
    f = counts.to(device=u.device, dtype=u.dtype)
    p = torch.ones_like(u) if w is None else w
    rows = []
    for _ in range(order + 1):
        rows.append(f @ p.T)
        p = p * du
    return torch.stack(rows)


def resample_umoments_plain(u2, w2, counts, order: int):
    """Plain torch version of K5's consume: head shift per row, ``counts
    (nrep, R) @`` the shifted rows of ``u2 (nbatch, R)``, shared epilogue.
    Returns ``(uave (nrep, nbatch), du (order+1, nrep, nbatch), wsum (nrep,
    nbatch))``."""
    u, w, s_u = _plain_u_rows(u2, w2)
    return _u_epilogue(_resample_u_sums_plain(u, w, counts, s_u, order), s_u)


def resample_umoments_poisson_plain(u2, w2, nrep: int, order: int, *, seed: int = 0, chunk: int = 1 << 20):
    """Plain torch version of K5: :func:`resample_umoments_plain` on the
    counts of :func:`_poisson_counts` (the same for every batch row), drawn
    and consumed ``chunk`` samples at a time so that the ``(nrep, R)`` table
    never exists whole."""
    u, w, s_u = _plain_u_rows(u2, w2)
    r = u.shape[1]
    chunk = max(4, chunk // 4 * 4)
    sums = 0
    for j0 in range(0, r, chunk):
        j1 = min(r, j0 + chunk)
        counts = _poisson_counts(seed, nrep, j1 - j0, u.device, start=j0)
        sums = sums + _resample_u_sums_plain(
            u[:, j0:j1], None if w is None else w[:, j0:j1], counts, s_u, order
        )
    return _u_epilogue(sums, s_u)


def _next_pow2(n: int) -> int:
    return 1 << max(0, math.ceil(math.log2(max(1, n))))


def _u_thread_split(m: int, nrep: int):
    """Block layout of the shared contraction (K2, K3, K5, K7, K8): ``(nr, np)`` row-
    and replicate-threads, the rest of the 256 threads being sample lanes (at
    most 32).  Up to 16 rows take one row-thread (the few-rows kernel); a
    block of the many-rows kernel holds up to 512 contribution rows, so a
    64-macrostate grid at order 6 (448 rows) draws each count once per
    replicate block."""
    nr = min(32, _next_pow2(math.ceil(m / _URS_CB)))
    npt = min(_URS_THREADS // nr, 32, _next_pow2(math.ceil(nrep / _URS_RB)))
    npt = max(npt, _URS_THREADS // (nr * 32))  # at most 32 sample lanes
    return nr, npt


@functools.lru_cache(maxsize=256)
def _rows_launch(m: int, nrep: int, r: int, target_blocks: int):
    """Launch shape of the shared contraction (K2, K3, K5, K7, K8) for ``m``
    contribution rows, ``nrep`` replicates and ``r`` samples: ``(nr, np,
    nchunk, chunk)``, the thread split of :func:`_u_thread_split` and ``r``
    cut into ``nchunk`` chunks of ``chunk`` samples, a multiple of the sample
    tile of the kernel that ``m`` selects, about ``target_blocks`` blocks in
    all."""
    nr, npt = _u_thread_split(m, nrep)
    tile = _FEW_TILE if m <= _URS_CB else _URS_TILE
    ycount = math.ceil(nrep / (npt * _URS_RB))
    zcount = math.ceil(m / (nr * _URS_CB))
    ntile = math.ceil(r / tile)
    nchunk = max(1, min(ntile, math.ceil(target_blocks / (ycount * zcount))))
    chunk = math.ceil(ntile / nchunk) * tile
    return nr, npt, math.ceil(r / chunk), chunk


def _rows_smem(m: int, nr: int, npt: int) -> int:
    """Shared memory of a block of the shared contraction, in bytes
    (csrc/resample_tile.cuh): the few-rows kernel's two row tiles of 64
    groups x (8 or 16 slots + 1) x 16 bytes, or the many-rows kernel's sample
    tile of ``16 nr + 1`` row floats and ``4 np + 1`` counts a sample."""
    if m <= _URS_CB:
        return 2 * (_FEW_TILE // 4) * ((8 if m <= 8 else _URS_CB) + 1) * 16
    return 4 * _URS_TILE * (nr * _URS_CB + 1 + npt * _URS_RB + 1)


def _rows_shape_ok(m: int, r: int, nrep: int, nchunk: int, chunk: int, nr: int, npt: int) -> bool:
    """``resample_rows_shape_ok`` of csrc/resample_tile.cuh, which the kernel
    entries hold their arguments to."""
    pow2 = nr >= 1 and npt >= 1 and nr & (nr - 1) == 0 and npt & (npt - 1) == 0
    if not (pow2 and 1 <= m < 2**31 and nrep >= 1 and r >= 1 and nchunk >= 1 and chunk >= 1):
        return False
    if nr * npt > _URS_THREADS or _URS_THREADS // (nr * npt) > 32 or nchunk * chunk < r:
        return False
    ycount = math.ceil(nrep / (npt * _URS_RB))
    if m <= _URS_CB:
        return nr == 1 and chunk % _FEW_TILE == 0 and nchunk * ycount < 2**31
    return chunk % _URS_TILE == 0 and ycount <= 65535 and math.ceil(m / (nr * _URS_CB)) <= 65535


def _k5_on_tensor_cores(m: int, order: int) -> bool:
    """``umoment_on_tensor_cores`` of csrc/umoments_resample.cu: K5 past the
    few-rows kernel's 16 rows runs on the tensor cores, order 0 excepted."""
    return m > _URS_CB and order >= 1


@functools.lru_cache(maxsize=256)
def _mma_launch(m: int, nrep: int, r: int, target_blocks: int):
    """Launch shape of the tensor-core kernel (csrc/resample_tile.cuh) for
    ``m`` rows, ``nrep`` replicates and ``r`` samples: ``(nchunk, chunk)``,
    ``r`` cut into chunks of whole 32-sample tiles, about ``target_blocks``
    blocks of 128 replicates x 224 rows in all."""
    ycount = math.ceil(nrep / _MMA_REPS)
    zcount = math.ceil(m / _MMA_ROWS)
    ntile = math.ceil(r / _MMA_S)
    nchunk = max(1, min(ntile, math.ceil(target_blocks / (ycount * zcount))))
    chunk = math.ceil(ntile / nchunk) * _MMA_S
    return math.ceil(r / chunk), chunk


def finalize_umoments_plain(part, s_u, order: int, nbatch: int):
    """Plain torch version of the u-moment finalize kernel: the chunk
    partials ``part (nchunk, nrep, nbatch (order+1))`` of K5 (or the block
    partials of K4, ``nrep = 1``) summed in float64 and
    recentred exactly about the shift ``s_u (nbatch,)`` (:func:`_u_epilogue`).
    Returns ``(uave (nrep, nbatch), du (order+1, nrep, nbatch), wsum (nrep,
    nbatch))``, float32 (float64 partials keep float64)."""
    nrep = part.shape[1]
    sums = part.double().sum(0).reshape(nrep, nbatch, order + 1).permute(2, 0, 1)
    out = _u_epilogue(sums, s_u.double())
    dtype = torch.float64 if part.dtype == torch.float64 else torch.float32
    return tuple(t.to(dtype) for t in out)


def finalize_umoments_cuda(part, s_u, order: int, nbatch: int):
    """Launch the u-moment finalize kernel (csrc/finalize.cu) on the chunk
    partials ``part (nchunk, nrep, nbatch (order+1))`` float32 of K5 (or the
    block partials of K4, ``nrep = 1``) and the float32 shift
    ``s_u (nbatch,)``; :func:`finalize_umoments_plain` is the plain version.
    Returns ``(uave (nrep, nbatch), du (order+1, nrep, nbatch), wsum (nrep,
    nbatch))``, float32."""
    nchunk, nrep, m = part.shape
    if m != nbatch * (order + 1) or s_u.shape != (nbatch,) or not part.is_contiguous():
        msg = f"part {tuple(part.shape)} / shift {tuple(s_u.shape)} do not fit order {order}, {nbatch} rows"
        raise ValueError(msg)
    shapes = ((nrep, nbatch), (order + 1, nrep, nbatch), (nrep, nbatch))
    sizes = [math.prod(shape) for shape in shapes]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=part.device)
    uave, du, wsum = (t.view(shape) for t, shape in zip(flat.split(sizes), shapes))
    status = _build.library().tx_finalize_umoments(
        part.data_ptr(),
        s_u.data_ptr(),
        uave.data_ptr(),
        du.data_ptr(),
        wsum.data_ptr(),
        nchunk,
        nrep,
        nbatch,
        order,
        part.device.index,
        _stream_ptr(part.device),
    )
    _build.check(status, "tx_finalize_umoments")
    LAUNCHES["finalize_u"] += 1
    return uave, du, wsum


def _resample_u_cuda(u2, w2, nrep: int, order: int, *, freq=None, seed: int = 0):
    """Launch the head shift, K5 (Poisson counts drawn in the kernel, or the
    rows of the int32 table ``freq (nrep, R)``) and its finalize kernel, with
    no tensor arithmetic in between; returns ``(uave,
    du, wsum)`` with batch axes ``(nrep, nbatch)``, float32.  Up to 16 rows
    run in the few-rows kernel, more on the tensor cores
    (:func:`_k5_on_tensor_cores`)."""
    _check_cuda_inputs(u2, w2)
    if order > MAX_ORDER:
        msg = f"order {order} exceeds the kernel's maximum {MAX_ORDER}"
        raise ValueError(msg)
    u, w, s_u, bf16 = _u_stream(u2, w2)
    nbatch, r = u.shape
    fptr = None
    if freq is not None:
        freq = torch.as_tensor(freq, device=u.device)
        if freq.shape != (nrep, r):
            msg = f"freq must have shape {(nrep, r)}, got {tuple(freq.shape)}"
            raise ValueError(msg)
        freq = freq.to(torch.int32).contiguous()
        fptr = freq.data_ptr()
    m = nbatch * (order + 1)
    if _k5_on_tensor_cores(m, order):
        nr = npt = 1  # not read by the tensor-core kernel
        nchunk, chunk = _mma_launch(m, nrep, r, _TARGET_BLOCKS // 4)
    else:
        nr, npt, nchunk, chunk = _rows_launch(m, nrep, r, _TARGET_BLOCKS)
    part = torch.empty((nchunk, nrep, m), dtype=torch.float32, device=u.device)
    status = _build.library().tx_resample_umoments(
        u.data_ptr(),
        None if w is None else w.data_ptr(),
        fptr,
        s_u.data_ptr(),
        part.data_ptr(),
        nbatch,
        r,
        order,
        nrep,
        nchunk,
        chunk,
        nr,
        npt,
        bf16,
        signed64(seed),
        _thresholds(),
        u.device.index,
        _stream_ptr(u.device),
    )
    _build.check(status, "tx_resample_umoments")
    return finalize_umoments_cuda(part, s_u, order, nbatch)


def _resample_u_outputs(out, batch, return_wsum):
    uave, du, wsum = out
    nrep = uave.shape[0]
    res = (uave.reshape((nrep, *batch)), du.reshape((du.shape[0], nrep, *batch)))
    return res + (wsum.reshape((nrep, *batch)),) if return_wsum else res


def resample_central_umoments_batched_poisson(
    uv, nrep: int, order: int, weight=None, *, seed: int = 0, return_wsum: bool = False
):
    r"""K5: Poisson(1) bootstrap of the central u-moments of every row of
    ``uv (*batch, R)``.  Replicate ``r`` gives sample ``j`` the same count in
    every batch row (a replicate resamples whole configurations across a
    macrostate grid), drawn in the kernel from ``seed`` by K3's schedule
    (:func:`_poisson_counts`), so the ``(nrep, R)`` table never exists.
    Returns ``(uave (nrep, *batch), du (order+1, nrep, *batch))``;
    ``return_wsum=True`` appends the per-replicate weight sum ``(nrep,
    *batch)``.  :func:`resample_umoments_poisson_plain` is the plain
    version."""
    batch = tuple(uv.shape[:-1])
    u2, w2 = _u_rows(uv, weight)
    if _device_kind(uv) == "cpu":
        out = resample_umoments_poisson_plain(u2, w2, nrep, order, seed=seed)
    else:
        out = _resample_u_cuda(u2, w2, nrep, order, seed=seed)
        LAUNCHES["K5"] += 1
    return _resample_u_outputs(out, batch, return_wsum)


def resample_umoments_table_cuda(uv, freq, order: int, weight=None, *, return_wsum: bool = False):
    r"""K5's kernel consuming the rows of a count table ``freq (nrep, R)``
    (int32; other integer types are converted) in place of its draws: the
    parity hook that holds K5 against :func:`resample_umoments_plain` on a
    materialized table such as ``_poisson_counts(seed, nrep, R)``.  CUDA
    tensors only; same return contract as
    :func:`resample_central_umoments_batched_poisson`."""
    if _device_kind(uv) != "cuda":
        msg = "resample_umoments_table_cuda runs the CUDA kernel: give it CUDA tensors"
        raise ValueError(msg)
    batch = tuple(uv.shape[:-1])
    u2, w2 = _u_rows(uv, weight)
    out = _resample_u_cuda(u2, w2, freq.shape[0], order, freq=freq)
    LAUNCHES["K5"] += 1
    return _resample_u_outputs(out, batch, return_wsum)


# ---------------------------------------------------------------------------
# K7 / K8: perturbation bootstrap, counts from a table or drawn in the kernel
# ---------------------------------------------------------------------------


def _perturb_prep(ev, xv, dtype):
    """``ev (A, R)`` and ``xv (R, *val)`` as contiguous ``dtype`` operands
    ``(ev, x2 (R, V))`` on ``ev``'s device."""
    if ev.ndim != 2:
        msg = f"ev must be (targets, samples), got {tuple(ev.shape)}"
        raise ValueError(msg)
    kind = ev.device.type
    if kind not in ("cpu", "cuda"):
        msg = f"the perturbation kernels run on cuda or cpu tensors, not {ev.device}"
        raise ValueError(msg)
    if xv.device != ev.device:
        msg = f"ev is on {ev.device} but xv on {xv.device}"
        raise ValueError(msg)
    r = ev.shape[1]
    if xv.shape[0] != r:
        msg = f"xv {tuple(xv.shape)} does not lead with the {r} samples of ev"
        raise ValueError(msg)
    return ev.to(dtype).contiguous(), xv.reshape(r, -1).to(dtype).contiguous()


def _perturb_plain_dtype(ev, xv):
    return torch.float64 if torch.float64 in (ev.dtype, xv.dtype) else torch.float32


def _perturb_sums_plain(e, x2, counts):
    """``sum_j counts[r, j] e[a, j] [x2[j] | 1]`` → ``(A, nrep, V+1)``."""
    # rows (A, V+1, R) against the counts' transpose: one product with no
    # reshape of a symbolic size, so the sums also trace for an exported program
    xt = torch.cat([x2.T, torch.ones_like(e[:1])], dim=0)
    y = e[:, None, :] * xt[None]
    return (y @ counts.to(device=e.device, dtype=e.dtype).T).mT


def resample_perturb_plain(ev, xv, counts, *, chunk: int = 1 << 20):
    """Plain torch version of K7: for target ``a`` and replicate ``r`` the
    sums ``sum_j counts[r, j] ev[a, j] [xv[j] | 1]`` as ``(A, nrep, V+1)``,
    ``chunk`` samples at a time.  ``ev (A, R)``, ``xv (R, *val)``,
    ``counts (nrep, R)``; float64 inputs compute in float64, the rest in
    float32."""
    e, x2 = _perturb_prep(ev, xv, _perturb_plain_dtype(ev, xv))
    r = e.shape[1]
    if tuple(counts.shape[1:]) != (r,):
        msg = f"counts must have shape (nrep, {r}), got {tuple(counts.shape)}"
        raise ValueError(msg)
    sums = 0
    for j0 in range(0, r, chunk):
        j1 = min(r, j0 + chunk)
        sums = sums + _perturb_sums_plain(e[:, j0:j1], x2[j0:j1], counts[:, j0:j1])
    return sums


def resample_perturb_poisson_plain(ev, xv, nrep: int, *, seed: int = 0, chunk: int = 1 << 20):
    """Plain torch version of K8: :func:`resample_perturb_plain` on the counts
    of :func:`_poisson_counts`, drawn and consumed ``chunk`` samples at a time
    so that the ``(nrep, R)`` table never exists whole."""
    e, x2 = _perturb_prep(ev, xv, _perturb_plain_dtype(ev, xv))
    r = e.shape[1]
    chunk = max(4, chunk // 4 * 4)
    sums = 0
    for j0 in range(0, r, chunk):
        j1 = min(r, j0 + chunk)
        counts = _poisson_counts(seed, nrep, j1 - j0, e.device, start=j0)
        sums = sums + _perturb_sums_plain(e[:, j0:j1], x2[j0:j1], counts)
    return sums


def _resample_perturb_cuda(ev, xv, nrep: int, *, freq=None, seed: int = 0):
    """Launch the perturbation bootstrap kernel (table counts when ``freq``
    is given, in-kernel Poisson counts otherwise); returns the sums
    ``(A, nrep, V+1)``, float32."""
    _check_cuda_inputs(ev, xv, freq)
    e, x2 = _perturb_prep(ev, xv, torch.float32)
    na, r = e.shape
    v = x2.shape[1]
    if nrep < 1 or r < 1 or na < 1:
        msg = f"need at least one target, sample and replicate; got ev {tuple(e.shape)}, nrep {nrep}"
        raise ValueError(msg)
    if freq is None:
        kind = _POISSON_KIND
        fptr = None
    else:
        freq, kind = _count_table(freq, nrep, r, e.device)
        fptr = freq.data_ptr()
    m = na * (v + 1)
    nr, npt, nchunk, chunk = _rows_launch(m, nrep, r, _PERTURB_TARGET_BLOCKS)
    part = torch.empty((nchunk, nrep, m), dtype=torch.float32, device=e.device)
    lib = _build.library()
    status = lib.tx_resample_perturb(
        e.data_ptr(),
        x2.data_ptr(),
        fptr,
        part.data_ptr(),
        na,
        r,
        v,
        nrep,
        nchunk,
        chunk,
        nr,
        npt,
        kind,
        signed64(seed),
        _thresholds(),
        e.device.index,
        _stream_ptr(e.device),
    )
    _build.check(status, "tx_resample_perturb")
    # deterministic second pass: (nrep, A (V+1)) -> (A, nrep, V+1)
    sums = part.double().sum(0).reshape(nrep, na, v + 1).permute(1, 0, 2)
    return sums.to(torch.float32).contiguous()


def resample_perturb_freq(ev, xv, freq):
    r"""K7: bootstrap sums of perturbation-reweighted samples against a count
    table.  ``ev (A, R)`` holds the max-shift-stabilized reweighting factors
    of ``pipeline._perturb_weights`` (sample weights and zero masks folded
    in), ``xv (R, *val)`` the observable, ``freq (nrep, R)`` the counts
    (int8/16/32 and float32/bfloat16 stream as they are; other types are
    converted).  Returns ``(A, nrep, V+1)``: per target and replicate the
    numerators ``sum_j f_rj e_a(j) x_j`` and, last, the weight sum
    ``sum_j f_rj e_a(j)``.  The caller divides; a replicate or target of zero
    weight sum returns zeros here.  On the card the operands are cast to
    float32 and any number of contribution rows ``A (V+1)`` runs in the
    kernel (it loops over 512-row tiles)."""
    if ev.device.type == "cpu":
        return resample_perturb_plain(ev, xv, torch.as_tensor(freq))
    out = _resample_perturb_cuda(ev, xv, freq.shape[0], freq=freq)
    LAUNCHES["K7"] += 1
    return out


def resample_perturb_poisson(ev, xv, nrep: int, *, seed: int = 0):
    r"""K8: :func:`resample_perturb_freq` with Poisson(1) counts drawn inside
    the kernel from ``seed`` by K3's schedule (:func:`_poisson_counts`), so
    the ``(nrep, R)`` table never exists: K8 on ``seed`` equals K7 on
    ``poisson_counts_cuda(seed, nrep, R)`` bit for bit, and at ``ev = 1`` its
    last column is K3's per-replicate weight sum.
    :func:`resample_perturb_poisson_plain` is the plain version."""
    if ev.device.type == "cpu":
        return resample_perturb_poisson_plain(ev, xv, nrep, seed=seed)
    out = _resample_perturb_cuda(ev, xv, nrep, seed=seed)
    LAUNCHES["K8"] += 1
    return out
