r"""Hand-written CUDA kernels for the (co)moment reduction and bootstrap,
with the plain torch version of each beside it.

Counterpart of ``thermoextrap_tpu/ops/moments_pallas.py`` for the kernels of
the β-extrapolation main path:

======  ======================================  ===============================
kernel  wrapper here                            CUDA source
======  ======================================  ===============================
K1      :func:`reduce_central_comoments_fused`   ``csrc/comoments_reduce.cu``
K6      :func:`reduce_central_comoments_batched` ``csrc/comoments_reduce.cu``
K2      :func:`resample_central_comoments_fused` ``csrc/comoments_resample.cu``
K3      :func:`resample_central_comoments_poisson` ``csrc/comoments_resample.cu``
======  ======================================  ===============================

Every wrapper runs its kernel on a CUDA tensor and its plain torch version on
a CPU tensor; any other device raises.  On the card the sample streams are
float32 or bfloat16 (float64 is cast to float32 first), weights are float32,
accumulation is float32 and the results are float32.  The plain versions keep
float64.  Both share one algorithm: the shift is the weighted mean of the
first :data:`HEAD_N` samples (:func:`_head_shift`), the kernel sums shifted
powers, and one epilogue (:func:`_shifted_epilogue`) recentres the sums
exactly.  Each wrapper adds one to ``LAUNCHES[name]`` when it launches its
kernel.  The kernels are forward only: a CUDA input that requires grad
raises, and the CPU path differentiates by autograd.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .convert import fix_central_du, fix_central_dxdu, shift_raw_comoments, shift_raw_moments
from .resample import POISSON1_THRESHOLDS

__all__ = [
    "HEAD_N",
    "LAUNCHES",
    "poisson_counts_cuda",
    "reduce_central_comoments_batched",
    "reduce_central_comoments_fused",
    "reduce_comoments_plain",
    "resample_central_comoments_fused",
    "resample_central_comoments_poisson",
    "resample_comoments_plain",
    "resample_poisson_plain",
    "reset_launches",
]

HEAD_N = 8192  # samples behind the shift estimate
MAX_ORDER = 15  # TX_MAX_ORDER of csrc/common.cuh
LAUNCHES = {"K1": 0, "K2": 0, "K3": 0, "K6": 0}

_REDUCE_THREADS = 256  # TX_REDUCE_THREADS of comoments_reduce.cu
_RS_REPS = 32  # TX_RS_REPS of comoments_resample.cu
_RS_CB = 16  # TX_RS_CB
_RS_TILE = 512  # TX_RS_TILE
_TARGET_BLOCKS = 1056  # 8 blocks of 256 threads on each of the H100's 132 SMs

# count-table codes of tx_resample_comoments
_COUNT_KIND = {
    torch.int8: 0,
    torch.int16: 1,
    torch.int32: 2,
    torch.float32: 3,
    torch.bfloat16: 4,
}
_POISSON_KIND = 5

_MASK32 = 0xFFFFFFFF


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


def _head_shift(u2, w2, x3, head_n: int = HEAD_N):
    """Per-row shift ``(s_u (nbatch,), s_x (nbatch, V))``: the weighted mean
    of the first ``head_n`` samples of ``u2 (nbatch, R)``, ``x3 (nbatch, R,
    V)``, computed in ``u2``'s type.  A head of zero weight gives shift 0 (the
    recentring is exact for any finite shift; 0/0 would poison every
    output)."""
    head = min(head_n, u2.shape[1])
    uh = u2[:, :head]
    xh = x3[:, :head].to(uh.dtype)
    wh = torch.ones_like(uh) if w2 is None else w2[:, :head].to(uh.dtype)
    hsum = wh.sum(-1)
    ok = hsum > 0
    safe = torch.where(ok, hsum, torch.ones_like(hsum))
    zero = torch.zeros((), dtype=uh.dtype, device=uh.device)
    s_u = torch.where(ok, (wh * uh).sum(-1) / safe, zero)
    s_x = torch.where(ok[:, None], (wh[:, :, None] * xh).sum(1) / safe[:, None], zero)
    return s_u, s_x


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
    wsum = sum_u[0]
    ok = wsum > 0
    safe = torch.where(ok, wsum, torch.ones_like(wsum))
    m = sum_u / safe
    m = torch.cat([torch.where(ok, m[0], torch.ones_like(m[0]))[None], m[1:]], dim=0)
    c = sum_x / safe[..., None]
    uave = m[1] + s_u
    xave = c[0] + s_x
    du = shift_raw_moments(m, m[1])
    x_du = shift_raw_comoments(c, m[1][..., None])
    dxdu = x_du - c[0][None] * du[..., None]
    return xave, uave, fix_central_du(du), fix_central_dxdu(dxdu), wsum


def _check_cuda_inputs(*tensors):
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.requires_grad:
            msg = (
                "the CUDA moment kernels are forward only (their backward "
                "kernels are not ported yet); detach the inputs or run on CPU"
            )
            raise NotImplementedError(msg)


def _device_kind(uv, xv, nlead: int) -> str:
    """``"cpu"`` or ``"cuda"``; raises unless ``xv`` lies on ``uv``'s device
    and its leading ``nlead`` axes are ``uv``'s (batch and sample) axes."""
    kind = uv.device.type
    if kind not in ("cpu", "cuda"):
        msg = f"the moment kernels run on cuda or cpu tensors, not {uv.device}"
        raise ValueError(msg)
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


def _reduce_cuda(u2, x3, w2, order: int):
    """Launch the reduction kernel; returns the epilogue's 5-tuple (float32)."""
    _check_cuda_inputs(u2, x3, w2)
    if order > MAX_ORDER:
        msg = f"order {order} exceeds the kernel's maximum {MAX_ORDER}"
        raise ValueError(msg)
    sdt = _stream_dtype(u2, x3)
    u = u2.to(sdt).contiguous()
    x = x3.to(sdt).contiguous()
    w = None if w2 is None else w2.to(torch.float32).contiguous()
    nbatch, r = u.shape
    v = x.shape[2]
    # the shift reads only the head: convert that, not the whole stream
    head = slice(0, HEAD_N)
    s_u, s_x = _head_shift(u[:, head].to(torch.float32), None if w is None else w[:, head], x[:, head])
    s_u = s_u.contiguous()
    s_x = s_x.contiguous()
    nblk = max(1, min(1024, math.ceil(r / (_REDUCE_THREADS * 16))))
    part_u = torch.empty((nbatch, nblk, order + 1), dtype=torch.float32, device=u.device)
    part_x = torch.empty((nbatch, v, nblk, order + 1), dtype=torch.float32, device=u.device)
    lib = _build.library()
    status = lib.tx_reduce_comoments(
        u.data_ptr(),
        x.data_ptr(),
        None if w is None else w.data_ptr(),
        s_u.data_ptr(),
        s_x.data_ptr(),
        part_u.data_ptr(),
        part_x.data_ptr(),
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
    # deterministic second pass over the block partials, in float64
    sum_u = part_u.double().sum(1).T
    sum_x = part_x.double().sum(2).permute(2, 0, 1)
    out = _shifted_epilogue(sum_u, sum_x, s_u.double(), s_x.double())
    return tuple(t.to(torch.float32) for t in out)


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


def _philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors holding 32-bit words.  The 32x32 bit
    product overflows int64 but its bits are right mod 2^64, so only the
    masked high and low words are read, never the signed product itself."""
    for i in range(10):
        if i:
            k0 = (k0 + 0x9E3779B9) & _MASK32
            k1 = (k1 + 0xBB67AE85) & _MASK32
        p0 = c0 * 0xD2511F53
        p1 = c2 * 0xCD9E8D57
        hi0 = (p0 >> 32) & _MASK32
        lo0 = p0 & _MASK32
        hi1 = (p1 >> 32) & _MASK32
        lo1 = p1 & _MASK32
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _poisson_counts(seed: int, nrep: int, nrec: int, device=None, *, start: int = 0):
    """The Poisson(1) counts K3 draws for samples ``start .. start+nrec-1``
    (``start`` a multiple of 4), as an int32 table ``(nrep, nrec)``: the
    count of replicate r at sample j is word ``j & 3`` of Philox4x32-10 with
    counter ``((j >> 2) mod 2^32, r, (j >> 34) mod 2^32, 0)`` and key
    ``(seed mod 2^32, (seed >> 32) mod 2^32)``, mapped by the truncated
    Poisson(1) thresholds (csrc/comoments_resample.cu)."""
    if start % 4:
        msg = f"start must be a multiple of 4, got {start}"
        raise ValueError(msg)
    seed = int(seed)
    k0 = seed & _MASK32
    k1 = (seed >> 32) & _MASK32
    ngroup = (nrec + 3) // 4
    g = torch.arange(start // 4, start // 4 + ngroup, dtype=torch.int64, device=device)
    r = torch.arange(nrep, dtype=torch.int64, device=device)[:, None]
    c0 = (g & _MASK32)[None, :].expand(nrep, ngroup)
    c2 = ((g >> 32) & _MASK32)[None, :].expand(nrep, ngroup)
    c1 = r.expand(nrep, ngroup)
    words = _philox4x32_10(c0, c1, c2, torch.zeros_like(c0), k0, k1)
    counts = []
    for word in words:
        n = torch.zeros(word.shape, dtype=torch.int32, device=device)
        for t in POISSON1_THRESHOLDS:
            n += (word > t).to(torch.int32)
        counts.append(n)
    return torch.stack(counts, dim=-1).reshape(nrep, 4 * ngroup)[:, :nrec].contiguous()


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


def _resample_cuda(uv, x2, weight, order: int, nrep: int, *, freq=None, seed=0):
    """Launch the bootstrap kernel (table counts when ``freq`` is given,
    in-kernel Poisson counts otherwise); returns the epilogue's 5-tuple."""
    _check_cuda_inputs(uv, x2, weight, freq)
    if order > MAX_ORDER:
        msg = f"order {order} exceeds the kernel's maximum {MAX_ORDER}"
        raise ValueError(msg)
    sdt = _stream_dtype(uv, x2)
    u = uv.to(sdt).contiguous()
    x = x2.to(sdt).contiguous()
    r, v = x.shape
    w = _weight_rows(weight, (r,), u.device)
    w = None if w is None else w.to(torch.float32).contiguous()
    head = slice(0, HEAD_N)
    s_u, s_x = _head_shift(
        u[None, head].to(torch.float32), None if w is None else w[None, head], x[None, head]
    )
    s_u = s_u.contiguous()
    s_x = s_x.contiguous()
    if freq is None:
        kind = _POISSON_KIND
        fptr = None
    else:
        freq = torch.as_tensor(freq, device=u.device)
        if freq.shape != (nrep, r):
            msg = f"freq must have shape {(nrep, r)}, got {tuple(freq.shape)}"
            raise ValueError(msg)
        if freq.dtype not in _COUNT_KIND:
            # wide or unsigned integer tables stream as int32; other float
            # tables as float32 (fractional counts must stay fractional)
            freq = freq.to(torch.float32 if freq.is_floating_point() else torch.int32)
        freq = freq.contiguous()
        kind = _COUNT_KIND[freq.dtype]
        fptr = freq.data_ptr()
    m = (v + 1) * (order + 1)
    ycount = math.ceil(nrep / _RS_REPS)
    zcount = math.ceil(m / _RS_CB)
    ntile = math.ceil(r / _RS_TILE)
    nchunk = max(1, min(ntile, math.ceil(_TARGET_BLOCKS / (ycount * zcount))))
    chunk = math.ceil(ntile / nchunk) * _RS_TILE
    nchunk = math.ceil(r / chunk)
    part = torch.empty((nchunk, nrep, m), dtype=torch.float32, device=u.device)
    thresholds = _thresholds()  # kept alive across the call
    lib = _build.library()
    status = lib.tx_resample_comoments(
        u.data_ptr(),
        x.data_ptr(),
        None if w is None else w.data_ptr(),
        fptr,
        s_u.data_ptr(),
        s_x.data_ptr(),
        part.data_ptr(),
        r,
        v,
        order,
        nrep,
        nchunk,
        chunk,
        int(sdt == torch.bfloat16),
        kind,
        int(seed),
        thresholds,
        u.device.index,
        _stream_ptr(u.device),
    )
    _build.check(status, "tx_resample_comoments")
    sums = part.double().sum(0)  # (nrep, m), deterministic second pass
    sum_u = sums[:, : order + 1].T
    sum_x = sums[:, order + 1 :].reshape(nrep, v, order + 1).permute(2, 0, 1)
    out = _shifted_epilogue(
        sum_u, sum_x, s_u.double().expand(nrep), s_x.double().expand(nrep, -1)
    )
    return tuple(t.to(torch.float32) for t in out)


def _thresholds():
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
        int(seed),
        _thresholds(),
        out.device.index,
        _stream_ptr(out.device),
    )
    _build.check(status, "tx_poisson_counts")
    return out
