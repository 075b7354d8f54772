"""Compiled host (CPU) engines of the torch port.

Two C++ sources under ``csrc/host/``, each built once on first use with the
system ``g++`` into ``thermoextrap_tpu_torch/_build/host/`` and loaded with
``ctypes`` (the JAX package's ``native/`` sources, held equal to them in
code by a test):

- ``fastloader.cpp``: a whitespace / comma table parser
  (:func:`loadtxt_fast`), the ``np.loadtxt`` of the ingest path;
- ``cmoments.cpp``: float64 central / raw comoment reduction and the
  count-table bootstrap, the compiled-CPU role cmomy's numba kernels play
  for the reference package.  :func:`..ops.dispatch.set_impl` ``("native")``
  routes host arrays here.

The engines take numpy arrays or CPU tensors and return numpy arrays.  A
tensor on any other device raises a ``ValueError``: it is never copied to the
host in silence.  Where the library cannot be built (no compiler, no
trustworthy build directory), the moment functions run the port's plain
float64 torch reduction on the CPU and the loader ``np.loadtxt``, with a
logged warning.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import stat
import subprocess
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger(__name__)

__all__ = [
    "available",
    "loadtxt_fast",
    "reduce_central_comoments",
    "reduce_raw_comoments",
    "resample_central_comoments",
]

_PKG = Path(__file__).resolve().parent.parent
SOURCE_DIR = _PKG / "csrc" / "host"
BUILD_DIR = _PKG / "_build" / "host"
_LIBS: dict[str, object] = {}  # name -> CDLL, or None after a failed build

_i64 = ctypes.c_int64
_dp = ctypes.POINTER(ctypes.c_double)


def _trusted(path: Path) -> bool:
    """Owned by this user and writable by no one else."""
    st = path.stat()
    owned = not hasattr(os, "getuid") or st.st_uid == os.getuid()
    return owned and not (st.st_mode & (stat.S_IWGRP | stat.S_IWOTH))


def _cache_dir() -> Path | None:
    """The 0700 build directory; never one another user could own.

    A library someone else planted under the (computable) content-hash name
    would be executed by ``ctypes.CDLL`` in this process, so the directory
    is created 0700 and rejected unless it is a real directory owned by us
    with no group or other write bits.
    """
    d = BUILD_DIR
    try:
        d.mkdir(parents=True, exist_ok=True, mode=0o700)
        if d.is_symlink() or not d.is_dir() or not _trusted(d):
            return None
    except OSError:
        return None
    return d


def _build_lib(src: Path) -> Path | None:
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    cache_dir = _cache_dir()
    if cache_dir is None:
        logger.warning("no trustworthy native build dir; using fallback for %s", src.name)
        return None
    lib_path = cache_dir / f"{src.stem}_{tag}.so"
    if lib_path.exists():
        return lib_path if _trusted(lib_path) else None  # untrusted: neither load nor overwrite
    # build to a private temporary name, then publish atomically
    tmp = cache_dir / f".{src.stem}_{tag}.{os.getpid()}.so"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", str(tmp), str(src)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.chmod(tmp, 0o500)
        os.replace(tmp, lib_path)
    except (OSError, subprocess.SubprocessError) as err:
        logger.warning("%s build failed (%s); using fallback", src.name, err)
        tmp.unlink(missing_ok=True)
        return None
    return lib_path


def _get_lib(name: str, declare):
    """Build and load ``<name>.cpp`` once; ``declare(lib)`` sets the prototypes."""
    if name not in _LIBS:
        path = _build_lib(SOURCE_DIR / f"{name}.cpp")
        if path is None:
            _LIBS[name] = None
        else:
            lib = ctypes.CDLL(str(path))
            declare(lib)
            _LIBS[name] = lib
    return _LIBS[name]


def available() -> bool:
    """True if the compiled moments engine is usable on this host."""
    return _cmoments() is not None


# ---------------------------------------------------------------- fastloader


def _declare_fastloader(lib) -> None:
    lib.ft_count.restype = ctypes.c_int
    lib.ft_count.argtypes = [ctypes.c_char_p, ctypes.POINTER(_i64), ctypes.POINTER(_i64)]
    lib.ft_load.restype = ctypes.c_int
    lib.ft_load.argtypes = [ctypes.c_char_p, _dp, _i64, _i64]


def loadtxt_fast(path, usecols=None):
    """Drop-in ``np.loadtxt`` for whitespace / comma-delimited float tables
    ('#' comments skipped), parsed by the C++ loader; ``np.loadtxt`` where
    the library is unavailable or rejects the file."""
    lib = _get_lib("fastloader", _declare_fastloader)
    if lib is None:
        return np.loadtxt(path, usecols=usecols)
    cpath = str(path).encode()
    rows = _i64()
    cols = _i64()
    if lib.ft_count(cpath, ctypes.byref(rows), ctypes.byref(cols)) != 0:
        return np.loadtxt(path, usecols=usecols)
    out = np.empty((rows.value, cols.value), dtype=np.float64)
    if lib.ft_load(cpath, out.ctypes.data_as(_dp), rows.value, cols.value) != 0:
        return np.loadtxt(path, usecols=usecols)
    # select columns before the single-column squeeze, so that an
    # out-of-range column raises as in np.loadtxt
    if usecols is not None:
        out = out[:, usecols]
    if out.ndim == 2 and out.shape[1] == 1:
        out = out[:, 0]
    return out


# ----------------------------------------------------------------- cmoments


def _declare_cmoments(lib) -> None:
    lib.cm_reduce_central.restype = ctypes.c_int
    lib.cm_reduce_central.argtypes = [_dp, _dp, _dp, _i64, _i64, _i64, _dp, _dp, _dp, _dp]
    lib.cm_reduce_central_batched.restype = ctypes.c_int
    lib.cm_reduce_central_batched.argtypes = [_dp, _dp, _dp, _i64, _i64, _i64, _i64, _dp, _dp, _dp, _dp]
    lib.cm_reduce_raw.restype = ctypes.c_int
    lib.cm_reduce_raw.argtypes = [_dp, _dp, _dp, _i64, _i64, _i64, _dp, _dp]
    lib.cm_resample_central.restype = ctypes.c_int
    lib.cm_resample_central.argtypes = [_dp, _dp, _dp, _dp, _i64, _i64, _i64, _i64, _dp, _dp, _dp, _dp]


def _cmoments():
    return _get_lib("cmoments", _declare_cmoments)


def _host(a, name: str):
    """A numpy array or CPU tensor as a numpy array (``None`` passes); a
    tensor on another device raises."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            msg = (
                f"native engine: {name} is a tensor on {a.device}; the host engine "
                "takes numpy arrays or CPU tensors (device tensors take the kernels)"
            )
            raise ValueError(msg)
        return a.detach().to(torch.float64).numpy()
    return a


def _as_f64(a):
    return np.ascontiguousarray(np.asarray(a, dtype=np.float64))


def _buf(a):
    return a.ctypes.data_as(_dp)


def _wbuf(uv, weight):
    """Weight buffer broadcast to ``uv.shape``, or a NULL pointer."""
    if weight is None:
        return None, ctypes.cast(None, _dp)
    w = np.ascontiguousarray(np.broadcast_to(np.asarray(weight, dtype=np.float64), uv.shape))
    return w, _buf(w)  # keep `w` alive alongside its pointer


def _check(rc: int, what: str) -> None:
    # a zero-total-weight stream is no error: the C kernels give the 0/0
    # convention (NaN means, pinned du[0]/du[1]/dxdu[0]) of the plain path
    if rc != 0:
        msg = f"{what}: native kernel error {rc}"
        raise RuntimeError(msg)


def _split_shapes(uv, xv, val_ndim: int):
    batch = uv.shape[:-1]
    nrec = uv.shape[-1]
    val_shape = xv.shape[uv.ndim :]
    if val_ndim != len(val_shape) or xv.shape[: uv.ndim] != uv.shape:
        msg = f"{val_ndim=} inconsistent with xv shape {xv.shape} and uv shape {uv.shape}"
        raise ValueError(msg)
    return batch, nrec, val_shape


def reduce_central_comoments(uv, xv, order: int, weight=None, val_ndim: int = 1):
    """Compiled host two-pass central comoment reduction, float64.

    The contract of :func:`..ops.moments.reduce_central_comoments`
    (``uv (*batch, R)``, ``xv (*batch, R, *val)`` → ``(xave, uave, du,
    dxdu)``, moment order leading), as numpy arrays.  A zero-total-weight
    stream (or batch row) gives the plain path's 0/0 convention: NaN means
    and moments with ``du[0]=1, du[1]=0, dxdu[0]=0``.
    """
    uv, xv, weight = _host(uv, "uv"), _host(xv, "xv"), _host(weight, "weight")
    lib = _cmoments()
    if lib is None:
        from . import _fallback

        return _fallback.reduce_central(uv, xv, order, weight, val_ndim)
    uv = _as_f64(uv)
    xv = _as_f64(xv)
    batch, nrec, val_shape = _split_shapes(uv, xv, val_ndim)
    nval = int(np.prod(val_shape, dtype=np.int64)) if val_shape else 1
    w, wp = _wbuf(uv, weight)
    n1 = order + 1

    if not batch:
        uave = np.empty((), np.float64)
        xave = np.empty(nval, np.float64)
        du = np.empty(n1, np.float64)
        dxdu = np.empty((n1, nval), np.float64)
        rc = lib.cm_reduce_central(
            _buf(uv), _buf(xv), wp, nrec, nval, order, _buf(uave), _buf(xave), _buf(du), _buf(dxdu)
        )
        _check(rc, "reduce_central_comoments")
        return xave.reshape(val_shape), uave, du, dxdu.reshape((n1, *val_shape))

    nb = int(np.prod(batch, dtype=np.int64))
    uvf = uv.reshape(nb, nrec)
    xvf = xv.reshape(nb, nrec, nval)
    uave = np.empty(nb, np.float64)
    xave = np.empty((nb, nval), np.float64)
    du = np.empty((nb, n1), np.float64)
    dxdu = np.empty((nb, n1, nval), np.float64)
    rc = lib.cm_reduce_central_batched(
        _buf(uvf), _buf(xvf), wp, nb, nrec, nval, order, _buf(uave), _buf(xave), _buf(du), _buf(dxdu)
    )
    _check(rc, "reduce_central_comoments")
    return (
        xave.reshape(batch + val_shape),
        uave.reshape(batch),
        np.moveaxis(du, -1, 0).reshape((n1, *batch)),
        np.moveaxis(dxdu, 1, 0).reshape((n1, *batch, *val_shape)),
    )


def reduce_raw_comoments(uv, xv, order: int, weight=None, val_ndim: int = 1):
    """Compiled host raw comoment reduction (the flat ``batch=()`` path;
    batched input takes the plain reduction): ``u[n] = <w u^n>/<w>``
    ``(order+1,)``, ``xu[n] = <w x u^n>/<w>`` ``(order+1, *val)``, numpy
    float64."""
    uv, xv, weight = _host(uv, "uv"), _host(xv, "xv"), _host(weight, "weight")
    lib = _cmoments()
    uv = _as_f64(uv)
    xv = _as_f64(xv)
    batch, nrec, val_shape = _split_shapes(uv, xv, val_ndim)
    if lib is None or batch:
        from . import _fallback

        return _fallback.reduce_raw(uv, xv, order, weight, val_ndim)
    nval = int(np.prod(val_shape, dtype=np.int64)) if val_shape else 1
    w, wp = _wbuf(uv, weight)
    n1 = order + 1
    u = np.empty(n1, np.float64)
    xu = np.empty((n1, nval), np.float64)
    rc = lib.cm_reduce_raw(_buf(uv), _buf(xv), wp, nrec, nval, order, _buf(u), _buf(xu))
    _check(rc, "reduce_raw_comoments")
    return u, xu.reshape((n1, *val_shape))


def resample_central_comoments(uv, xv, freq, order: int, weight=None):
    """Compiled host count-table bootstrap: exact two-pass central
    comoments per replicate (weight ``freq[rep, r] * w[r]``).

    The contract of :func:`..ops.resample.resample_central_comoments`:
    ``uv (R,)``, ``xv (R, *val)``, ``freq (nrep, R)`` → ``(xave (nrep,
    *val), uave (nrep,), du (order+1, nrep), dxdu (order+1, nrep, *val))``;
    an all-zero replicate row gets the plain path's finite stand-in.  Numpy
    float64.
    """
    uv, xv, freq, weight = _host(uv, "uv"), _host(xv, "xv"), _host(freq, "freq"), _host(weight, "weight")
    lib = _cmoments()
    if lib is None:
        from . import _fallback

        return _fallback.resample_central(uv, xv, freq, order, weight)
    uv = _as_f64(uv)
    xv = _as_f64(xv)
    freq = _as_f64(freq)
    if uv.ndim != 1 or freq.ndim != 2 or freq.shape[1] != uv.shape[0]:
        msg = f"flat bootstrap needs uv (R,), freq (nrep, R); got {uv.shape}, {freq.shape}"
        raise ValueError(msg)
    val_shape = xv.shape[1:]
    nval = int(np.prod(val_shape, dtype=np.int64)) if val_shape else 1
    nrec = uv.shape[0]
    nrep = freq.shape[0]
    w, wp = _wbuf(uv, weight)
    n1 = order + 1
    uave = np.empty(nrep, np.float64)
    xave = np.empty((nrep, nval), np.float64)
    du = np.empty((nrep, n1), np.float64)
    dxdu = np.empty((nrep, n1, nval), np.float64)
    rc = lib.cm_resample_central(
        _buf(uv), _buf(xv), wp, _buf(freq), nrep, nrec, nval, order, _buf(uave), _buf(xave), _buf(du), _buf(dxdu)
    )
    _check(rc, "resample_central_comoments")
    return (
        xave.reshape((nrep, *val_shape)),
        uave,
        np.moveaxis(du, -1, 0),
        np.moveaxis(dxdu, 1, 0).reshape((n1, nrep, *val_shape)),
    )
