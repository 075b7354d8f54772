"""Lazy build of the CUDA kernels in ``csrc/``.

On first use the sources are compiled by ``nvcc`` for Hopper (``sm_90a``)
into one shared library with a plain C interface, loaded with ``ctypes``.
The library lives in ``thermoextrap_tpu_torch/_build/`` and its name carries
a hash of the sources and flags, so an edited source builds anew.  Importing
this module needs neither CUDA nor ``nvcc``; a failed build raises with
nvcc's output, and nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["BUILD_INFO", "CSRC_DIR", "library"]

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

# filled by the first build or load in this process: library path, whether
# it was compiled now, compile seconds and nvcc's output (ptxas register and
# shared-memory report)
BUILD_INFO: dict = {}

_LOCK = threading.Lock()
_LIB = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    "tx_error_string": ([_I], ctypes.c_char_p),
    "tx_reduce_comoments": ([_P, _P, _P, _P, _P, _P, _P, _LL, _LL, _I, _I, _I, _I, _I, _P], _I),
    "tx_resample_comoments": (
        [_P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _LL, _I, _I, _LL, _P, _I, _P],
        _I,
    ),
    "tx_poisson_counts": ([_P, _LL, _I, _LL, _P, _I, _P], _I),
}


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cu, cuh = _sources()
    for path in cu + cuh:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    msg = (
        "nvcc not found: the CUDA kernels of thermoextrap_tpu_torch are compiled "
        "on first use and need the CUDA toolkit (set CUDA_HOME)"
    )
    raise RuntimeError(msg)


def _compile(target: Path) -> None:
    cu, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp), *map(str, cu)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        msg = f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        raise RuntimeError(msg)
    log = proc.stdout + proc.stderr
    target.with_suffix(".log").write_text(log)
    os.replace(tmp, target)
    BUILD_INFO.update(compiled=True, seconds=seconds, log=log)


def library() -> ctypes.CDLL:
    """The kernel library, compiled on first call in a fresh checkout."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        target = BUILD_DIR / f"libthermoextrap_kernels-{_digest()}.so"
        if target.exists():
            log_path = target.with_suffix(".log")
            BUILD_INFO.update(
                compiled=False,
                seconds=0.0,
                log=log_path.read_text() if log_path.exists() else "",
            )
        else:
            _compile(target)
        lib = ctypes.CDLL(str(target))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        BUILD_INFO["path"] = str(target)
        _LIB = lib
        return lib


def check(status: int, what: str) -> None:
    """Raise when a kernel entry point reports a CUDA error."""
    if status != 0:
        text = library().tx_error_string(status).decode()
        msg = f"{what}: CUDA error {status} ({text})"
        raise RuntimeError(msg)
