"""Lazy build of the CUDA kernels in ``csrc/``.

On first use every source is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all of them at once, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``.
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
    "tx_reduce_comoments": ([_P, _P, _P, _P, _P, _LL, _LL, _I, _I, _I, _I, _I, _P], _I),
    "tx_resample_comoments": (
        [_P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _LL, _I, _I, _I, _I, _LL, _P, _I, _P],
        _I,
    ),
    "tx_poisson_counts": ([_P, _LL, _I, _LL, _P, _I, _P], _I),
    "tx_poisson_map": ([_P, _LL, _LL, _P, _P, _P, _I, _P], _I),
    "tx_head_shift": ([_P, _P, _P, _P, _I, _I, _LL, _LL, _I, _I, _P], _I),
    "tx_finalize_comoments": ([_P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
    "tx_finalize_umoments": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
    "tx_mma_probe": ([_P, _P, _P, _P, _I, _P], _I),
    "tx_resample_umoments": (
        [_P, _P, _P, _P, _P, _LL, _LL, _I, _I, _I, _LL, _I, _I, _I, _LL, _P, _I, _P],
        _I,
    ),
    "tx_resample_perturb": (
        [_P, _P, _P, _P, _LL, _LL, _I, _I, _I, _LL, _I, _I, _I, _LL, _P, _I, _P],
        _I,
    ),
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


def _run(cmds):
    """Run the commands at once; raise with nvcc's output if any fails.
    Returns their combined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            msg = f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n{out}"
            raise RuntimeError(msg)
    return "".join(outs)


def _compile(target: Path) -> None:
    cu, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{target.name}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{path.stem}.o" for path in cu]
    tmp = target.with_name(f"{tag}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        log = _run(
            [[nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o", str(o), str(src)] for o, src in zip(objs, cu)]
        )
        log += _run([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    except RuntimeError:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
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
