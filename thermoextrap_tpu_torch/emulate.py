"""Run the CUDA kernels of ``csrc/`` on the CPU, through the wrappers, where
there is no ``nvcc`` and no card.

The sources are rewritten a little (a kernel launch becomes a function call),
compiled by the host's ``g++`` against ``csrc/emulate/cuda_runtime.h``, a
stand-in for the CUDA runtime in which the threads of a block are fibers run
in turn on the calling thread, each up to its next barrier, and loaded with
``ctypes`` under the signatures of :mod:`.ops._build`.  Inside
:func:`emulated` the wrappers of :mod:`.ops.moments_cuda` that launch kernels
(``_resample_cuda``, ``_resample_u_cuda``, ``_resample_perturb_cuda``,
``head_shift_cuda``, ``finalize_comoments_cuda``, ``poisson_counts_cuda``, ...)
take CPU tensors and run the emulated kernels on them::

    from thermoextrap_tpu_torch import emulate
    from thermoextrap_tpu_torch.ops import moments_cuda as mc

    with emulate.emulated():
        sums = mc._resample_perturb_cuda(e, x, nrep, freq=table)

This checks a kernel's indexing, masking, barriers and control flow on small
shapes, the same way on every run (a block costs its threads' work, not a
thread start each); it says nothing of what ``nvcc`` accepts, of registers, of
bank conflicts or of time.  Needs a ``g++`` with C++17 and glibc's
``<ucontext.h>``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

from .ops import _build, mbar_cuda, moments_cuda

__all__ = ["available", "emulated", "library"]

_HEADERS = _build.CSRC_DIR / "emulate"
_LAUNCH = re.compile(r"(\w[\w:<>, ]*?)<<<(.*?)>>>\(", re.S)
_LIB = None


def available() -> bool:
    """Whether a host compiler is at hand (``g++``; the runtime's fibers need
    glibc's ``<ucontext.h>``)."""
    return shutil.which("g++") is not None


def _rewrite(text: str) -> str:
    text = _LAUNCH.sub(lambda m: f"emu_launch({m.group(1)}, {m.group(2)}, ", text)
    return text.replace("extern __shared__ __align__(16) float smem[];", "float* smem = emu_smem;")


def _compile(target: Path) -> None:
    cu, cuh = _build._sources()
    with tempfile.TemporaryDirectory() as tmp:
        for path in cu + cuh:
            name = path.with_suffix(".cpp").name if path.suffix == ".cu" else path.name
            (Path(tmp) / name).write_text(_rewrite(path.read_text()))
        cmd = ["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(_HEADERS), "-I", tmp]
        cmd += ["-o", str(target), *sorted(str(p) for p in Path(tmp).glob("*.cpp"))]
        done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        msg = f"g++ failed (exit {done.returncode}):\n{' '.join(cmd)}\n{done.stdout}{done.stderr}"
        raise RuntimeError(msg)


class _Library:
    """The emulated kernel library: :func:`.ops._build.library`'s interface,
    with a CPU tensor's device index (None) passed as 0."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        ints = [i for i, t in enumerate(fn.argtypes) if t is ctypes.c_int]

        def call(*args):
            args = list(args)
            for i in ints:
                if args[i] is None:
                    args[i] = 0
            return fn(*args)

        return call


def library() -> _Library:
    """The kernels compiled for the CPU (built once per set of sources into
    the package's build directory)."""
    global _LIB
    if _LIB is None:
        h = hashlib.sha256(_build._digest().encode())
        for path in sorted(_HEADERS.glob("*.h")):
            h.update(path.read_bytes())
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        target = _build.BUILD_DIR / f"libthermoextrap_emulated-{h.hexdigest()[:16]}.so"
        if not target.exists():
            tmp = target.with_suffix(f".{id(h)}.tmp")
            _compile(tmp)
            tmp.replace(target)
        lib = ctypes.CDLL(str(target))
        for name, (argtypes, restype) in _build._SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _LIB = _Library(lib)
    return _LIB


@contextlib.contextmanager
def emulated():
    """Within the block, the kernel-launching wrappers of
    :mod:`.ops.moments_cuda` and :mod:`.ops.mbar_cuda` run the emulated
    kernels on CPU tensors, and MBAR's solve routes CPU tensors to its
    kernel (:func:`.ops.mbar_cuda.kernel_device`)."""
    lib = library()
    saved = _build.library, moments_cuda._stream_ptr, mbar_cuda.kernel_device
    _build.library = lambda: lib
    moments_cuda._stream_ptr = lambda device: None
    mbar_cuda.kernel_device = lambda t: t.device.type == "cpu"
    try:
        yield lib
    finally:
        _build.library, moments_cuda._stream_ptr, mbar_cuda.kernel_device = saved
