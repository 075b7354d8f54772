"""Where the port's compiled libraries are built and kept.

Counterpart of ``thermoextrap_tpu/utils/compile_cache.py``, which points
jax's persistent compilation cache at a directory.  The port compiles no
programs at run time; what it builds on first use, and keeps, are its
libraries: the CUDA kernels (``nvcc``, :mod:`..ops._build`; about 25 s on
the H100 machine), their CPU emulation (``g++``, :mod:`..emulate`) and
the host engines (``g++``, :mod:`..native`).  By default they live in the
package's gitignored ``_build/``; pointing them at a lasting directory
lets every process and every checkout of the same sources reuse one build
(each library's name carries a hash of its sources).

Opt-in:

    from thermoextrap_tpu_torch.utils.compile_cache import enable_compilation_cache
    enable_compilation_cache()          # $XDG_CACHE_HOME/thermoextrap_tpu_torch/kernels
    enable_compilation_cache("/fast/disk/cache")
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["enable_compilation_cache"]


def enable_compilation_cache(path: str | os.PathLike | None = None) -> Path:
    """Build and load the port's libraries under ``path`` (created) and
    return it; by default ``$XDG_CACHE_HOME/thermoextrap_tpu_torch/kernels``
    (``~/.cache`` without ``XDG_CACHE_HOME``).

    The kernel library and its emulation go to ``path``, the host engines
    to ``path/host``.  Safe to call more than once; the last path wins for
    libraries not yet loaded in this process.
    """
    from .. import native
    from ..ops import _build

    if path is None:
        path = Path(os.environ.get("XDG_CACHE_HOME", Path.home() / ".cache")) / "thermoextrap_tpu_torch" / "kernels"
    cache_dir = Path(path)
    cache_dir.mkdir(parents=True, exist_ok=True)
    _build.BUILD_DIR = cache_dir
    native.BUILD_DIR = cache_dir / "host"
    return cache_dir
