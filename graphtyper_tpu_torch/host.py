"""Host runtime the shared C++ engine needs.

graphtyper_tpu/libgt_native.so links libdeflate.so.0. On a host without
that library, `ensure_native_runtime` builds csrc/libdeflate_zlib.c (the
eight libdeflate calls the engine makes, over zlib) with the SONAME
libdeflate.so.0 and loads it first, so the engine's dependency resolves to
it. The package's import calls it, so every entry point and every region
worker has the engine's runtime before anything loads the engine.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from pathlib import Path

from graphtyper_tpu_torch.kernels import CSRC, build_shared

_SHIM = None


def _c_compiler() -> str:
    cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        raise RuntimeError("no C compiler (CC, cc or gcc) to build the libdeflate shim")
    return cc


def ensure_native_runtime(build_dir: Path | None = None, force_shim: bool = False) -> str | None:
    """Load libdeflate.so.0, or the zlib shim in its place when the host
    has none (or `force_shim`). Returns the shim's path when it is in use."""
    global _SHIM
    if _SHIM is not None:
        return _SHIM
    if not force_shim:
        try:
            ctypes.CDLL("libdeflate.so.0")
            return None
        except OSError:
            pass
    path = build_shared(
        "libdeflate_zlib", [CSRC / "libdeflate_zlib.c"], [_c_compiler()],
        ["-O2", "-shared", "-fPIC", "-Wl,-soname,libdeflate.so.0"], build_dir, libs=("-lz",),
    )
    ctypes.CDLL(str(path), mode=ctypes.RTLD_GLOBAL)
    _SHIM = str(path)
    return _SHIM
