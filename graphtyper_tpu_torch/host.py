"""Host runtime of the port's C++ engine.

The engine (native/*.cpp, built by io/native.py) calls eight libdeflate
functions. It is compiled against the declarations in csrc/libdeflate.h
and linked against csrc/libdeflate_zlib.c (those eight calls over zlib),
built with the SONAME libdeflate.so.0, so the engine's DT_NEEDED entry is
libdeflate.so.0. At run time `ensure_native_runtime` loads the system
libdeflate.so.0 where the host has one, else the zlib stand-in, before
anything loads the engine. The package's import calls it, so every entry
point and every region worker has the engine's runtime.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from pathlib import Path

from graphtyper_tpu_torch.kernels import CSRC, build_shared

_SHIM = None


def _compiler(env: str, names: tuple[str, ...], what: str) -> str:
    found = os.environ.get(env) or next(filter(None, map(shutil.which, names)), None)
    if found is None:
        raise RuntimeError(f"no {what} ({env}, {' or '.join(names)}) to build {what} sources")
    return found


def c_compiler() -> str:
    return _compiler("CC", ("cc", "gcc"), "C compiler")


def cxx_compiler() -> str:
    return _compiler("CXX", ("g++", "c++"), "C++ compiler")


def shim_path(build_dir: Path | None = None) -> Path:
    """The zlib stand-in for libdeflate.so.0, built if needed."""
    return build_shared(
        "libdeflate_zlib", [CSRC / "libdeflate_zlib.c"], [c_compiler()], ["-O2", "-fPIC"],
        build_dir, libs=("-lz",), link_flags=("-shared", "-Wl,-soname,libdeflate.so.0"),
        depends=(CSRC / "libdeflate.h",),
    )


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
    path = shim_path(build_dir)
    ctypes.CDLL(str(path), mode=ctypes.RTLD_GLOBAL)
    _SHIM = str(path)
    return _SHIM
