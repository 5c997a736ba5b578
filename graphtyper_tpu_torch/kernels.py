"""Build and bind the port's hand-written CUDA kernels.

The sources under csrc/ compile with nvcc for sm_90a into one shared
library with a plain C interface, loaded through ctypes. Nothing is built
when a module is imported: the first launch builds (or finds) the library.
Its file name carries a hash of the sources and the flags, so a process
that finds it already built, such as a region worker after its parent
built it before the fan-out, loads it without compiling.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
#: build outputs; listed in .gitignore
BUILD_DIR = Path(__file__).resolve().parent.parent / "kernel_build"

CUDA_SOURCES = ("sw_rot.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LIB = None


def find_nvcc() -> str:
    """$CUDA_HOME/bin/nvcc (default /usr/local/cuda), else nvcc on PATH."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (neither $CUDA_HOME/bin/nvcc nor on PATH): "
            "cannot build the CUDA kernels under " + str(CSRC)
        )
    return found


def build_shared(stem: str, sources: list[Path], compiler: list[str], flags: list[str],
                 build_dir: Path | None = None, libs: tuple[str, ...] = ()) -> Path:
    """Compile `sources` into <build_dir>/<stem>-<hash>.so unless that file
    exists. The hash covers the sources, the compiler's name and the flags.
    Writes to a temporary name and renames, so concurrent builds never
    expose a half-written library."""
    build_dir = Path(build_dir or BUILD_DIR)
    h = hashlib.sha256()
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join([os.path.basename(compiler[0]), *compiler[1:], *flags, *libs]).encode())
    out = build_dir / f"{stem}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{stem}-", suffix=".so", dir=build_dir)
    os.close(fd)
    cmd = [*compiler, *flags, "-o", tmp, *map(str, sources), *libs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"building {out.name} failed (rc {proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def library_path(build_dir: Path | None = None) -> Path:
    """Build the CUDA library if needed; returns its path."""
    return build_shared(
        "gt_torch_kernels", [CSRC / s for s in CUDA_SOURCES], [find_nvcc()], list(NVCC_FLAGS),
        build_dir,
    )


def load(build_dir: Path | None = None) -> ctypes.CDLL:
    """The loaded kernel library (built at first use). Raises on a failed
    build; there is no fallback."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(library_path(build_dir)))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gt_sw_rot.restype = i32
    lib.gt_sw_rot.argtypes = [vp] * 8 + [i32] * 8 + [vp]
    _LIB = lib
    return lib
