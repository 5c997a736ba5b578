"""Build and bind the port's hand-written CUDA kernels.

The sources under csrc/ compile with nvcc for sm_90a into one shared
library with a plain C interface, loaded through ctypes. Nothing is built
when a module is imported: the first launch builds (or finds) the library.
Its file name carries a hash of the sources and the flags, so a process
that finds it already built, such as a region worker after its parent
built it before the fan-out, loads it without compiling.

`check_cuda` is the layout check every kernel wrapper makes before its
launch; `device_guard` and `stream_of` are the scoring wrappers' cheap
forms of `torch.cuda.device` and `torch.cuda.current_stream`.
`build_shared` also builds the host libraries of the port (host.py, the
C++ engine of io/native.py).
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
#: build outputs; listed in .gitignore
BUILD_DIR = Path(__file__).resolve().parent.parent / "kernel_build"

CUDA_SOURCES = (
    "sw_rot.cu", "sw_row.cu", "device_align.cu", "seed_probe.cu", "site_scoring.cu",
    "discovery_pileup.cu",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_LIB = None


def check_cuda(name: str, dev, tensors) -> None:
    """The layout the CUDA kernels take: tensors on one CUDA device, of the
    given dtype and rank, contiguous. `tensors` holds (arg, tensor, dtype,
    ndim)."""
    if dev.type != "cuda":
        raise ValueError(f"{name}: kernel inputs must be CUDA tensors, got {dev}")
    for arg, t, dtype, ndim in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, not {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} must be {dtype}, got {t.dtype}")
        if t.dim() != ndim:
            raise ValueError(f"{name}: {arg} must have {ndim} dims, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def device_guard(dev):
    """`torch.cuda.device(dev)`, or no context when `dev` is the current
    device already, as it is on every flush of a one-card run: entering
    the guard costs microseconds a call, which the scoring flushes of the
    main path (a few thousand rows each) notice."""
    import torch

    return contextlib.nullcontext() if torch.cuda.current_device() == dev.index else torch.cuda.device(dev)


def stream_of(dev) -> int:
    """The current CUDA stream of `dev` (an indexed device) as the pointer
    the launchers take: what `torch.cuda.current_stream(dev).cuda_stream`
    gives, from torch's raw getter, without building a Stream object."""
    import torch

    return torch._C._cuda_getCurrentRawStream(dev.index)


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


@contextlib.contextmanager
def _build_lock(build_dir: Path):
    """Exclusive fcntl lock on the build directory: concurrent processes
    (test workers, region workers) wait for one build instead of all
    compiling the same library."""
    with open(build_dir / ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _run(cmd: list[str], out_name: str) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"building {out_name} failed (rc {proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )


def build_shared(stem: str, sources: list[Path], compiler: list[str], flags: list[str],
                 build_dir: Path | None = None, libs: tuple[str, ...] = (),
                 link_flags: tuple[str, ...] = ("-shared",),
                 depends: tuple[Path, ...] = ()) -> Path:
    """Compile `sources` into <build_dir>/<stem>-<hash>.so unless that file
    exists. The hash covers the sources, the files in `depends` (headers),
    the compiler's name and the flags.

    One source compiles and links in one command. Several compile to
    objects in parallel, one compiler process each, all started together,
    then link once. The build holds the directory's lock and writes to a
    temporary name before renaming, so concurrent builds never expose a
    half-written library."""
    build_dir = Path(build_dir or BUILD_DIR)
    h = hashlib.sha256()
    for s in (*sources, *depends):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join([os.path.basename(compiler[0]), *compiler[1:], *flags, *link_flags,
                       *libs]).encode())
    out = build_dir / f"{stem}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    with _build_lock(build_dir):
        if out.exists():  # another process built it while this one waited
            return out
        with tempfile.TemporaryDirectory(prefix=f".{stem}-", dir=build_dir) as tmp_dir:
            tmp = os.path.join(tmp_dir, out.name)
            if len(sources) == 1:
                _run([*compiler, *flags, *link_flags, "-o", tmp, str(sources[0]), *libs], out.name)
            else:
                objs = [os.path.join(tmp_dir, f"{i}-{s.stem}.o") for i, s in enumerate(sources)]
                cmds = [[*compiler, *flags, "-c", "-o", o, str(s)] for o, s in zip(objs, sources)]
                procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True) for c in cmds]
                failed = []
                for c, p in zip(cmds, procs):
                    log = p.communicate()[0]
                    if p.returncode != 0:
                        failed.append(f"{' '.join(c)}\n{log}")
                if failed:
                    raise RuntimeError(f"building {out.name} failed:\n" + "\n".join(failed))
                _run([*compiler, *link_flags, "-o", tmp, *objs, *libs], out.name)
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
    lib.gt_sw_rot.argtypes = [vp] * 6 + [i32] * 8 + [vp]
    lib.gt_sw_rot_band_rows.restype = i32
    lib.gt_sw_rot_band_rows.argtypes = []
    lib.gt_sw_row.restype = i32
    lib.gt_sw_row.argtypes = [vp] * 5 + [i32] * 8 + [vp]
    lib.gt_device_align.restype = i32
    lib.gt_device_align.argtypes = [vp] * 11 + [i32] * 8 + [vp]
    lib.gt_seed_probe.restype = i32
    lib.gt_seed_probe.argtypes = [vp] * 5 + [i32] * 3 + [vp]
    i64 = ctypes.c_int64
    lib.gt_site_scoring_size.restype = i64
    lib.gt_site_scoring_size.argtypes = [i32, i64, i64]
    lib.gt_site_scoring_buffer.restype = i64
    lib.gt_site_scoring_buffer.argtypes = [i32, i64, i64]
    lib.gt_site_scoring_shared.restype = i64
    lib.gt_site_scoring_shared.argtypes = [i64, i32, i64, i64]
    lib.gt_site_scoring.restype = i32
    lib.gt_site_scoring.argtypes = [vp, i64, i32, i64, i64, vp, vp]
    lib.gt_discovery_pileup.restype = i32
    lib.gt_discovery_pileup.argtypes = [vp, i64, i64, vp, vp]
    _LIB = lib
    return lib
