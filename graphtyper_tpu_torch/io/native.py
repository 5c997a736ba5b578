"""ctypes bindings to the native host runtime, the C++ engine built from
the repository's native/*.cpp: libdeflate-backed BGZF decompression,
single-pass BAM decoding into packed numpy arrays, and fast k-mer packing.

The port builds the engine itself at first use (`engine_path`): the seven
sources of native/Makefile's SRCS, read in place, compiled with g++ and the
flags of its `portable` target into kernel_build/ (hash-named, one compiler
process per source, then one link). It never loads a prebuilt binary, and
raises when the sources or the compiler are missing. The engine includes
the port's csrc/libdeflate.h and links csrc/libdeflate_zlib.c's library, so
it needs libdeflate.so.0 only at run time (host.py).
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

import numpy as np

from graphtyper_tpu_torch.kernels import CSRC, build_shared

_LIB = None

#: the engine's sources, read in place
NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
#: native/Makefile SRCS
ENGINE_SOURCES = (
    "gt_native.cpp", "gt_align.cpp", "gt_bamshrink.cpp", "gt_first_pass.cpp", "gt_sw.cpp",
    "gt_cram.cpp", "gt_variant.cpp",
)
#: native/Makefile PORTABLE_FLAGS, without -Wall
ENGINE_FLAGS = ("-O3", "-march=x86-64-v2", "-fPIC", "-std=c++17")


def engine_path(build_dir: Path | None = None) -> Path:
    """Build the C++ engine if needed; returns its path. Raises when a
    source or the compiler is missing."""
    from graphtyper_tpu_torch.host import cxx_compiler, shim_path

    sources = [NATIVE_DIR / s for s in ENGINE_SOURCES]
    missing = [str(s) for s in sources if not s.is_file()]
    if missing:
        raise RuntimeError(f"the C++ engine's sources are missing: {missing}")
    return build_shared(
        "gt_native", sources, [cxx_compiler()], [*ENGINE_FLAGS, "-I", str(CSRC)], build_dir,
        libs=(str(shim_path(build_dir)), "-lz", "-lpthread"), depends=(CSRC / "libdeflate.h",),
    )


def native_thread_count() -> int:
    """Worker threads for the native loops: GT_NATIVE_THREADS if it parses
    to a positive int, else min(8, cpu count). Malformed values fall back
    rather than abort (they are a tuning knob, not a correctness input)."""
    raw = os.environ.get("GT_NATIVE_THREADS", "")
    try:
        n = int(raw)
    except ValueError:
        n = 0
    if n > 0:
        return n
    return min(8, os.cpu_count() or 1)


def get_lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(engine_path()))
    lib.gt_bgzf_decompress.restype = ctypes.c_int64
    lib.gt_bgzf_decompress.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.gt_bgzf_decompress_mt.restype = ctypes.c_int64
    lib.gt_bgzf_decompress_mt.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
    ]
    lib.gt_bam_scan.restype = ctypes.c_int32
    lib.gt_bam_scan.argtypes = [ctypes.c_void_p, ctypes.c_int64] + [ctypes.POINTER(ctypes.c_int64)] * 5
    lib.gt_bam_fill.restype = ctypes.c_int32
    lib.gt_bam_fill.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64] + [ctypes.c_void_p] * 15
    lib.gt_pack_kmers.restype = ctypes.c_int64
    lib.gt_pack_kmers.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    _LIB = lib
    return lib


def bgzf_decompress(raw: bytes) -> bytes | None:
    """Whole-file BGZF decompression through libdeflate; None -> fall back.
    Blocks inflate in parallel when the file is pure BGZF (the BC extra
    field gives every block's offsets up front); plain-gzip members fall
    back to the serial member walk."""
    lib = get_lib()
    inp = np.frombuffer(raw, dtype=np.uint8)
    size = lib.gt_bgzf_decompress(inp.ctypes.data, len(raw), None, 0)
    if size < 0:
        return None
    out = np.empty(int(size), dtype=np.uint8)
    got = lib.gt_bgzf_decompress_mt(inp.ctypes.data, len(raw), out.ctypes.data, int(size), 0)
    if got == size:
        return out.tobytes()
    if got != -2:
        return None
    got = lib.gt_bgzf_decompress(inp.ctypes.data, len(raw), out.ctypes.data, int(size))
    if got != size:
        return None
    return out.tobytes()


def decode_bam_arrays(data: bytes):
    """Decode BAM alignment records (after the header) into packed arrays.

    Returns None on failure, else a dict with keys ref_id, pos, flag, mapq,
    mate_ref_id, mate_pos, tlen, qlen, seqs [N, L] codes, quals [N, L],
    cigar_ops/cigar_lens/cigar_offsets, names/name_offsets and header_end.
    """
    lib = get_lib()
    buf = np.frombuffer(data, dtype=np.uint8)
    header_end = ctypes.c_int64()
    n_records = ctypes.c_int64()
    max_qlen = ctypes.c_int64()
    total_cigar = ctypes.c_int64()
    total_names = ctypes.c_int64()
    rc = lib.gt_bam_scan(
        buf.ctypes.data, len(data),
        ctypes.byref(header_end), ctypes.byref(n_records), ctypes.byref(max_qlen),
        ctypes.byref(total_cigar), ctypes.byref(total_names),
    )
    if rc != 0:
        return None
    n = int(n_records.value)
    L = max(int(max_qlen.value), 1)
    out = {
        "ref_id": np.empty(n, dtype=np.int32),
        "pos": np.empty(n, dtype=np.int64),
        "flag": np.empty(n, dtype=np.uint16),
        "mapq": np.empty(n, dtype=np.uint8),
        "mate_ref_id": np.empty(n, dtype=np.int32),
        "mate_pos": np.empty(n, dtype=np.int64),
        "tlen": np.empty(n, dtype=np.int32),
        "qlen": np.empty(n, dtype=np.int32),
        "seqs": np.full((n, L), 5, dtype=np.uint8),
        "quals": np.zeros((n, L), dtype=np.uint8),
        "cigar_ops": np.empty(int(total_cigar.value), dtype=np.uint8),
        "cigar_lens": np.empty(int(total_cigar.value), dtype=np.int32),
        "cigar_offsets": np.empty(n + 1, dtype=np.int64),
        "names": np.empty(int(total_names.value), dtype=np.uint8),
        "name_offsets": np.empty(n + 1, dtype=np.int64),
        "header_end": int(header_end.value),
    }
    rc = lib.gt_bam_fill(
        buf.ctypes.data, len(data), int(header_end.value), L,
        out["ref_id"].ctypes.data, out["pos"].ctypes.data, out["flag"].ctypes.data,
        out["mapq"].ctypes.data, out["mate_ref_id"].ctypes.data, out["mate_pos"].ctypes.data,
        out["tlen"].ctypes.data, out["qlen"].ctypes.data,
        out["seqs"].ctypes.data, out["quals"].ctypes.data,
        out["cigar_ops"].ctypes.data, out["cigar_lens"].ctypes.data, out["cigar_offsets"].ctypes.data,
        out["names"].ctypes.data, out["name_offsets"].ctypes.data,
    )
    if rc != 0:
        return None
    return out


def pack_kmers_native(codes: np.ndarray):
    lib = get_lib()
    n = len(codes)
    if n < 32:
        return np.empty(0, dtype=np.uint64), np.empty(0, dtype=bool)
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    kmers = np.empty(n - 31, dtype=np.uint64)
    valid = np.empty(n - 31, dtype=np.uint8)
    lib.gt_pack_kmers(codes.ctypes.data, n, kmers.ctypes.data, valid.ctypes.data)
    return kmers, valid.astype(bool)
