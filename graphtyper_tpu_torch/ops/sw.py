"""Realignment batch dispatch (port of graphtyper_tpu/ops/sw.py:78 align_batch).

With device_sw "auto" or "on" every batch goes to `sw_align_rot` on the
given device, whatever its size: the CUDA kernel on a GPU, the plain torch
version on the CPU. There is no batch-size gate, no shape bucketing (the
kernel needs no padding) and no fallback on failure. device_sw "off" keeps
the host path, the C++ engine's DP (`align_batch_host`, the JAX module's
`_align_batch_native` :229).
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass

import numpy as np
import torch

from graphtyper_tpu_torch.constants import (
    SCORE_CLIP,
    SCORE_GAP_EXTEND,
    SCORE_GAP_OPEN,
    SCORE_MATCH,
    SCORE_MISMATCH,
)
from graphtyper_tpu_torch.io.native import get_lib
from graphtyper_tpu_torch.ops.sw_rot import sw_align_rot

__all__ = ["SWResult", "align_batch", "align_batch_host"]


@dataclass
class SWResult:
    score: np.ndarray  # [B]
    database_begin: np.ndarray  # [B]
    database_end: np.ndarray  # [B] (exclusive-ish: index of last aligned db base + 1)
    clip_begin: np.ndarray  # [B] query bases clipped at start
    clip_end: np.ndarray  # [B] query bases clipped at end


def align_batch_host(
    queries: np.ndarray,  # [B, M] uint8 codes, pad=5
    q_lens: np.ndarray,  # [B]
    databases: np.ndarray,  # [B, N] uint8 codes, pad=5
    d_lens: np.ndarray,  # [B]
    match: int = SCORE_MATCH,
    mismatch: int = SCORE_MISMATCH,
    gap_open: int = SCORE_GAP_OPEN,
    gap_extend: int = SCORE_GAP_EXTEND,
    clip: int = SCORE_CLIP,
) -> SWResult:
    """The host DP of the C++ engine (native/gt_sw.cpp gt_sw_batch, the
    threaded twin of the JAX package's numpy DP). Fork of
    graphtyper_tpu/ops/sw.py:229 _align_batch_native: the port always has
    its engine, so there is no numpy fallback."""
    lib = get_lib()
    if not getattr(lib, "_sw_ready", False):
        lib.gt_sw_batch.restype = None
        lib.gt_sw_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int32,
        ]
        lib._sw_ready = True
    B, M = queries.shape
    _, N = databases.shape
    q = np.ascontiguousarray(queries, dtype=np.uint8)
    d = np.ascontiguousarray(databases, dtype=np.uint8)
    ql = np.ascontiguousarray(q_lens, dtype=np.int32)
    dl = np.ascontiguousarray(d_lens, dtype=np.int32)
    score = np.empty(B, dtype=np.int64)
    begin = np.empty(B, dtype=np.int64)
    end = np.empty(B, dtype=np.int64)
    clip_end = np.empty(B, dtype=np.int64)
    vp = ctypes.c_void_p
    n_threads = min(os.cpu_count() or 1, 8) if B >= 64 else 1
    lib.gt_sw_batch(
        vp(q.ctypes.data), vp(ql.ctypes.data), vp(d.ctypes.data), vp(dl.ctypes.data),
        B, M, N, match, mismatch, gap_open, gap_extend, clip,
        vp(score.ctypes.data), vp(begin.ctypes.data), vp(end.ctypes.data),
        vp(clip_end.ctypes.data), n_threads,
    )
    return SWResult(score, begin, end, np.zeros(B, dtype=np.int64), clip_end)


def align_batch(
    queries: np.ndarray,  # [B, M] uint8 codes, pad=5
    q_lens: np.ndarray,  # [B]
    databases: np.ndarray,  # [B, N] uint8 codes, pad=5
    d_lens: np.ndarray,  # [B]
    device: torch.device | str,
    match: int = SCORE_MATCH,
    mismatch: int = SCORE_MISMATCH,
    gap_open: int = SCORE_GAP_OPEN,
    gap_extend: int = SCORE_GAP_EXTEND,
    clip: int = SCORE_CLIP,
) -> SWResult:
    """score / database_begin / database_end per pair, as int64 numpy.
    On the device path the clip lengths come back as -1, as on the JAX
    package's device path (no consumer reads them)."""
    from graphtyper_tpu_torch.config import current_options

    opts = current_options()
    mode = "on" if opts.force_device_sw else opts.device_sw
    if mode == "off":
        return align_batch_host(
            queries, q_lens, databases, d_lens, match, mismatch, gap_open, gap_extend, clip
        )
    B, M = queries.shape
    N = databases.shape[1]
    q_lens = np.asarray(q_lens)
    d_lens = np.asarray(d_lens)
    if B and (q_lens.max() > M or d_lens.max() > N or q_lens.min() < 0 or d_lens.min() < 0):
        raise ValueError("align_batch: lengths must lie in [0, M] and [0, N]")
    dev = torch.device(device)

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

    s, bg, en = sw_align_rot(
        put(queries, np.uint8), put(q_lens, np.int32), put(databases, np.uint8),
        put(d_lens, np.int32),
        match=match, mismatch=mismatch, gap_open=gap_open, gap_extend=gap_extend, clip=clip,
    )
    out = torch.stack([s, bg, en]).cpu().numpy().astype(np.int64)
    minus = np.full(B, -1, dtype=np.int64)
    return SWResult(out[0], out[1], out[2], minus, minus.copy())
