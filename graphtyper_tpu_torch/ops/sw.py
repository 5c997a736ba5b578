"""Realignment batch dispatch (port of graphtyper_tpu/ops/sw.py:78 align_batch).

With device_sw "auto" or "on" every batch goes to `sw_align_rot` on the
given device, whatever its size: the CUDA kernel on a GPU, the plain torch
version on the CPU. There is no batch-size gate, no shape bucketing (the
kernel needs no padding) and no fallback on failure. device_sw "off" keeps
the JAX package's host path (the native C++ DP, else the numpy DP).
"""

from __future__ import annotations

import numpy as np
import torch

from graphtyper_tpu.constants import (
    SCORE_CLIP,
    SCORE_GAP_EXTEND,
    SCORE_GAP_OPEN,
    SCORE_MATCH,
    SCORE_MISMATCH,
)
from graphtyper_tpu.ops import sw as _host_sw
from graphtyper_tpu.ops.sw import SWResult
from graphtyper_tpu_torch.ops.sw_rot import sw_align_rot

__all__ = ["SWResult", "align_batch"]


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
    from graphtyper_tpu.config import current_options

    opts = current_options()
    mode = "on" if opts.force_device_sw else opts.device_sw
    if mode == "off":
        return _host_sw.align_batch(
            queries, q_lens, databases, d_lens, match, mismatch, gap_open, gap_extend, clip,
            device=False,
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
