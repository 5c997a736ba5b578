"""Row-scan Smith-Waterman on tensors: the port of
graphtyper_tpu/ops/sw_pallas.py:214 sw_align_pallas (Pallas kernel
`_sw_kernel`).

On a CUDA tensor `sw_align_pallas` launches the hand-written kernel
csrc/sw_row.cu (one warp per pair, lanes over database columns); on a CPU
tensor it runs `sw_align_plain`. Both TPU kernels compute one function, the
one `sw_align_rot` computes (tests/ops/test_sw.py:94 and
tests/ops/test_sw_rot.py hold each to the same host DP), so the plain
version is ops/sw_rot.py's, named here again. The TPU tiling arguments
(`block_b`, `rows_per_step`, `interpret`) have no counterpart.

A pair with qlen = 0 returns (0, 0, 0), the sentinel of `sw_align_plain`
and `sw_align_rot`; the Pallas kernel reports the first valid column there.
"""

from __future__ import annotations

import torch

from graphtyper_tpu_torch import counters, kernels
from graphtyper_tpu_torch.constants import (
    SCORE_CLIP,
    SCORE_GAP_EXTEND,
    SCORE_GAP_OPEN,
    SCORE_MATCH,
    SCORE_MISMATCH,
)
from graphtyper_tpu_torch.ops.sw_rot import check_kernel_inputs, sw_align_plain

__all__ = ["MAX_M", "MAX_N", "sw_align_pallas", "sw_align_plain"]

#: a lane's strip holds at most 16 columns (csrc/sw_row.cu gt_sw_row)
MAX_N = 16 * 32
#: the block's staged queries fit in 48 KB of shared memory
MAX_M = 12288


def sw_align_pallas(
    queries: torch.Tensor,  # [B, M] uint8 codes, pad 5
    q_lens: torch.Tensor,  # [B] int32, each <= M
    databases: torch.Tensor,  # [B, N] uint8 codes, pad 5
    d_lens: torch.Tensor,  # [B] int32, each <= N
    *,
    match: int = SCORE_MATCH,
    mismatch: int = SCORE_MISMATCH,
    gap_open: int = SCORE_GAP_OPEN,
    gap_extend: int = SCORE_GAP_EXTEND,
    clip: int = SCORE_CLIP,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(score, database_begin, database_end), int32 [B] each, on the
    inputs' device. CPU tensors run `sw_align_plain`; any other tensor goes
    to the CUDA kernel, which is built at first use, or the call raises."""
    scores = dict(match=match, mismatch=mismatch, gap_open=gap_open, gap_extend=gap_extend, clip=clip)
    if queries.device.type == "cpu":
        counters.add("sw_plain")
        return sw_align_plain(queries, q_lens, databases, d_lens, **scores)
    lib = kernels.load()
    check_kernel_inputs("sw_align_pallas", queries, q_lens, databases, d_lens)
    B, M = queries.shape
    N = databases.shape[1]
    if N > MAX_N or M > MAX_M:
        raise ValueError(f"sw_align_pallas: the kernel takes N <= {MAX_N} and M <= {MAX_M}, "
                         f"got M = {M}, N = {N}")
    dev = queries.device
    with torch.cuda.device(dev):
        out = torch.empty((3, B), dtype=torch.int32, device=dev)
        rc = lib.gt_sw_row(
            queries.data_ptr(), q_lens.data_ptr(), databases.data_ptr(), d_lens.data_ptr(),
            out.data_ptr(), B, M, N, match, mismatch, gap_open, gap_extend, clip,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"sw_row kernel launch failed: cudaGetLastError() = {rc}")
    counters.add("sw_row")
    return out[0], out[1], out[2]
