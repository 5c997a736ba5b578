"""Batched semi-global affine-gap Smith-Waterman on tensors.

`sw_align_rot` is the port of graphtyper_tpu/ops/sw_rot.py:230 (the Pallas
kernel). On a CUDA tensor it launches the hand-written kernel
csrc/sw_rot.cu (one warp per pair, the query rows over the lanes in an
anti-diagonal wavefront); on a CPU tensor it runs `sw_align_plain`, the plain
PyTorch version of the host DP (graphtyper_tpu/ops/sw.py:164-267). Both
return exactly the (score, database_begin, database_end) of the JAX
package's kernel, under its tie rules (sw_rot.py:12-24).
"""

from __future__ import annotations

import torch

from graphtyper_tpu_torch.constants import (
    SCORE_CLIP,
    SCORE_GAP_EXTEND,
    SCORE_GAP_OPEN,
    SCORE_MATCH,
    SCORE_MISMATCH,
)
from graphtyper_tpu_torch import counters, kernels

NEG = -(10**6)


def _running_argmax(T: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Running max and its latest argmax along dim 1 (graphtyper_tpu/ops/sw.py:48).
    The index comes from a second running max, never from cummax's own index,
    whose choice among ties is not specified."""
    cummax = torch.cummax(T, dim=1).values
    idx = torch.arange(T.shape[1], device=T.device, dtype=torch.int64)
    take = torch.where(T >= cummax, idx[None, :], 0)
    return cummax, torch.cummax(take, dim=1).values


def sw_align_plain(
    queries: torch.Tensor,  # [B, M] codes, pad 5
    q_lens: torch.Tensor,  # [B]
    databases: torch.Tensor,  # [B, N] codes, pad 5
    d_lens: torch.Tensor,  # [B]
    *,
    match: int = SCORE_MATCH,
    mismatch: int = SCORE_MISMATCH,
    gap_open: int = SCORE_GAP_OPEN,
    gap_extend: int = SCORE_GAP_EXTEND,
    clip: int = SCORE_CLIP,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The host DP written in torch: query rows sequential, batch and
    database columns vectorised, E by a running max over each row.

    Returns int32 (score, database_begin, database_end) on the input's
    device. A pair with qlen = 0 returns (0, 0, 0), the kernel's sentinel
    (the host DP returns score 0 with the first valid column there)."""
    dev = queries.device
    B, M = queries.shape
    N = databases.shape[1]
    i32 = torch.int32
    q = queries.to(i32)
    d = databases.to(i32)
    ql = q_lens.to(i32)
    dl = d_lens.to(i32)
    go, ge = gap_open, gap_extend

    cols = torch.arange(N, device=dev, dtype=i32)
    d_valid = cols[None, :] < dl[:, None]  # [B, N]
    d_base = d < 4
    jmask = torch.cat([torch.zeros((B, 1), dtype=torch.bool, device=dev), d_valid], dim=1)
    jidx = torch.arange(1, N + 1, device=dev, dtype=i32)

    # column j of H = database prefix length j; the start is free
    H = torch.zeros((B, N + 1), dtype=i32, device=dev)
    F = torch.full((B, N + 1), NEG, dtype=i32, device=dev)
    start = torch.arange(N + 1, device=dev, dtype=i32).expand(B, N + 1).clone()
    best_mid = torch.full((B,), NEG, dtype=i32, device=dev)  # best H(i<m, j) - clip
    best_mid_start = torch.zeros(B, dtype=i32, device=dev)
    best_mid_end = torch.zeros(B, dtype=i32, device=dev)
    neg_col = torch.full((B, 1), NEG, dtype=i32, device=dev)
    zero_col = torch.zeros((B, 1), dtype=i32, device=dev)
    rows_b = torch.arange(B, device=dev)

    for i in range(1, M + 1):
        row_active = i <= ql  # [B]
        qb = q[:, i - 1 : i]  # [B, 1]
        s = torch.where(qb == d, match, -mismatch).to(i32)
        s = torch.where(d_valid & (qb < 4) & d_base, s, torch.where(d_valid, 0, NEG).to(i32))

        # diagonal: continue from H(i-1, j-1) or restart after a head clip
        diag_val = H[:, :-1]
        diag_start = start[:, :-1]
        if i > 1:
            use_clip = -clip > diag_val
            diag_val = torch.where(use_clip, -clip, diag_val).to(i32)
            diag_start = torch.where(use_clip, cols[None, :], diag_start)
        M_cand = diag_val + s

        # gap in the database (query base consumed): F
        F_new = torch.maximum(H - go, F - ge)
        F_cand = F_new[:, 1:]
        take_M = M_cand >= F_cand
        H_tmp = torch.where(take_M, M_cand, F_cand)
        S_tmp = torch.where(take_M, diag_start, start[:, 1:])

        # gap in the query (database consumed): E by a running max
        runmax, runarg = _running_argmax(H_tmp + jidx[None, :] * ge)
        E_val = runmax[:, :-1] - go - jidx[None, 1:] * ge + ge
        use_E = E_val > H_tmp[:, 1:]
        H_after = torch.where(use_E, E_val, H_tmp[:, 1:])
        S_after = torch.where(use_E, torch.gather(S_tmp, 1, runarg[:, :-1]), S_tmp[:, 1:])
        H_row = torch.cat([neg_col, H_tmp[:, :1], H_after], dim=1)
        S_row = torch.cat([zero_col, S_tmp[:, :1], S_after], dim=1)

        # rows past qlen are frozen
        act = row_active[:, None]
        H = torch.where(act, H_row, H)
        start = torch.where(act, S_row, start)
        F = torch.where(act, F_new, F)

        # clipped-end candidates (i < qlen): earliest row, then smallest column
        mid_active = row_active & (i < ql)
        H_masked = torch.where(jmask, H, NEG)
        row_best_j = torch.argmax(H_masked, dim=1)  # first maximum
        row_best = H_masked[rows_b, row_best_j] - clip
        improve = mid_active & (row_best > best_mid)
        best_mid = torch.where(improve, row_best, best_mid)
        best_mid_start = torch.where(improve, start[rows_b, row_best_j], best_mid_start)
        best_mid_end = torch.where(improve, row_best_j.to(i32), best_mid_end)

    H_masked = torch.where(jmask, H, NEG)
    final_j = torch.argmax(H_masked, dim=1)
    final_score = H_masked[rows_b, final_j]
    final_start = start[rows_b, final_j]

    use_clip_end = best_mid > final_score  # a full query wins a tie
    has_q = ql > 0
    score = torch.where(use_clip_end, best_mid, final_score)
    begin = torch.where(use_clip_end, best_mid_start, final_start)
    end = torch.where(use_clip_end, best_mid_end, final_j.to(i32))
    score = torch.where(has_q, score, 0)
    begin = torch.where(has_q, begin, 0)
    end = torch.where(has_q, end, 0)
    return score.to(i32), begin.to(i32), end.to(i32)


def check_kernel_inputs(name: str, queries, q_lens, databases, d_lens) -> None:
    """The layout the SW kernels take: CUDA tensors on one device, uint8
    [B, M] and [B, N] codes, int32 [B] lengths, all contiguous. `name` is
    the caller's, for the messages."""
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: kernel inputs must be CUDA tensors, got {dev}")
    for arg, t, dtype, ndim in (
        ("queries", queries, torch.uint8, 2),
        ("q_lens", q_lens, torch.int32, 1),
        ("databases", databases, torch.uint8, 2),
        ("d_lens", d_lens, torch.int32, 1),
    ):
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, queries on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} must be {dtype}, got {t.dtype}")
        if t.dim() != ndim:
            raise ValueError(f"{name}: {arg} must have {ndim} dims, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    B = queries.shape[0]
    if databases.shape[0] != B or q_lens.shape[0] != B or d_lens.shape[0] != B:
        raise ValueError(
            f"{name}: batch sizes differ: "
            f"{queries.shape[0]}, {q_lens.shape[0]}, {databases.shape[0]}, {d_lens.shape[0]}"
        )
    if max(B, queries.shape[1], databases.shape[1]) >= 2**31:
        raise ValueError(f"{name}: B, M and N must each fit in an int32")


def sw_align_rot(
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
    check_kernel_inputs("sw_align_rot", queries, q_lens, databases, d_lens)
    dev = queries.device
    B, M = queries.shape
    N = databases.shape[1]
    with torch.cuda.device(dev):
        out = torch.empty((3, B), dtype=torch.int32, device=dev)
        # the boundary row between bands of query rows, read and written once
        # per band; a query of one band needs none
        needs = M > lib.gt_sw_rot_band_rows()
        scratch = torch.empty((3, B, N), dtype=torch.int32, device=dev) if needs else None
        rc = lib.gt_sw_rot(
            queries.data_ptr(), q_lens.data_ptr(), databases.data_ptr(), d_lens.data_ptr(),
            out.data_ptr(), None if scratch is None else scratch.data_ptr(),
            B, M, N, match, mismatch, gap_open, gap_extend, clip,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"sw_rot kernel launch failed: cudaGetLastError() = {rc}")
    counters.add("sw_rot")
    return out[0], out[1], out[2]
