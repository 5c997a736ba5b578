"""Per-event aggregation of discovery first-pass rows on a torch device.

Port of graphtyper_tpu/ops/discovery_pileup.py:117 aggregate_rows: six
segment sums (hq, lq, proper, first, rev, clip) and two segment maxima
(mapq, distance) per event, with empty maxima clamped to 0 (:94-112). Every
row batch goes to the given device; there is no row-count threshold. The
three smallest distinct read positions stay on the host (`_uniq_pos3`).
"""

from __future__ import annotations

import numpy as np
import torch

from graphtyper_tpu.ops.discovery_pileup import N_COUNTERS, _uniq_pos3, count_pairs
from graphtyper_tpu_torch import counters

__all__ = ["N_COUNTERS", "aggregate_rows", "count_pairs", "segment_counters"]


def segment_counters(mat: torch.Tensor, n_events: int) -> torch.Tensor:
    """[n_events, 8] int64 counters from the [6, N] row matrix (ev, dhq,
    dlq, bits, mapq, dist). Rows with ev == n_events (the overflow segment
    padding uses) are dropped."""
    mat = mat.to(torch.int64)
    ev, bits = mat[0], mat[3]
    sums = torch.stack(
        [mat[1], mat[2], bits & 1, (bits >> 1) & 1, (bits >> 2) & 1, (bits >> 3) & 1], dim=1
    )
    summed = torch.zeros((n_events + 1, 6), dtype=torch.int64, device=mat.device)
    summed.index_add_(0, ev, sums)
    # starting from 0 with include_self clamps empty segments (and any
    # negative value) to 0, as the JAX op's maximum(segment_max, 0) does
    maxed = torch.zeros((n_events + 1, 2), dtype=torch.int64, device=mat.device)
    maxed.scatter_reduce_(0, ev[:, None].expand(-1, 2), mat[4:6].T, "amax", include_self=True)
    return torch.cat([summed, maxed], dim=1)[:n_events]


def aggregate_rows(
    r_ev: np.ndarray,
    r_dhq: np.ndarray,
    r_dlq: np.ndarray,
    r_bits: np.ndarray,
    r_mapq: np.ndarray,
    r_dist: np.ndarray,
    r_readpos: np.ndarray,
    n_events: int,
    device: torch.device | str,
) -> np.ndarray:
    """The [n_events, 11] int64 counter matrix the gates consume (the
    gt_fp_gates layout), counters 0-7 computed on `device`. Port of
    graphtyper_tpu/ops/discovery_pileup.py:117."""
    n = len(r_ev)
    out = np.zeros((n_events, N_COUNTERS), dtype=np.int64)
    if n == 0:
        out[:, 8:11] = -1
        return out
    mat = np.stack([np.asarray(a, dtype=np.int64) for a in (r_ev, r_dhq, r_dlq, r_bits, r_mapq, r_dist)])
    counters.COUNTS["pileup_rows"] += n
    out[:, :8] = segment_counters(torch.from_numpy(mat).to(device), n_events).cpu().numpy()
    out[:, 8:11] = _uniq_pos3(r_ev, r_readpos, n_events)
    return out
