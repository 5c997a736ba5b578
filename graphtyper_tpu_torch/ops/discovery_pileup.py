"""Per-event aggregation of discovery first-pass rows on a torch device.

Port of graphtyper_tpu/ops/discovery_pileup.py:117 aggregate_rows: six
segment sums (hq, lq, proper, first, rev, clip) and two segment maxima
(mapq, distance) per event, with empty maxima clamped to 0 (:94-112). Every
row batch goes to the given device; there is no row-count threshold.
`segment_counters`, the counterpart of the jitted `_jitted_agg_cached`
(:85-116), launches the hand-written kernel csrc/discovery_pileup.cu on a
CUDA tensor, or raises, and runs `segment_counters_plain` (`index_add_`
and `scatter_reduce_`) on a CPU tensor. The three smallest distinct read
positions stay on the host (`_uniq_pos3`, copied with `count_pairs` from
the JAX module).
"""

from __future__ import annotations

import numpy as np
import torch

from graphtyper_tpu_torch import counters, kernels

__all__ = ["N_COUNTERS", "aggregate_rows", "count_pairs", "segment_counters", "segment_counters_plain"]

N_COUNTERS = 11  # hq lq proper first rev clip max_mapq max_dist up1 up2 up3


def _uniq_pos3(r_ev: np.ndarray, r_readpos: np.ndarray, n_events: int) -> np.ndarray:
    """[n_events, 3] int64: the 3 smallest distinct read positions of the
    SNP rows per event, -1-padded (EvSupport.uniq_pos1/2/3 semantics)."""
    out = np.full((n_events, 3), -1, dtype=np.int64)
    mask = r_readpos >= 0
    if not mask.any():
        return out
    ev = r_ev[mask].astype(np.int64)
    pos = r_readpos[mask]
    order = np.lexsort((pos, ev))
    ev = ev[order]
    pos = pos[order]
    keep = np.ones(len(ev), dtype=bool)
    keep[1:] = (ev[1:] != ev[:-1]) | (pos[1:] != pos[:-1])
    ev = ev[keep]
    pos = pos[keep]
    starts = np.searchsorted(ev, np.arange(n_events + 1))
    for k in range(3):
        idx = starts[:-1] + k
        ok = idx < starts[1:]
        out[ok, k] = pos[idx[ok]]
    return out


def count_pairs(p_a: np.ndarray, p_b: np.ndarray, n_events: int):
    """Compact raw phase-pair rows into unique (a, b) -> count arrays
    (the per-event phase maps of caller.cpp:1204-1236). Order-free."""
    if len(p_a) == 0:
        return (
            np.zeros(0, dtype=np.int32),
            np.zeros(0, dtype=np.int32),
            np.zeros(0, dtype=np.int64),
        )
    key = p_a.astype(np.int64) * np.int64(n_events) + p_b.astype(np.int64)
    uniq, counts = np.unique(key, return_counts=True)
    return (
        (uniq // n_events).astype(np.int32),
        (uniq % n_events).astype(np.int32),
        counts.astype(np.int64),
    )


def segment_counters(mat: torch.Tensor, n_events: int) -> torch.Tensor:
    """[n_events, 8] int64 counters from the [6, N] row matrix (ev, dhq,
    dlq, bits, mapq, dist), on the matrix's device. Rows with ev ==
    n_events (the overflow segment padding uses) are dropped. A CPU tensor
    runs `segment_counters_plain`; a CUDA tensor (int64, contiguous) goes
    to csrc/discovery_pileup.cu, built at first use (a `torch.empty` output
    that the launcher zeroes with one memset, then one launch), or the call
    raises."""
    if mat.device.type == "cpu":
        return segment_counters_plain(mat, n_events)
    dev = mat.device
    lib = kernels.load()
    kernels.check_cuda("segment_counters", dev, (("mat", mat, torch.int64, 2),))
    if mat.shape[0] != 6:
        raise ValueError(f"segment_counters: mat must have 6 rows, got {tuple(mat.shape)}")
    with kernels.device_guard(dev):
        out = torch.empty((n_events, 8), dtype=torch.int64, device=dev)
        rc = lib.gt_discovery_pileup(mat.data_ptr(), mat.shape[1], n_events, out.data_ptr(),
                                     kernels.stream_of(dev))
    if rc != 0:
        raise RuntimeError(f"discovery_pileup kernel launch failed: cudaGetLastError() = {rc}")
    counters.add("segment_counters")
    return out


def segment_counters_plain(mat: torch.Tensor, n_events: int) -> torch.Tensor:
    """The torch-op version of `segment_counters`: `index_add_` for the
    sums, `scatter_reduce_("amax")` from zeros for the maxima. Each call
    bumps the `segment_counters_plain` counter, on any device."""
    counters.add("segment_counters_plain")
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
    counters.add("pileup_rows", n)
    out[:, :8] = segment_counters(torch.from_numpy(mat).to(device), n_events).cpu().numpy()
    out[:, 8:11] = _uniq_pos3(r_ev, r_readpos, n_events)
    return out
