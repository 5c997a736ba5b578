"""Discovery first-pass aggregation through the port's device pileup.

Port of the two callers of aggregate_rows in
graphtyper_tpu/typer/native_discovery.py (:590 run_first_pass_rows, :607
aggregate_cohort). Extraction and gates stay the JAX package's native host
functions.
"""

from __future__ import annotations

import numpy as np
import torch

from graphtyper_tpu.typer.native_discovery import fp_extract, fp_gates
from graphtyper_tpu_torch.ops.discovery_pileup import aggregate_rows


def run_first_pass_rows(bam_bytes: bytes, target_ref: int, region_begin: int,
                        reference: bytes, opts, device: torch.device | str):
    """Single-file extract -> device aggregate -> gates; (buckets,
    sample_haplotypes) like run_first_pass_native, or None. Fork of
    graphtyper_tpu/typer/native_discovery.py:590."""
    x = fp_extract(bam_bytes, target_ref, region_begin, reference)
    if x is None:
        return None
    counters = aggregate_rows(
        x["r_ev"], x["r_dhq"], x["r_dlq"], x["r_bits"], x["r_mapq"],
        x["r_dist"], x["r_readpos"], len(x["ev_pos"]), device,
    )
    return fp_gates(x, counters, region_begin, reference, opts)


def aggregate_cohort(extracts: list, device: torch.device | str) -> list:
    """Every file's rows in ONE aggregation call (event ids offset per
    file); returns the per-file counter matrices. Fork of
    graphtyper_tpu/typer/native_discovery.py:607."""
    sizes = [len(x["ev_pos"]) for x in extracts]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    total = int(offsets[-1])
    if total == 0:
        return [np.zeros((0, 11), dtype=np.int64) for _ in extracts]
    r_ev = np.concatenate(
        [x["r_ev"].astype(np.int64) + offsets[i] for i, x in enumerate(extracts)]
    )

    def cat(k):
        return np.concatenate([x[k] for x in extracts])

    counters = aggregate_rows(
        r_ev, cat("r_dhq"), cat("r_dlq"), cat("r_bits"), cat("r_mapq"),
        cat("r_dist"), cat("r_readpos"), total, device,
    )
    return [counters[offsets[i] : offsets[i + 1]] for i in range(len(extracts))]
