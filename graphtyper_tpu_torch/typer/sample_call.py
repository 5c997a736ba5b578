"""Per-sample call: PL vector, allele depths, GT/GQ/FT derivation.

Reference semantics: src/typer/sample_call.cpp (:33-172) — GT is the first
PL==0 pair in triangle order, GQ the second-lowest PL, FT thresholds
30/20/10.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from graphtyper_tpu_torch.models.genotype_model import to_index


@dataclass
class SampleCall:
    phred: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int64))  # PL, len R(R+1)/2
    coverage: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int64))  # AD per allele
    ambiguous_depth: int = 0
    alt_proper_pair_depth: int = 0
    ref_total_depth: int = 0
    alt_total_depth: int = 0
    filter: int = -1

    @classmethod
    def create(
        cls,
        phred: np.ndarray,
        coverage: np.ndarray,
        ambiguous_depth: int,
        ambiguous_depth_alt: int,
        alt_proper_pair_depth: int,
    ) -> "SampleCall":
        """sample_call.cpp:33-61 constructor: derives RA totals."""
        ref_depth = int(coverage[0]) + ambiguous_depth - ambiguous_depth_alt
        alt_depth = int(coverage[1:].sum()) + ambiguous_depth
        return cls(
            phred=np.asarray(phred, dtype=np.int64),
            coverage=np.asarray(coverage, dtype=np.int64),
            ambiguous_depth=ambiguous_depth,
            alt_proper_pair_depth=alt_proper_pair_depth,
            ref_total_depth=min(0xFFFF, ref_depth),
            alt_total_depth=min(0xFFFF, alt_depth),
        )

    def get_depth(self) -> int:
        return int(self.coverage.sum()) + self.ambiguous_depth

    def get_unique_depth(self) -> int:
        return int(self.coverage.sum())

    def get_alt_depth(self) -> int:
        return int(self.coverage[1:].sum()) + self.ambiguous_depth

    def get_gt_call(self) -> tuple[int, int]:
        if len(self.phred) == 0:
            return (0, 0)
        i = 0
        for y in range(len(self.coverage)):
            for x in range(y + 1):
                if self.phred[i] == 0:
                    return (x, y)
                i += 1
        return (0, 0)

    def get_gq(self) -> int:
        seen_zero = False
        next_lowest = 255
        for p in self.phred:
            if p == 0:
                if not seen_zero:
                    seen_zero = True
                else:
                    return 0
            elif p < next_lowest:
                next_lowest = int(p)
        return next_lowest

    def get_lowest_phred_not_with(self, allele: int) -> int:
        i = 0
        min_phred = 255
        for y in range(len(self.coverage)):
            if y == allele:
                i += y + 1
                continue
            for x in range(y + 1):
                if x == allele:
                    i += 1
                    continue
                if self.phred[i] < min_phred:
                    min_phred = int(self.phred[i])
                i += 1
        return min_phred

    def check_filter(self, gq: int) -> int:
        if self.filter < 0:
            if gq >= 30:
                self.filter = 0
            elif gq >= 20:
                self.filter = 1
            elif gq >= 10:
                self.filter = 2
            else:
                self.filter = 3
        return self.filter

    def make_bi_allelic(self, allele: int) -> "SampleCall":
        """Project PL/AD onto {ref, allele} (sample_call.hpp:61 semantics via
        variant.cpp make_biallelic mapping)."""
        n = len(self.coverage)
        mapping = np.zeros(n, dtype=np.int64)
        mapping[allele] = 1
        new_phred = np.full(3, 255, dtype=np.int64)
        new_cov = np.zeros(2, dtype=np.int64)
        for y in range(n):
            ny = mapping[y]
            for x in range(y + 1):
                nx = mapping[x]
                idx = to_index(x, y)
                nidx = to_index(min(nx, ny), max(nx, ny))
                new_phred[nidx] = min(new_phred[nidx], int(self.phred[idx]))
            new_cov[ny] = min(0xFFFF, new_cov[ny] + int(self.coverage[y]))
        return SampleCall(
            phred=new_phred,
            coverage=new_cov,
            ambiguous_depth=self.ambiguous_depth,
            alt_proper_pair_depth=self.alt_proper_pair_depth,
            ref_total_depth=self.ref_total_depth,
            alt_total_depth=self.alt_total_depth,
        )
