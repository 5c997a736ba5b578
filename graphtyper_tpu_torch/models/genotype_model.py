"""Diploid genotype likelihood model.

Reference semantics: src/graph/haplotype.cpp — the ε-exponent integer scoring
(explain_to_score :462-585: base EPSILON_0_EXPONENT=12, integer penalties,
max(…,8)−4 clamp; the diploid PL triangle log_score[x<=y] += ε·both +
(ε−1)·either), coverage state machine (add_coverage :180-225,
coverage_to_gts :315-361), per-allele stats accumulators (:228-313), and the
PL conversion PL = round((max−score)·10·log10(2)) (vcf.cpp:47-82).

This module is the per-site host implementation; ops/likelihood.py computes
the same update as a batched Gram matmul for the TPU path (the triangle
update decomposes as u_x + u_y + W_xy with u = Bᵀ(ε−1), W = Bᵀdiag(2−ε)B
over the read-explains bitmap B).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from graphtyper_tpu_torch.constants import (
    EPSILON_0_EXPONENT,
    IS_FIRST_IN_PAIR,
    IS_MAPQ_BAD,
    IS_REVERSED,
    LOG10_HALF_TIMES_10,
)
from graphtyper_tpu_torch.graph.graph import Genotype

NO_COVERAGE = 0xFFFF
MULTI_ALT_COVERAGE = 0xFFFE
MULTI_REF_COVERAGE = 0xFFFD


def to_index(x: int, y: int) -> int:
    """Upper-triangular pair index (graph_help_functions.hpp:21)."""
    return x + (y * (y + 1)) // 2


@dataclass
class ReadStrand:
    r1_forward: int = 0
    r1_reverse: int = 0
    r2_forward: int = 0
    r2_reverse: int = 0

    def merge_with(self, o: "ReadStrand") -> None:
        self.r1_forward += o.r1_forward
        self.r1_reverse += o.r1_reverse
        self.r2_forward += o.r2_forward
        self.r2_reverse += o.r2_reverse


@dataclass
class VarStatsPerAllele:
    clipped_bp: int = 0
    mapq_squared: int = 0
    score_diff: int = 0
    mismatches: int = 0
    qd_qual: int = 0
    qd_depth: int = 0
    total_depth: int = 0
    ac: int = 0
    pass_ac: int = 0
    n_ref_ref: int = 0
    n_ref_alt: int = 0
    n_alt_alt: int = 0
    maximum_alt_support: int = 0
    maximum_alt_support_ratio: float = 0.0
    het_multi_allele_depth: tuple[int, int] = (0, 0)
    hom_multi_allele_depth: tuple[int, int] = (0, 0)


@dataclass
class VarStats:
    per_allele: list[VarStatsPerAllele] = field(default_factory=list)
    read_strand: list[ReadStrand] = field(default_factory=list)
    clipped_reads: int = 0
    mapq_squared: int = 0
    n_genotyped: int = 0
    n_calls: int = 0
    n_passed_calls: int = 0
    n_max_alt_proper_pairs: int = 0
    seqdepth: int = 0
    het_allele_depth: list[int] = field(default_factory=lambda: [0, 0])
    hom_allele_depth: list[int] = field(default_factory=lambda: [0, 0])

    @classmethod
    def sized(cls, allele_count: int) -> "VarStats":
        return cls(
            per_allele=[VarStatsPerAllele() for _ in range(allele_count)],
            read_strand=[ReadStrand() for _ in range(allele_count)],
        )

    def add_stats(self, o: "VarStats") -> None:
        """Cross-pool reduction (var_stats.cpp:141-196)."""
        assert len(self.per_allele) == len(o.per_allele)
        self.clipped_reads += o.clipped_reads
        self.mapq_squared += o.mapq_squared
        self.n_genotyped += o.n_genotyped
        self.n_calls += o.n_calls
        self.n_passed_calls += o.n_passed_calls
        self.n_max_alt_proper_pairs += o.n_max_alt_proper_pairs
        self.het_allele_depth[0] += o.het_allele_depth[0]
        self.het_allele_depth[1] += o.het_allele_depth[1]
        self.hom_allele_depth[0] += o.hom_allele_depth[0]
        self.hom_allele_depth[1] += o.hom_allele_depth[1]
        self.seqdepth += o.seqdepth
        for a, b in zip(self.per_allele, o.per_allele):
            a.clipped_bp += b.clipped_bp
            a.mapq_squared += b.mapq_squared
            a.score_diff += b.score_diff
            a.mismatches += b.mismatches
            a.qd_qual += b.qd_qual
            a.qd_depth += b.qd_depth
            a.total_depth += b.total_depth
            a.ac += b.ac
            a.pass_ac += b.pass_ac
            a.maximum_alt_support = max(a.maximum_alt_support, b.maximum_alt_support)
            a.maximum_alt_support_ratio = max(a.maximum_alt_support_ratio, b.maximum_alt_support_ratio)
            a.n_ref_ref += b.n_ref_ref
            a.n_ref_alt += b.n_ref_alt
            a.n_alt_alt += b.n_alt_alt
            a.het_multi_allele_depth = (
                a.het_multi_allele_depth[0] + b.het_multi_allele_depth[0],
                a.het_multi_allele_depth[1] + b.het_multi_allele_depth[1],
            )
            a.hom_multi_allele_depth = (
                a.hom_multi_allele_depth[0] + b.hom_multi_allele_depth[0],
                a.hom_multi_allele_depth[1] + b.hom_multi_allele_depth[1],
            )
        for a, b in zip(self.read_strand, o.read_strand):
            a.merge_with(b)


@dataclass
class HapSample:
    """Per-sample scoring state of one variant site (haplotype.hpp HapSample)."""

    log_score: np.ndarray = None  # [cnum*(cnum+1)/2] int64
    gt_coverage: np.ndarray = None  # [num] uint16-sat counts
    ambiguous_depth: int = 0
    ambiguous_depth_alt: int = 0
    alt_proper_pair_depth: int = 0
    max_log_score: int = 0

    def increment_ambiguous_depth(self) -> None:
        if self.ambiguous_depth < 0xFF:
            self.ambiguous_depth += 1

    def increment_ambiguous_depth_alt(self) -> None:
        if self.ambiguous_depth_alt < 0xFF:
            self.ambiguous_depth_alt += 1

    def increment_allele_depth(self, allele_index: int) -> None:
        if self.gt_coverage[allele_index] < 0xFFFF:
            self.gt_coverage[allele_index] += 1

    def increment_alt_proper_pair_depth(self) -> None:
        if self.alt_proper_pair_depth < 0xFF:
            self.alt_proper_pair_depth += 1


class HaplotypeSite:
    """One variant site's scoring state (reference's Haplotype class)."""

    def __init__(self, gt: Genotype):
        self.gt = gt
        self.var_stats = VarStats.sized(gt.num)
        self.explains: set[int] = set()
        self.coverage: int = NO_COVERAGE
        self.hap_samples: list[HapSample] = []

    def clear_and_resize_samples(self, n: int) -> None:
        cnum = self.gt.num
        # per-site [n, T] matrix; every sample's log_score is a row view so
        # batched device deltas fold in with ONE add per site
        # (ops/site_scoring._materialize) while the per-sample host path
        # mutates the same storage
        self.log_scores = np.zeros((n, cnum * (cnum + 1) // 2), dtype=np.int64)
        # gt_coverage rows share one [n, cnum] matrix too, so add_haplotype
        # derives the whole cohort's AD/PL columns without re-stacking
        self.gt_coverages = np.zeros((n, cnum), dtype=np.int64)
        self.hap_samples = [
            HapSample(
                log_score=self.log_scores[i],
                gt_coverage=self.gt_coverages[i],
            )
            for i in range(n)
        ]

    # -- coverage state machine (haplotype.cpp:180-225) -------------------

    def add_coverage(self, c: int) -> None:
        if self.coverage == NO_COVERAGE:
            self.coverage = c
        elif self.coverage == MULTI_ALT_COVERAGE:
            if c == 0:
                self.coverage = MULTI_REF_COVERAGE
        elif self.coverage == MULTI_REF_COVERAGE:
            pass
        elif self.coverage != c:
            if self.coverage == 0 or c == 0:
                self.coverage = MULTI_REF_COVERAGE
            else:
                self.coverage = MULTI_ALT_COVERAGE

    # -- stats accumulators ----------------------------------------------

    def clipped_reads_to_stats(self, clipped_bp: int, read_length: int) -> None:
        if clipped_bp == 0:
            return
        scaled = (clipped_bp * 1000) // read_length
        if self.coverage != NO_COVERAGE:
            self.var_stats.clipped_reads += 1
        if self.coverage < MULTI_REF_COVERAGE:
            self.var_stats.per_allele[self.coverage].clipped_bp += scaled

    def mapq_to_stats(self, mapq: int) -> None:
        if mapq == 255:
            return
        sq = mapq * mapq
        if self.coverage != NO_COVERAGE:
            self.var_stats.mapq_squared += sq
        if self.coverage < MULTI_REF_COVERAGE:
            self.var_stats.per_allele[self.coverage].mapq_squared += sq

    def strand_to_stats(self, flags: int) -> None:
        if self.coverage < MULTI_REF_COVERAGE:
            forward = (flags & IS_REVERSED) == 0
            first = (flags & IS_FIRST_IN_PAIR) != 0
            rs = self.var_stats.read_strand[self.coverage]
            if forward:
                if first:
                    rs.r1_forward += 1
                else:
                    rs.r2_forward += 1
            else:
                if first:
                    rs.r1_reverse += 1
                else:
                    rs.r2_reverse += 1

    def mismatches_to_stats(self, mismatches: int, read_length: int) -> None:
        if mismatches == 0:
            return
        if self.coverage < MULTI_REF_COVERAGE:
            self.var_stats.per_allele[self.coverage].mismatches += (mismatches * 1000) // read_length

    def score_diff_to_stats(self, score_diff: int) -> None:
        if score_diff == 0:
            return
        if self.coverage < MULTI_REF_COVERAGE:
            self.var_stats.per_allele[self.coverage].score_diff += score_diff

    # -- genotype depth (haplotype.cpp:315-361) --------------------------

    def coverage_to_gts(self, pn_index: int, is_proper_pair: bool) -> None:
        s = self.hap_samples[pn_index]
        c = self.coverage
        if c == NO_COVERAGE:
            pass
        elif c == MULTI_REF_COVERAGE:
            s.increment_ambiguous_depth()
        elif c == MULTI_ALT_COVERAGE:
            s.increment_ambiguous_depth()
            s.increment_ambiguous_depth_alt()
            if is_proper_pair:
                s.increment_alt_proper_pair_depth()
        else:
            s.increment_allele_depth(c)
            if c > 0 and is_proper_pair:
                s.increment_alt_proper_pair_depth()

    # -- likelihood update (haplotype.cpp:462-585) -----------------------

    @staticmethod
    def epsilon_exponent(
        non_unique_paths: bool,
        flags: int,
        fully_aligned: bool,
        is_read_overlapping: bool,
        is_low_qual: bool,
        mismatches: int,
    ) -> int:
        e = EPSILON_0_EXPONENT
        e -= 1 * mismatches  # MISMATCH_PENALTY
        if non_unique_paths:
            e -= 3  # NON_UNIQUE_PATHS_PENALTY
        if flags & IS_MAPQ_BAD:
            e -= 2  # BAD_MAPQ_PENALTY
        if not fully_aligned:
            e -= 3  # NOT_FULLY_ALIGNED_READ_PENALTY
        if not is_read_overlapping:
            e -= 1  # IS_READ_OVERLAPPING_PENALTY
        if is_low_qual:
            e -= 2  # IS_LOW_QUAL
        return max(e, 8) - 4  # -4 "for historical reasons"

    def explain_to_score(
        self,
        pn_index: int,
        non_unique_paths: bool,
        flags: int,
        fully_aligned: bool,
        is_read_overlapping: bool,
        is_low_qual: bool,
        mismatches: int,
    ) -> None:
        eps = self.epsilon_exponent(
            non_unique_paths, flags, fully_aligned, is_read_overlapping, is_low_qual, mismatches
        )
        cnum = self.gt.num
        sample = self.hap_samples[pn_index]
        if sample.max_log_score >= 0xFFFF - eps:
            return  # maxed out (read depth > ~6000x)
        sample.max_log_score += eps
        expl = np.zeros(cnum, dtype=bool)
        for e in self.explains:
            if e < cnum:
                expl[e] = True
        i = 0
        for y in range(cnum):
            for x in range(y + 1):
                if expl[x] and expl[y]:
                    sample.log_score[i] += eps
                elif expl[x] or expl[y]:
                    sample.log_score[i] += eps - 1
                i += 1

    def update_max_log_score(self) -> None:
        for s in self.hap_samples:
            s.max_log_score = int(s.log_score.max())


def get_haplotype_phred(sample: HapSample) -> np.ndarray:
    """PL vector from log scores (vcf.cpp get_haplotype_phred :47-82)."""
    max_score = int(sample.log_score.max())
    if (sample.log_score == max_score).all():
        return np.zeros(len(sample.log_score), dtype=np.int64)
    scores = np.rint((max_score - sample.log_score) * LOG10_HALF_TIMES_10).astype(np.int64)
    return np.minimum(scores, 255)
