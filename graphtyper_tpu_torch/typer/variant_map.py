"""Legacy per-sample variant-candidate discovery store.

Port of the reference's VariantCandidate / VariantSupport / VariantMap
(variant_candidate.cpp, variant_support.cpp, variant_map.cpp). In the
reference its producers are dead code (parallel_reader_with_discovery is
commented out, hts_parallel_reader.cpp:1034-1222) and live discovery is the
streamlined path (typer/discovery.py here) — but genotype_camou still loads
``*_variant_map`` files (genotype_camou.cpp:188-197), and the quality gates
(VariantSupport scoring, strand/read-bias pool filters, 100bp soft cap) are
part of the documented surface, so the store is kept functional.

Candidates are produced by typer/haplotype_extractor.find_variants_in_alignment.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass, field

from graphtyper_tpu_torch.constants import (
    IS_CLIPPED,
    IS_FIRST_IN_PAIR,
    IS_LOW_BASE_QUAL,
    IS_MAPQ_BAD,
    IS_PROPER_PAIR,
    IS_REVERSED,
)


@dataclass
class VariantCandidate:
    """A discovered (not yet genotyped) variant: {abs_pos, seqs=[ref, alts...],
    read-evidence flags} (variant_candidate.hpp:18-62)."""

    abs_pos: int = 0
    original_pos: int = 0
    seqs: list[bytes] = field(default_factory=list)
    flags: int = 0

    def key(self) -> tuple:
        return (self.abs_pos, tuple(self.seqs))

    def __hash__(self):
        return hash(self.key())

    def __eq__(self, o) -> bool:
        return self.abs_pos == o.abs_pos and self.seqs == o.seqs

    def __lt__(self, o) -> bool:
        return (self.abs_pos, self.seqs) < (o.abs_pos, o.seqs)

    def is_snp_or_snps(self) -> bool:
        return all(len(s) == len(self.seqs[0]) for s in self.seqs[1:])

    def is_normalized(self) -> bool:
        """Graph-free form check (variant_candidate.cpp is_normalized goes
        through Variant::normalize; here: no trimmable common suffix/prefix)."""
        seqs = self.seqs
        if len(seqs) < 2 or any(len(s) == 0 for s in seqs):
            return False
        if all(len(s) > 1 for s in seqs) and len({s[-1:] for s in seqs}) == 1:
            return False
        if all(len(s) > 1 for s in seqs) and len({s[:1] for s in seqs}) == 1:
            return False
        return True

    def is_transition_or_transversion(self) -> int:
        """0 = not a simple SNP, 1 = transition, 2 = transversion
        (variant_candidate.cpp:~60)."""
        if len(self.seqs) == 2 and len(self.seqs[0]) == 1 and len(self.seqs[1]) == 1:
            pair = self.seqs[0] + self.seqs[1]
            if pair in (b"AG", b"GA", b"CT", b"TC"):
                return 1
            return 2
        return 0

    def print(self) -> str:
        return f"{self.abs_pos} {b','.join(self.seqs).decode()}"


@dataclass
class VariantSupport:
    """Per-sample evidence accumulator for one candidate
    (variant_support.hpp:10-40, variant_support.cpp)."""

    hq_support: int = 0
    lq_support: int = 0
    proper_pairs: int = 0
    depth: int = 0
    first_in_pairs: int = 0
    sequence_reversed: int = 0
    clipped: int = 0
    var_size: int = 0
    growth: int = 0
    unique_positions: set = field(default_factory=set)
    is_indel: bool = False
    is_any_mapq_good: bool = False

    def set_depth(self, depth: int) -> None:
        self.depth = max(self.depth, depth)

    def get_corrected_support(self) -> float:
        correction = (self.var_size // 3 + 10.0) / 10.0
        return correction * (self.hq_support + self.lq_support / 2.0)

    def get_ratio(self) -> float:
        effective_depth = self.depth - self.lq_support // 2
        if effective_depth < 0.99:
            return 1.0
        growth_correction = (self.growth // 3 + 10.0) / 10.0
        return self.get_corrected_support() / effective_depth * growth_correction

    def get_score(self) -> int:
        score = int(self.get_corrected_support() * self.get_ratio() * 10.0 + 0.5)
        if self.hq_support >= 4 and self.proper_pairs >= 4 and (
            self.hq_support + self.lq_support - self.clipped >= 3
        ):
            score += 20
        if self.hq_support >= 8 and self.proper_pairs >= 8 and (
            self.hq_support + self.lq_support - self.clipped >= 6
        ):
            score += 30
        return score

    def is_support_above_cutoff(self, min_support: int, options=None) -> bool:
        depth = self.hq_support + self.lq_support
        is_promising = (
            len(self.unique_positions) >= 3
            and self.hq_support >= 4
            and self.proper_pairs >= 3
            and depth - self.clipped >= 3
        )
        no_filter_on_begin_pos = getattr(options, "no_filter_on_begin_pos", False)
        filter_on_mapq = getattr(options, "filter_on_mapq", True)
        filter_on_proper_pairs = getattr(options, "filter_on_proper_pairs", True)
        filter_on_read_bias = getattr(options, "filter_on_read_bias", True)
        filter_on_strand_bias = getattr(options, "filter_on_strand_bias", True)
        return (
            (no_filter_on_begin_pos or len(self.unique_positions) > 1)
            and (not filter_on_mapq or self.is_any_mapq_good)
            and (
                not filter_on_proper_pairs
                or self.proper_pairs >= 2
                or (self.proper_pairs >= 1 and self.is_indel)
            )
            and (self.hq_support >= 3 or (self.hq_support >= 2 and self.is_indel))
            and (
                not filter_on_read_bias
                or self.is_indel
                or is_promising
                or (0 < self.first_in_pairs < depth)
            )
            and (
                not filter_on_strand_bias
                or self.is_indel
                or (is_promising and 0 < self.sequence_reversed < depth)
                or (1 < self.sequence_reversed < depth - 1)
            )
            and (
                self.clipped <= depth - 3
                or (self.is_indel and self.clipped <= depth - 1)
            )
            and int(self.get_corrected_support() + 0.5) >= min_support
        )

    def is_ratio_above_cutoff(self, min_ratio: float) -> bool:
        return self.get_ratio() > min_ratio

    def is_above_cutoff(self, min_support: int, min_ratio: float, options=None) -> bool:
        return self.is_support_above_cutoff(min_support, options) and self.is_ratio_above_cutoff(
            min_ratio
        )


def _abs_dev_strand_bias(supports: list[VariantSupport]) -> tuple[float, int]:
    depth = sum(s.lq_support + s.hq_support for s in supports)
    rev = sum(s.sequence_reversed for s in supports)
    return abs(rev / depth - 0.5) if depth else 0.0, depth


def _abs_dev_read_bias(supports: list[VariantSupport]) -> tuple[float, int]:
    depth = sum(s.lq_support + s.hq_support for s in supports)
    first = sum(s.first_in_pairs for s in supports)
    return abs(first / depth - 0.5) if depth else 0.0, depth


class VariantMap:
    """Per-sample candidate→support maps, pooled and filtered
    (variant_map.cpp:66-453)."""

    def __init__(self, n_samples: int = 0, minimum_variant_support: int = 5,
                 minimum_variant_support_ratio: float = 0.25):
        self.samples: list[str] = []
        self.varmaps: list[dict[VariantCandidate, VariantSupport]] = [
            {} for _ in range(n_samples)
        ]
        self.pool_varmap: dict[VariantCandidate, list[VariantSupport]] = {}
        self.minimum_variant_support = minimum_variant_support
        self.minimum_variant_support_ratio = minimum_variant_support_ratio

    def set_samples(self, samples: list[str]) -> None:
        self.samples = list(samples)
        if len(self.varmaps) != len(samples):
            self.varmaps = [{} for _ in samples]

    # ------------------------------------------------------------------
    def add_variants(self, graph, variants: list[VariantCandidate], sample_index: int) -> None:
        """Accumulate per-read candidate evidence (variant_map.cpp:66-112)."""
        varmap = self.varmaps[sample_index]
        for var in variants:
            sup = varmap.get(var)
            if sup is None:
                sup = VariantSupport()
                sup.is_indel = len(var.seqs[0]) != len(var.seqs[1])
                old_size = max(len(var.seqs[0]), len(var.seqs[1])) - 1
                expanded = _expanded_normalized(graph, var)
                sup.var_size = max(len(s) for s in expanded.seqs) - 1
                sup.growth = max(0, sup.var_size - old_size)
                varmap[VariantCandidate(var.abs_pos, var.original_pos, list(var.seqs), 0)] = sup
            sup.depth += 1
            low = (var.flags & IS_LOW_BASE_QUAL) != 0
            sup.lq_support += low
            sup.hq_support += not low
            sup.proper_pairs += (var.flags & IS_PROPER_PAIR) != 0
            if (var.flags & IS_MAPQ_BAD) == 0:
                sup.is_any_mapq_good = True
            sup.first_in_pairs += (var.flags & IS_FIRST_IN_PAIR) != 0
            sup.sequence_reversed += (var.flags & IS_REVERSED) != 0
            sup.clipped += (var.flags & IS_CLIPPED) != 0
            sup.unique_positions.add(var.original_pos)

    # ------------------------------------------------------------------
    def create_varmap_for_all(self, reference_depth, options=None) -> None:
        """Pool per-sample maps; per sample, adaptively raise the min-support
        cutoff while the transition/transversion ratio looks noise-dominated
        (variant_map.cpp:114-200)."""
        for i, varmap in enumerate(self.varmaps):
            new_min_support = self.minimum_variant_support
            if len(varmap) > 50:
                while new_min_support < 15:
                    transitions = transversions = above = 0
                    for cand, sup in varmap.items():
                        if sup.is_support_above_cutoff(new_min_support, options):
                            above += 1
                            r = cand.is_transition_or_transversion()
                            if r == 1:
                                transitions += 1
                            elif r == 2:
                                transversions += 1
                    tv = max(transversions, 1)
                    if (
                        (above > 50 and transversions > transitions)
                        or (above > 75 and transitions / tv < 1.2)
                        or (above > 150 and transitions / tv < 1.3)
                    ):
                        new_min_support += 1
                    else:
                        break
            for cand, sup in varmap.items():
                if sup.is_support_above_cutoff(new_min_support, options):
                    if reference_depth is not None:
                        sup.set_depth(reference_depth.get_read_depth(cand.abs_pos, i))
                    if sup.is_ratio_above_cutoff(self.minimum_variant_support_ratio):
                        self.pool_varmap.setdefault(cand, []).append(sup)

    # ------------------------------------------------------------------
    def filter_varmap_for_all(self, graph=None, soft_cap_100bp: int = 22) -> None:
        """Pool-level filters: strand/read bias on low-quality candidates and a
        best-score soft cap per 100bp window (variant_map.cpp:202-372)."""
        if not self.pool_varmap:
            return
        keep: dict[VariantCandidate, list[VariantSupport]] = {}
        for cand in sorted(self.pool_varmap):
            sups = self.pool_varmap[cand]
            is_any_hq = any(s.hq_support >= 5 and s.proper_pairs >= 5 for s in sups)
            is_indel = sups[0].is_indel
            if not is_any_hq:
                sb, depth = _abs_dev_strand_bias(sups)
                if is_indel and sb > 0.07:
                    sb -= 0.07
                if (
                    sb > 0.49999
                    or (sb > 0.45 and depth > 30)
                    or (sb > 0.40 and depth > 80)
                    or (sb > 0.37 and depth > 200)
                    or (sb > 0.34 and depth > 500)
                ):
                    continue
                if not is_indel:
                    rb, depth = _abs_dev_read_bias(sups)
                    if (
                        (rb > 0.49999 and depth > 10)
                        or (rb > 0.45 and depth > 40)
                        or (rb > 0.40 and depth > 100)
                        or (rb > 0.35 and depth > 500)
                    ):
                        continue
            keep[cand] = sups
        self.pool_varmap = keep
        # 100bp-window soft cap on total candidate count
        if len(self.pool_varmap) > soft_cap_100bp:
            by_bucket: dict[int, list[VariantCandidate]] = {}
            for cand in self.pool_varmap:
                by_bucket.setdefault(cand.abs_pos // 100, []).append(cand)
            for bucket_cands in by_bucket.values():
                if len(bucket_cands) <= soft_cap_100bp:
                    continue
                scores = {
                    c: max(s.get_score() for s in self.pool_varmap[c]) for c in bucket_cands
                }
                ordered = sorted(scores.values())
                min_score_pass = min(50, ordered[len(ordered) - soft_cap_100bp])
                for c in bucket_cands:
                    if scores[c] < min_score_pass:
                        del self.pool_varmap[c]

    # ------------------------------------------------------------------
    def get_variants(self) -> list[VariantCandidate]:
        """Final pooled candidates in position order (VariantMap::get_vcf,
        variant_map.cpp:571-584 emits these as sites-only VCF records)."""
        return sorted(self.pool_varmap)

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(
                {
                    "samples": self.samples,
                    "pool_varmap": [
                        (c.abs_pos, c.original_pos, c.seqs, c.flags, sups)
                        for c, sups in self.pool_varmap.items()
                    ],
                    "minimum_variant_support": self.minimum_variant_support,
                    "minimum_variant_support_ratio": self.minimum_variant_support_ratio,
                },
                f,
            )

    @classmethod
    def load(cls, path: str) -> "VariantMap":
        with open(path, "rb") as f:
            d = pickle.load(f)
        vm = cls(
            minimum_variant_support=d["minimum_variant_support"],
            minimum_variant_support_ratio=d["minimum_variant_support_ratio"],
        )
        vm.samples = d["samples"]
        for abs_pos, original_pos, seqs, flags, sups in d["pool_varmap"]:
            vm.pool_varmap[VariantCandidate(abs_pos, original_pos, seqs, flags)] = sups
        return vm


def _expanded_normalized(graph, cand: VariantCandidate) -> VariantCandidate:
    """Indels expand right while the appended reference base keeps all alleles
    agreeing — learns the true tandem-repeat size (variant.cpp
    expanded_normalized)."""
    if graph is None or all(len(s) == len(cand.seqs[0]) for s in cand.seqs[1:]):
        return cand
    from graphtyper_tpu_torch.typer.variant import Variant

    v = Variant(abs_pos=cand.abs_pos, seqs=list(cand.seqs))
    i = 0
    try:
        while v.add_base_in_back(graph):
            i += 1
            if i >= len(v.seqs[0]):
                break
            ref_base = v.seqs[0][i : i + 1]
            if any(s[i : i + 1] != ref_base for s in v.seqs[1:]):
                break
    except Exception:
        pass
    return VariantCandidate(v.abs_pos, cand.original_pos, v.seqs, cand.flags)
