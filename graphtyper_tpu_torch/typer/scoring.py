"""Per-read scoring: map aligned paths onto variant-site scoring state.

Reference semantics: src/typer/vcf_writer.cpp — are_genotype_paths_good
(:28-60), push_to_haplotype_scores (:503-676) including the phasing
connection weights (weight 6/weight), and VcfWriter construction (:66-86).

Port of graphtyper_tpu/typer/scoring.py: `SiteScorer` (:58) always has the
port's `ObsBatcher` on the device it is handed; the per-read host loop is
kept only for >64-allele sites, which fall outside the bitmask tiers.
`Options.device_scoring="off"`, which picks that host loop for every site
in the JAX package, is refused.
"""

from __future__ import annotations

import numpy as np
import torch

from graphtyper_tpu_torch.constants import IS_FIRST_IN_PAIR, IS_REVERSED
from graphtyper_tpu_torch.models.genotype_model import (
    MULTI_ALT_COVERAGE,
    MULTI_REF_COVERAGE,
    NO_COVERAGE,
    HaplotypeSite,
)
from graphtyper_tpu_torch.ops.site_scoring import COV_MULTI_ALT, COV_MULTI_REF, ObsBatcher, tier_for
from graphtyper_tpu_torch.typer.genotype_paths import GenotypePaths


def _add_cov(cov: int, c: int) -> int:
    """The coverage state machine (haplotype.cpp:180-225) as a pure function;
    the final class depends only on the set of added values."""
    if cov == NO_COVERAGE:
        return c
    if cov == MULTI_ALT_COVERAGE:
        return MULTI_REF_COVERAGE if c == 0 else MULTI_ALT_COVERAGE
    if cov == MULTI_REF_COVERAGE:
        return MULTI_REF_COVERAGE
    if cov != c:
        return MULTI_REF_COVERAGE if (cov == 0 or c == 0) else MULTI_ALT_COVERAGE
    return cov


def are_genotype_paths_good(geno: GenotypePaths, graph, hq_reads: bool = False) -> bool:
    if not geno.paths:
        return False
    fully_aligned = geno.all_paths_fully_aligned()
    if not fully_aligned and (not geno.all_paths_unique() or geno.paths[0].size() < 63):
        return False
    mismatch_ratio = geno.paths[0].mismatches / geno.paths[0].size()
    if mismatch_ratio > 0.05:
        return False
    if not fully_aligned and mismatch_ratio > 0.025:
        return False
    if graph.is_sv_graph:
        if not fully_aligned or geno.paths[0].size() < 90 or mismatch_ratio > 0.03:
            return False
    if hq_reads:
        if not fully_aligned or geno.paths[0].size() < 90 or mismatch_ratio > 0.035:
            return False
    return True


class SiteScorer:
    """Reference's VcfWriter scoring half: one HaplotypeSite per variant
    site, updated read-by-read.

    Observations are extracted per read on the host and buffered; `finalize()`
    applies them in batched segment-sum passes on `device`, or over the
    entries of `mesh` (ops/site_scoring.py). Sites with more than 64 alleles take the
    reference-shaped per-read host update.
    """

    def __init__(
        self,
        graph,
        sample_names: list[str],
        device: torch.device | str,
        hq_reads: bool = False,
        mesh=None,
    ):
        from graphtyper_tpu_torch.config import current_options

        if current_options().device_scoring == "off":
            raise ValueError("device_scoring='off' selects the JAX package's host scoring loop; "
                             "the torch port scores on its device only")
        self.graph = graph
        self.hq_reads = hq_reads
        self.sites = [HaplotypeSite(gt) for gt in graph.genotypes()]
        self.id2hap = {s.gt.id: i for i, s in enumerate(self.sites)}
        self.sample_names = list(sample_names)
        for s in self.sites:
            s.clear_and_resize_samples(len(sample_names))
        # phasing connections per (site, sample):
        # connections[hap_id][pn][allele1] = {hap_id2: counts[num2]}
        self.connections: list[list[dict[int, dict[int, np.ndarray]]]] = [
            [dict() for _ in sample_names] for _ in self.sites
        ]
        self.batcher = ObsBatcher(self.sites, len(sample_names), device, mesh=mesh)
        self._tier_for = tier_for

    def finalize(self) -> None:
        """Apply all buffered device observations; must run after the last
        read and before site state is consumed."""
        if self.batcher is not None:
            self.batcher.finalize()

    def _add_connections(self, merged, pn_index: int) -> None:
        """vcf_writer.cpp:120-141/229-251: accumulate into per-sample maps."""
        for (hap_id1, b1), targets in merged.items():
            conn = self.connections[hap_id1][pn_index].setdefault(b1, {})
            for hap_id2, b2 in targets:
                num2 = self.sites[hap_id2].gt.num
                arr = conn.get(hap_id2)
                if arr is None:
                    arr = np.zeros(num2, dtype=np.int64)
                    conn[hap_id2] = arr
                arr[b2] += 1

    def update_haplotype_scores(self, geno: GenotypePaths, pn_index: int, primers=None) -> None:
        """Single (unpaired) read (vcf_writer.cpp:88-141)."""
        if not are_genotype_paths_good(geno, self.graph, self.hq_reads):
            return
        if primers is not None:
            primers.check(geno)
        con1 = self.push_to_haplotype_scores(geno, pn_index)
        self._add_connections(con1, pn_index)

    def update_haplotype_scores_pair(
        self, geno1: GenotypePaths, geno2: GenotypePaths, pn_index: int, primers=None
    ) -> None:
        """Mate pair (vcf_writer.cpp:143-252): score both, then cross-link
        their connection keys before accumulating."""
        is_good1 = are_genotype_paths_good(geno1, self.graph, self.hq_reads)
        is_good2 = are_genotype_paths_good(geno2, self.graph, self.hq_reads)
        con1: dict = {}
        con2: dict = {}
        if is_good1:
            if primers is not None:
                primers.check(geno1)
            con1 = self.push_to_haplotype_scores(geno1, pn_index)
        if is_good2:
            if primers is not None:
                primers.check(geno2)
            con2 = self.push_to_haplotype_scores(geno2, pn_index)
        merged: dict = {}
        if con1 or con2:
            for key1, targets in con1.items():
                merged[key1] = list(targets)
                for key2 in con2:
                    if key2[0] > key1[0]:
                        merged[key1].append(key2)
            for key2, targets in con2.items():
                if key2 in merged:
                    merged[key2].extend(targets)
                else:
                    merged[key2] = list(targets)
                for key1 in con1:
                    if key1[0] > key2[0]:
                        merged[key2].append(key1)
        self._add_connections(merged, pn_index)

    def push_to_haplotype_scores(self, geno: GenotypePaths, pn_index: int):
        graph = self.graph
        clipped_bp = geno.read_length - geno.longest_path_length
        fully_aligned = clipped_bp == 0
        non_unique_paths = not geno.all_paths_unique()
        mismatches = geno.paths[0].mismatches
        has_low_quality_snp = False

        # -- extraction: per-site explains set + coverage class --------------
        site_explains: dict[int, set[int]] = {}
        site_cov: dict[int, int] = {}
        recent_ids: dict[int, bool] = {}
        new_connections: dict[tuple[int, int], list[tuple[int, int]]] = {}

        for path in geno.paths:
            for i, var_order in enumerate(path.var_order):
                num = path.nums[i]
                if len(num) == 0:
                    continue
                hap_id = self.id2hap[var_order]
                MIN_OFFSET = 3
                is_overlapping = (
                    path.start_ref_reach_pos(graph) + MIN_OFFSET <= var_order
                    and path.end_ref_reach_pos(graph) - MIN_OFFSET > var_order
                )
                recent_ids[hap_id] = recent_ids.get(hap_id, False) or is_overlapping

                if not has_low_quality_snp and graph.is_snp(self.sites[hap_id].gt) and geno.qual2 is not None:
                    offset = var_order - path.start_correct_pos(graph)
                    if 0 <= offset < len(geno.qual2):
                        has_low_quality_snp = int(geno.qual2[offset]) < 25

                ex = site_explains.get(hap_id)
                if ex is None:
                    ex = site_explains[hap_id] = set()
                    site_cov[hap_id] = NO_COVERAGE
                ex |= num
                cov = site_cov[hap_id]
                if len(num) == 1:
                    cov = _add_cov(cov, next(iter(num)))
                else:
                    cov = _add_cov(cov, 1)
                    cov = _add_cov(cov, 0 if 0 in num else 2)
                site_cov[hap_id] = cov

        # phasing connections (vcf_writer.cpp:587-638); recent_ids iterated in
        # sorted order like the reference's std::map
        sorted_ids = sorted(recent_ids.keys())
        for idx1, hap_id1 in enumerate(sorted_ids):
            ex1 = site_explains[hap_id1]
            n1 = len(ex1)
            if n1 == 0 or n1 > 64:
                continue
            for b1 in sorted(ex1):
                conn = new_connections.setdefault((hap_id1, b1), [])
                for hap_id2 in sorted_ids[idx1 + 1 :]:
                    ex2 = site_explains[hap_id2]
                    n2 = len(ex2)
                    if n2 == 0 or n2 > 64:
                        continue
                    weight = n1 * n2
                    repeat = (6 // weight) if weight >= 3 else 1
                    for b2 in sorted(ex2):
                        for _ in range(repeat):
                            conn.append((hap_id2, b2))

        # -- application: batched device path or per-read host path ----------
        proper_pair = bool(geno.flags & 0x2)
        if self.batcher is not None:
            read_length = geno.read_length
            clipped_scaled = (clipped_bp * 1000) // read_length if clipped_bp else 0
            mapq_sq = 0 if geno.mapq == 255 else geno.mapq * geno.mapq
            mm_scaled = (mismatches * 1000) // read_length if mismatches else 0
            forward = (geno.flags & IS_REVERSED) == 0
            first = (geno.flags & IS_FIRST_IN_PAIR) != 0
            strand = (0 if forward else 2) + (0 if first else 1)
        for hap_id in sorted_ids:
            hap = self.sites[hap_id]
            cov = site_cov[hap_id]
            if self.batcher is not None and self._tier_for(hap.gt.num) is not None:
                eps = HaplotypeSite.epsilon_exponent(
                    non_unique_paths,
                    geno.flags,
                    fully_aligned,
                    recent_ids[hap_id],
                    has_low_quality_snp,
                    mismatches,
                )
                if cov == MULTI_ALT_COVERAGE:
                    cov_code = COV_MULTI_ALT
                elif cov == MULTI_REF_COVERAGE:
                    cov_code = COV_MULTI_REF
                else:
                    cov_code = cov
                self.batcher.add(
                    hap_id,
                    hap.gt.num,
                    pn_index,
                    eps,
                    site_explains[hap_id],
                    cov_code,
                    clipped_scaled,
                    1 if clipped_bp else 0,
                    mapq_sq,
                    mm_scaled,
                    geno.score_diff,
                    strand,
                    1 if proper_pair else 0,
                )
                continue
            # host path (fallback / parity oracle / >64-allele sites)
            hap.explains = site_explains[hap_id]
            hap.coverage = cov
            hap.clipped_reads_to_stats(clipped_bp, geno.read_length)
            hap.mapq_to_stats(geno.mapq)
            hap.strand_to_stats(geno.flags)
            hap.mismatches_to_stats(mismatches, geno.read_length)
            hap.score_diff_to_stats(geno.score_diff)
            hap.explain_to_score(
                pn_index,
                non_unique_paths,
                geno.flags,
                fully_aligned,
                recent_ids[hap_id],
                has_low_quality_snp,
                mismatches,
            )
            hap.coverage_to_gts(pn_index, proper_pair)
            hap.coverage = NO_COVERAGE
            hap.explains = set()

        return new_connections
