"""HLA / segment calling: allele-level genotyping of known haplotype panels.

Reference semantics: src/utilities/genotype_hla.cpp (:60-290) — the HLA VCF's
sample columns are HLA alleles; exon variants (FEATURE=exon) define each
allele's per-site genotype map; src/typer/vcf.cpp add_hla_haplotypes
(:1330-1505) scores every diploid pair of HLA alleles from the per-site
diploid log scores (score diffs capped at 60) with a phasing-connection
correction for ambiguous het pairs, and emits one allele-level <H> variant.
find_haplotype_paths (alignment.cpp:626-660) aligns whole allele sequences
through the graph for segment calling.
"""

from __future__ import annotations

import numpy as np

from graphtyper_tpu_torch.models.genotype_model import to_index
from graphtyper_tpu_torch.typer.sample_call import SampleCall
from graphtyper_tpu_torch.typer.variant import Variant

MAX_SCORE_DIFF = 60


def build_event2hap_gt(graph) -> dict[int, tuple[int, int]]:
    """GT_ID event -> (site index, allele num) (genotype_hla.cpp:104-128)."""
    out: dict[int, tuple[int, int]] = {}
    v = 0
    h = 0
    for r in range(len(graph.ref_nodes) - 1):
        ref_node = graph.ref_nodes[r]
        for v_e in range(ref_node.out_degree):
            var_node = graph.var_nodes[v + v_e]
            for event in var_node.events:
                if event > 0:
                    out[event] = (h, v_e)
        h += 1
        v += ref_node.out_degree
    return out


def build_allele_hap_gts(graph, hla_vcf) -> tuple[list[str], list[dict[int, int]]]:
    """Per HLA allele: site -> allele-num map from the exon variants
    (genotype_hla.cpp:130-180). `hla_vcf` is a VcfOutput whose sample columns
    are the HLA alleles."""
    event2hap_gt = build_event2hap_gt(graph)
    exon_haps: set[int] = set()
    for var in hla_vcf.variants:
        if var.infos.get("FEATURE") != "exon" or "GT_ID" not in var.infos:
            continue
        gt_id = int(var.infos["GT_ID"])
        if gt_id in event2hap_gt:
            exon_haps.add(event2hap_gt[gt_id][0])

    allele_hap_gts: list[dict[int, int]] = []
    for s in range(len(hla_vcf.sample_names)):
        m: dict[int, int] = {}
        for var in hla_vcf.variants:
            if var.infos.get("FEATURE") != "exon" or "GT_ID" not in var.infos:
                continue
            gt_id = int(var.infos["GT_ID"])
            if gt_id not in event2hap_gt:
                continue
            call = var.calls[s]
            if len(call.coverage) >= 1 and int(call.coverage[0]) == 0:
                h, v_e = event2hap_gt[gt_id]
                m.setdefault(h, v_e)
        for h in exon_haps:
            m.setdefault(h, 0)
        allele_hap_gts.append(m)
    return list(hla_vcf.sample_names), allele_hap_gts


def add_hla_haplotypes(vcf_out, scorer, all_hap_gts: list[dict[int, int]], graph) -> None:
    """vcf.cpp:1330-1505 — one <H> variant whose alleles are the HLA alleles."""
    sites = scorer.sites
    if not sites:
        return
    cnum = len(all_hap_gts)
    new_var = Variant()
    mid_site = sites[len(sites) // 2]
    new_var.abs_pos = graph.abs_pos.get_absolute_position(graph.genomic_region.chr, mid_site.gt.id)
    new_var.seqs = [b"<H>"] * cnum

    for site in sites:
        for samp in site.hap_samples:
            samp.max_log_score = int(samp.log_score.max()) if len(samp.log_score) else 0

    n_samples = len(sites[0].hap_samples)
    for s in range(n_samples):
        pl_len = cnum * (cnum + 1) // 2
        hla_scores = np.zeros(pl_len, dtype=np.int64)
        het_haplotypes: list[set[int]] = [set() for _ in range(pl_len)]

        for y in range(cnum):
            hap_gt_y = all_hap_gts[y]
            i_hom = to_index(y, y)
            for site_i, allele_y in hap_gt_y.items():
                samp = sites[site_i].hap_samples[s]
                idx = to_index(allele_y, allele_y)
                if idx >= len(samp.log_score):
                    continue
                score_diff = min(MAX_SCORE_DIFF, samp.max_log_score - int(samp.log_score[idx]))
                hla_scores[i_hom] += score_diff
            for x in range(y):
                hap_gt_x = all_hap_gts[x]
                i_het = to_index(x, y)
                for site_i, allele_y in hap_gt_y.items():
                    allele_x = hap_gt_x.get(site_i)
                    if allele_x is None:
                        continue
                    samp = sites[site_i].hap_samples[s]
                    a, b = min(allele_x, allele_y), max(allele_x, allele_y)
                    idx = to_index(a, b)
                    if idx >= len(samp.log_score):
                        continue
                    score_diff = samp.max_log_score - int(samp.log_score[idx])
                    if allele_x != allele_y and score_diff == 0 and samp.max_log_score > 0:
                        het_haplotypes[i_het].add(site_i)
                    elif score_diff > MAX_SCORE_DIFF:
                        score_diff = MAX_SCORE_DIFF
                    if not (allele_x != allele_y and score_diff == 0 and samp.max_log_score > 0):
                        hla_scores[i_het] += score_diff

        # phasing correction for ambiguous het pairs (vcf.cpp:1416-1482)
        i = 1
        for y in range(1, cnum):
            for x in range(y + 1):
                if x == y:
                    i += 1
                    continue
                idx = to_index(x, y)
                hh = het_haplotypes[idx]
                if len(hh) > 1:
                    hap_gt_x = all_hap_gts[x]
                    hap_gt_y = all_hap_gts[y]
                    hh_sorted = sorted(hh)
                    for a_i, site1 in enumerate(hh_sorted):
                        for site2 in hh_sorted[a_i + 1 :]:
                            conn_map = scorer.connections[site1][s]
                            for find_it, target_allele in (
                                (hap_gt_x.get(site1), hap_gt_x.get(site2)),
                                (hap_gt_y.get(site1), hap_gt_y.get(site2)),
                            ):
                                if find_it is None or target_allele is None:
                                    continue
                                conn = conn_map.get(find_it, {})
                                arr = conn.get(site2)
                                if arr is not None:
                                    total = int(arr.sum())
                                    supporting = int(arr[target_allele]) if target_allele < len(arr) else 0
                                    hla_scores[idx] += (total - 2 * supporting) // 6
                i += 1

        call = SampleCall(
            phred=np.minimum(3 * (hla_scores - hla_scores.min()), 255).astype(np.int64),
            coverage=np.zeros(cnum, dtype=np.int64),
        )
        new_var.calls.append(call)

    vcf_out.variants.append(new_var)


def find_haplotype_paths(graph, index, sequences: list[bytes]) -> list:
    """alignment.cpp:626-660 — align whole allotype sequences through the
    graph; sequences that do not fully align get empty results."""
    from graphtyper_tpu_torch.typer.alignment import find_genotype_paths
    from graphtyper_tpu_torch.typer.genotype_paths import GenotypePaths
    from graphtyper_tpu_torch.utils.dna import encode

    out = []
    for seq in sequences:
        if len(seq) < 50:
            out.append(GenotypePaths(0, 0))
            continue
        geno = GenotypePaths(0, len(seq))
        find_genotype_paths(graph, index, encode(seq), geno)
        if geno.longest_path_length != len(seq):
            geno.longest_path_length = 0
            geno.paths = []
        out.append(geno)
    return out
