"""Segment calling: genotype whole known haplotype panels (HLA genes) by
aligning each panel allele's sequences through the graph and scoring every
diploid allele pair from the per-site read evidence.

Reference semantics: src/typer/segment_calling.cpp (:417-844; WIP in the
reference — it references VcfWriter helpers removed from the snapshot, so
the explain-map scoring here implements the inferable contract):

- each segment FASTA holds one gene's alleles; each allele is a list of
  alternating intron/exon sequences (sequence i is a scored "long exon" iff
  i % 2 == 1 and i < 10, :460-463)
- find_haplotype_paths (alignment.cpp:626-660): align sequences >= 50bp
  through the graph; a sequence that does not fully align contributes
  nothing
- explain maps: variant site -> per-panel-allele bitmask of graph alleles
  the panel allele explains (insert_into_explain_map :100-122)
- filters: drop sites explained by < 20% of panel alleles
  (remove_insignificant_variants :154-184); alleles that have not
  started/ended at a site explain everything there
  (add_start/add_end_on_explain_map :124-152,:288-316)
- the panel allele explaining the reference allele at the most sites is
  put in front (determine_reference_index / put_reference_in_front
  :319-414)
- per sample: exon maps score every diploid pair; ties refine with intron
  scores; PL = (max - score) * 10*log10(2) like segment.cpp:16-49
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from graphtyper_tpu_torch.constants import LOG10_HALF_TIMES_10
from graphtyper_tpu_torch.models.genotype_model import to_index
from graphtyper_tpu_torch.typer.sample_call import SampleCall
from graphtyper_tpu_torch.typer.variant import Variant


def read_haplotypes_from_fasta(path: str) -> dict[str, list[bytes]]:
    """Allele ID -> ordered sequence list. Sequences of one allele share the
    ID prefix before the last '.' ('A*01:01.0', 'A*01:01.1', ...) or repeat
    the same ID."""
    out: dict[str, list[bytes]] = {}
    name = None
    seq: list[bytes] = []
    with open(path, "rb") as f:
        for line in f:
            line = line.strip()
            if line.startswith(b">"):
                if name is not None:
                    out.setdefault(name, []).append(b"".join(seq))
                raw = line[1:].split()[0].decode()
                name = raw.rsplit(".", 1)[0] if "." in raw and raw.rsplit(".", 1)[1].isdigit() else raw
                seq = []
            else:
                seq.append(line.upper())
    if name is not None:
        out.setdefault(name, []).append(b"".join(seq))
    return out


def find_haplotype_paths(graph, index, sequences: list[bytes]):
    """alignment.cpp:626-660: align whole allele sequences as reads (no
    reverse complement); everything must align or the result is void."""
    from graphtyper_tpu_torch.typer.alignment import find_genotype_paths
    from graphtyper_tpu_torch.typer.genotype_paths import GenotypePaths
    from graphtyper_tpu_torch.utils.dna import encode

    out = []
    for seq in sequences:
        geno = GenotypePaths(0, len(seq))
        if len(seq) >= 50:
            find_genotype_paths(graph, index, encode(seq), geno)
            if geno.longest_path_length != len(seq):
                geno.paths = []
                geno.longest_path_length = 0
        out.append(geno)
    return out


@dataclass
class _ExplainMaps:
    # site index -> [per panel allele] bitmask over graph alleles
    exon: dict[int, list[int]] = field(default_factory=dict)
    intron: dict[int, list[int]] = field(default_factory=dict)


def _insert(emap: dict[int, list[int]], site: int, allele_i: int, bits: int, n_alleles: int) -> None:
    vec = emap.get(site)
    if vec is None:
        vec = emap[site] = [0] * n_alleles
    vec[allele_i] |= bits


def _remove_insignificant(emap: dict[int, list[int]]) -> None:
    FILTER = 0.2
    for site in list(emap.keys()):
        vec = emap[site]
        coverage = sum(1 for b in vec if b)
        if coverage / len(vec) < FILTER:
            del emap[site]


def _add_start_end(emap: dict[int, list[int]], n_graph_alleles: dict[int, int]) -> None:
    """Alleles that have not started (or already ended) at a site explain all
    graph alleles there."""
    if not emap:
        return
    sites = sorted(emap.keys())
    n = len(emap[sites[0]])
    for order in (sites, sites[::-1]):
        active = [False] * n
        for site in order:
            vec = emap[site]
            full = (1 << n_graph_alleles[site]) - 1
            for i in range(n):
                if active[i]:
                    continue
                if vec[i]:
                    active[i] = True
                else:
                    vec[i] = full


def _reference_first(emaps: _ExplainMaps, hap_ids: list[str]) -> list[str]:
    """Put the panel allele that explains the reference allele (bit 0) at the
    most sites in front (determine_reference_index / put_reference_in_front)."""
    n = len(hap_ids)
    counts = [0] * n
    for emap in (emaps.exon, emaps.intron):
        for vec in emap.values():
            for i in range(n):
                if vec[i] & 1:
                    counts[i] += 1
    ref_index = int(np.argmax(counts)) if n else 0
    if ref_index != 0:
        for emap in (emaps.exon, emaps.intron):
            for vec in emap.values():
                vec[0], vec[ref_index] = vec[ref_index], vec[0]
        hap_ids = list(hap_ids)
        hap_ids[0], hap_ids[ref_index] = hap_ids[ref_index], hap_ids[0]
    return hap_ids


def _pair_scores(scorer, sample: int, emap: dict[int, list[int]], n: int) -> np.ndarray:
    """Score every diploid pair of panel alleles from the per-site diploid
    log scores: a pair's site score is the best log_score over graph-allele
    pairs compatible with the two panel alleles' explain masks."""
    pl_len = n * (n + 1) // 2
    scores = np.zeros(pl_len, dtype=np.int64)
    for site, vec in emap.items():
        hs = scorer.sites[site].hap_samples[sample]
        cnum = scorer.sites[site].gt.num
        log = hs.log_score
        max_log = int(log.max()) if len(log) else 0
        # per panel allele: list of compatible graph alleles
        compat = [[a for a in range(cnum) if vec[i] >> a & 1] for i in range(n)]
        # per pair of panel alleles, best diploid entry
        for y in range(n):
            for x in range(y + 1):
                best = None
                for a in compat[x]:
                    for b in compat[y]:
                        v = int(log[to_index(min(a, b), max(a, b))])
                        if best is None or v > best:
                            best = v
                if best is None:
                    best = 0
                # higher = better; per-site deficit capped at MAX_SCORE_DIFF
                # like the pairwise HLA scoring (typer/hla.py)
                scores[to_index(x, y)] += 60 - min(60, max_log - best)
    return scores


def segment_calling(
    graph,
    index,
    scorer,
    segment_fasta_files: list[str],
    out_path: str,
    samples: list[str],
) -> None:
    """One <S> record per gene (segment FASTA): alleles = panel allele names,
    per-sample PL over all diploid allele pairs."""
    from graphtyper_tpu_torch.typer.vcf_out import VcfOutput

    for site in scorer.sites:
        for hs in site.hap_samples:
            hs.max_log_score = int(hs.log_score.max()) if len(hs.log_score) else 0

    n_graph_alleles = {i: s.gt.num for i, s in enumerate(scorer.sites)}
    out = VcfOutput(sample_names=list(samples))

    for fasta in segment_fasta_files:
        alleles = read_haplotypes_from_fasta(fasta)
        hap_ids = sorted(alleles.keys())
        n = len(hap_ids)
        if n == 0:
            continue
        emaps = _ExplainMaps()
        seg_start = None
        seg_end = None
        for i, hap_id in enumerate(hap_ids):
            paths_per_seq = find_haplotype_paths(graph, index, alleles[hap_id])
            for j, geno in enumerate(paths_per_seq):
                is_long_exon = (j % 2 == 1) and j < 10
                for path in geno.paths:
                    lo = path.start_ref_reach_pos(graph)
                    hi = path.end_ref_reach_pos(graph)
                    seg_start = lo if seg_start is None else min(seg_start, lo)
                    seg_end = hi if seg_end is None else max(seg_end, hi)
                    for vo, nums in zip(path.var_order, path.nums):
                        site = scorer.id2hap.get(vo)
                        if site is None or not nums:
                            continue
                        bits = 0
                        for a in nums:
                            bits |= 1 << a
                        _insert(
                            emaps.exon if is_long_exon else emaps.intron,
                            site, i, bits, n,
                        )
        _remove_insignificant(emaps.exon)
        _remove_insignificant(emaps.intron)
        _add_start_end(emaps.intron, n_graph_alleles)
        hap_ids = _reference_first(emaps, hap_ids)

        var = Variant()
        mid_site = scorer.sites[len(scorer.sites) // 2] if scorer.sites else None
        pos = seg_start if seg_start is not None else (mid_site.gt.id if mid_site else 1)
        var.abs_pos = graph.abs_pos.get_absolute_position(graph.genomic_region.chr, pos)
        var.seqs = [b"<S>"] * n
        var.infos["SEGMENT_ALLELES"] = ",".join(hap_ids)
        if seg_start is not None:
            var.infos["END"] = str(seg_end)

        primary = emaps.exon if emaps.exon else emaps.intron
        secondary = emaps.intron if emaps.exon else {}
        for s in range(len(samples)):
            scores = _pair_scores(scorer, s, primary, n)
            max_score = int(scores.max())
            best = np.flatnonzero(scores >= max_score)
            if len(best) > 1 and secondary:
                # refine ties with the secondary (intron) map
                sec = _pair_scores(scorer, s, secondary, n)
                scores = scores * 1000 + sec
                max_score = int(scores.max())
            phred = np.rint((scores.max() - scores) * LOG10_HALF_TIMES_10).astype(np.int64)
            phred = np.minimum(phred, 255)
            if (scores == scores.max()).all():
                phred[:] = 0
            var.calls.append(SampleCall(phred=phred, coverage=np.zeros(n, dtype=np.int64)))
        out.variants.append(var)

    # segment records carry a "." FILTER (vcf.cpp:860 is_segment_calling)
    from dataclasses import replace

    from graphtyper_tpu_torch.config import current_options, set_options

    prev = current_options()
    set_options(replace(prev, is_segment_calling=True))
    try:
        out.write(
            out_path,
            graph.contigs,
            graph.abs_pos,
            filter_zero_qual=False,
            output_all_variants=True,
            write_tbi=True,
        )
    finally:
        set_options(prev)
