"""Long-read pileup genotyping.

Reference semantics: src/typer/caller.cpp — run_first_pass_lr (:1367-1505,
qual-weighted base pileup with quals rescaled to 15-27, reads <150bp or
MAPQ<lr_mapq_filter skipped), streamlined_lr_genotyping (:3096-3448: merge
per-sample pileups, SNP candidates from qualsum gaps, PL directly from the
pileup: hom(y) = total_qs - qs[y]; het(x,y) = total_qs - qs[x] - qs[y] +
3*(cnt_x + cnt_y), normalized to min 0).

The pileup accumulation is dense numpy (positions x 4 bases) — the natural
batched/TPU-amenable layout — rather than per-bucket objects.
"""

from __future__ import annotations

import numpy as np

from graphtyper_tpu_torch.config import Options
from graphtyper_tpu_torch.graph.coords import AbsolutePosition, GenomicRegion
from graphtyper_tpu_torch.io.bam import read_alignments_cached
from graphtyper_tpu_torch.io.fasta import FastaFile
from graphtyper_tpu_torch.models.genotype_model import to_index
from graphtyper_tpu_torch.typer.sample_call import SampleCall
from graphtyper_tpu_torch.typer.variant import Variant
from graphtyper_tpu_torch.typer.vcf_out import VcfOutput
from graphtyper_tpu_torch.utils.dna import encode

BUCKET_SIZE = 50


# translated qual per raw phred (the scalar formula, precomputed so the
# vectorized path reproduces Python round() bit-for-bit)
_TR_QUAL = np.array([15 + round(min(q, 60) * 12.0 / 60.0) for q in range(256)], dtype=np.int64)


def lr_pileup(reads, region_begin: int, ref_size: int, opts: Options) -> tuple[np.ndarray, np.ndarray]:
    """Per-position base counts [L, 4] and qualsums [L, 4] — vectorized per
    read (a long read contributes each reference position at most once, so
    segment ranges concatenate into unique-row fancy-index adds; the
    coverage-filter trigger is the LAST added position whose post-add depth
    reaches the cap, exactly the scalar loop's final overwrite).
    lr_pileup_scalar below is the oracle (tests/typer/test_lr_pileup.py).

    Extreme-coverage protection (caller.cpp:1381,1512-1516 + bucket.cpp
    add_base_to_bucket): once any position's depth reaches
    lr_coverage_filter, later reads starting before that position are
    skipped entirely (reads arrive coordinate-sorted)."""
    counts = np.zeros((ref_size, 4), dtype=np.int64)
    qualsums = np.zeros((ref_size, 4), dtype=np.int64)
    rowsum = np.zeros(ref_size, dtype=np.int64)
    cov_filter = opts.lr_coverage_filter
    min_pos = -1  # genomic 0-based threshold
    for r in reads:
        if not r.cigar or len(r.seq) < 150 or r.mapq < opts.lr_mapq_filter or (r.flag & opts.sam_flag_filter):
            continue
        if r.pos < min_pos:
            continue
        codes = encode(r.seq)
        quals = np.asarray(r.qual, dtype=np.int64)
        n_codes = len(codes)
        rp_parts: list[np.ndarray] = []
        qp_parts: list[np.ndarray] = []
        ref_offset = r.pos - region_begin
        read_offset = 0
        for op, cnt in r.cigar:
            if op in (0, 7, 8):
                # scalar semantics: rp < 0 skips the base; rp >= ref_size or
                # qp >= len(codes) breaks the segment (ranges, since rp/qp
                # ascend within a segment)
                n = min(cnt, n_codes - read_offset)
                if n > 0:
                    k0 = max(0, -ref_offset)
                    k1 = min(n, ref_size - ref_offset)
                    if k1 > k0:
                        rp_parts.append(np.arange(ref_offset + k0, ref_offset + k1))
                        qp_parts.append(np.arange(read_offset + k0, read_offset + k1))
                read_offset += cnt
                ref_offset += cnt
            elif op == 1:
                read_offset += cnt
            elif op in (2, 3):
                ref_offset += cnt
            elif op == 4:
                read_offset += cnt
        if not rp_parts:
            continue
        rp = np.concatenate(rp_parts) if len(rp_parts) > 1 else rp_parts[0]
        qp = np.concatenate(qp_parts) if len(qp_parts) > 1 else qp_parts[0]
        c = codes[qp].astype(np.int64)
        q = quals[qp]
        m = (c < 4) & (q > 0)
        if not m.all():
            rp = rp[m]
            c = c[m]
            q = q[m]
        if len(rp) == 0:
            continue
        # rp values are unique within one read (each op advances), so plain
        # fancy-index adds are exact
        counts[rp, c] += 1
        qualsums[rp, c] += _TR_QUAL[q]
        rowsum[rp] += 1
        if cov_filter > 0:
            trig = np.nonzero(rowsum[rp] >= cov_filter)[0]
            if len(trig):
                min_pos = int(rp[trig[-1]]) + region_begin
    return counts, qualsums


def lr_pileup_scalar(reads, region_begin: int, ref_size: int, opts: Options) -> tuple[np.ndarray, np.ndarray]:
    """The reference-shaped per-base loop — kept as the parity oracle."""
    counts = np.zeros((ref_size, 4), dtype=np.int64)
    qualsums = np.zeros((ref_size, 4), dtype=np.int64)
    cov_filter = opts.lr_coverage_filter
    min_pos = -1  # genomic 0-based threshold
    for r in reads:
        if not r.cigar or len(r.seq) < 150 or r.mapq < opts.lr_mapq_filter or (r.flag & opts.sam_flag_filter):
            continue
        if r.pos < min_pos:
            continue
        codes = encode(r.seq)
        ref_offset = r.pos - region_begin
        read_offset = 0
        for op, cnt in r.cigar:
            if op in (0, 7, 8):
                for k in range(cnt):
                    rp = ref_offset + k
                    if rp < 0:
                        continue
                    if rp >= ref_size:
                        break
                    qp = read_offset + k
                    if qp >= len(codes):
                        break
                    c = codes[qp]
                    q = int(r.qual[qp])
                    if q == 0 or c >= 4:
                        continue
                    q = min(q, 60)
                    tr_qual = 15 + round(q * 12.0 / 60.0)
                    counts[rp, c] += 1
                    qualsums[rp, c] += tr_qual
                    if cov_filter > 0 and int(counts[rp].sum()) >= cov_filter:
                        min_pos = rp + region_begin
                read_offset += cnt
                ref_offset += cnt
            elif op == 1:
                read_offset += cnt
            elif op in (2, 3):
                ref_offset += cnt
            elif op == 4:
                read_offset += cnt
    return counts, qualsums


def lr_snp_candidates(
    total_counts: np.ndarray, total_qs: np.ndarray, ref_codes: np.ndarray
) -> set[tuple[int, int]]:
    """SNP candidates from merged qualsum gaps (caller.cpp:3246-3290),
    vectorized over positions (per-position stable argsort of the 4 bases).
    Gates: top base (first) needs bc>=3 and a qualsum gap >=30 over second
    OR >=50 over third; the runner-up (second) needs bc>=4, gap >=50 over
    third, and a STRICT >0.3 share of the total qualsum. Returns
    {(region-local pos, base code)}."""
    ref_size = total_qs.shape[0]
    order = np.argsort(total_qs, axis=1, kind="stable")  # [L, 4] ascending
    first = order[:, 3]
    second = order[:, 2]
    third = order[:, 1]
    rows = np.arange(ref_size)
    qs_f = total_qs[rows, first]
    qs_s = total_qs[rows, second]
    qs_t = total_qs[rows, third]
    bc_f = total_counts[rows, first]
    bc_s = total_counts[rows, second]
    qsum = total_qs.sum(axis=1)
    ref_ok = ref_codes[:ref_size] < 4
    ref_idx_arr = np.where(ref_ok, ref_codes[:ref_size], 255).astype(np.int64)
    cond1 = ref_ok & (first != ref_idx_arr) & (bc_f >= 3) & (
        ((qs_f - qs_s) >= 30) | ((qs_f - qs_t) >= 50)
    )
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(qsum > 0, qs_s / np.maximum(qsum, 1), 0.0)
    cond2 = ref_ok & (second != ref_idx_arr) & (bc_s >= 4) & ((qs_s - qs_t) >= 50) & (
        qsum > 0
    ) & (ratio > 0.3)
    snp_events: set[tuple[int, int]] = set()
    for p in np.nonzero(cond1)[0]:
        snp_events.add((int(p), int(first[p])))
    for p in np.nonzero(cond2)[0]:
        snp_events.add((int(p), int(second[p])))
    return snp_events


def lr_pl_from_pileup(bc: np.ndarray, qs: np.ndarray, seq_b2i: list[int]) -> np.ndarray:
    """PL triangle straight from one position's pileup (caller.cpp:3389-3423):
    hom(y) = total_qs - qs[y]; het(x,y) = total_qs - qs[x] - qs[y]
    + 3*(bc[x] + bc[y]); normalized so the best entry is 0, clamped 255."""
    cnum = len(seq_b2i)
    total_qualsum = int(qs.sum())
    new_phred = np.zeros(cnum * (cnum + 1) // 2, dtype=np.int64)
    i = 0
    for y in range(cnum):
        for x in range(y + 1):
            if x == y:
                new_phred[i] = total_qualsum - int(qs[seq_b2i[y]])
            else:
                xi, yi = seq_b2i[x], seq_b2i[y]
                new_phred[i] = (
                    total_qualsum - int(qs[xi]) - int(qs[yi]) + 3 * (int(bc[xi]) + int(bc[yi]))
                )
            i += 1
    new_phred -= new_phred.min()
    return np.minimum(new_phred, 255)


def streamlined_lr_genotyping(
    hts_paths: list[str], ref_path: str, region_str: str, opts: Options | None = None
) -> VcfOutput:
    """caller.cpp:3096-3448."""
    opts = opts or Options()
    region = GenomicRegion.parse(region_str)
    fasta = FastaFile(ref_path)
    if fasta.has_contig(region.chr):
        region.end = min(region.end, fasta.contig_length(region.chr))
    reference = fasta.fetch(region.chr, region.begin, region.end)
    ref_codes = encode(reference)
    ref_size = len(reference)
    abs_pos = AbsolutePosition(fasta.contigs)
    chromosome_offset = abs_pos.get_absolute_position(region.chr, 1)
    contigs = list(fasta.contigs)
    fasta.close()

    # per-sample pileups (merging same-named samples)
    sample_names: list[str] = []
    counts_by_sample: list[np.ndarray] = []
    qs_by_sample: list[np.ndarray] = []
    name_to_idx: dict[str, int] = {}
    for path in hts_paths:
        header, reads = read_alignments_cached(path)
        reads = [r for r in reads if r.ref_id >= 0 and header.ref_names[r.ref_id] == region.chr]
        name = header.sample_names[0] if header.sample_names else path.rsplit("/", 1)[-1].split(".")[0]
        counts, qs = lr_pileup(reads, region.begin, ref_size, opts)
        if name in name_to_idx:
            i = name_to_idx[name]
            counts_by_sample[i] += counts
            qs_by_sample[i] += qs
        else:
            name_to_idx[name] = len(sample_names)
            sample_names.append(name)
            counts_by_sample.append(counts)
            qs_by_sample.append(qs)

    total_counts = counts_by_sample[0].copy()
    for a in counts_by_sample[1:]:
        total_counts += a
    total_qs = qs_by_sample[0].copy()
    for a in qs_by_sample[1:]:
        total_qs += a
    # (region-local pos, base code)
    snp_events = lr_snp_candidates(total_counts, total_qs, ref_codes)

    vcf = VcfOutput(sample_names=sample_names)
    by_pos: dict[int, list[int]] = {}
    for p, base in sorted(snp_events):
        by_pos.setdefault(p, []).append(base)

    BASES = b"ACGT"
    for p in sorted(by_pos):
        bases = by_pos[p]
        ref_idx = int(ref_codes[p])
        variant = Variant()
        variant.abs_pos = p + region.begin + chromosome_offset
        variant.seqs = [BASES[ref_idx : ref_idx + 1]] + [BASES[b : b + 1] for b in bases]
        variant.type = "X"
        cnum = len(variant.seqs)
        seq_b2i = [ref_idx] + bases
        for s in range(len(sample_names)):
            bc = counts_by_sample[s][p]
            qs = qs_by_sample[s][p]
            call = SampleCall(
                phred=np.zeros(cnum * (cnum + 1) // 2, dtype=np.int64),
                coverage=np.zeros(cnum, dtype=np.int64),
            )
            for y in range(4):
                if y in seq_b2i:
                    call.coverage[seq_b2i.index(y)] += int(bc[y])
                else:
                    call.ambiguous_depth += int(bc[y])
            call.phred = lr_pl_from_pileup(bc, qs, seq_b2i)
            variant.calls.append(call)
        variant.generate_infos(is_sv_graph=False)
        variant.infos.pop("MQ", None)
        vcf.variants.append(variant)

    vcf._contigs = contigs
    vcf._abs_pos = abs_pos
    return vcf
