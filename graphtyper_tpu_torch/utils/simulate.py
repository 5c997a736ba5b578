"""Synthetic cohort simulator for benchmarks and end-to-end tests.

Generates a random reference contig, a VCF of known variants (SNPs +
indels), diploid sample genotypes, and paired short reads sampled from the
sample haplotypes — the same shape of input the reference pipeline consumes
(FASTA + tabixed VCF + per-sample BAM/SAM, see SURVEY.md §3.1). Used by
bench.py to measure the north-star metric (reads aligned+genotyped/s) on a
workload with realistic read length, coverage, and variant density.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@dataclass
class SimConfig:
    region_length: int = 50_000
    chrom: str = "chrS"
    n_samples: int = 1
    coverage: float = 30.0
    read_length: int = 151
    insert_mean: int = 350
    insert_sd: int = 50
    snp_rate: float = 1.0 / 300.0
    indel_rate: float = 1.0 / 3000.0
    max_indel_len: int = 8
    error_rate: float = 0.001
    seed: int = 0
    out_format: str = "sam"  # "sam" | "bam" (bam exercises the native decoder)


@dataclass
class SimResult:
    fasta: str
    vcf: str
    sams: list[str]
    n_reads: int = 0
    truth: dict = field(default_factory=dict)  # (pos0, ref, alt) -> [gt per sample]


def _random_seq(rng: np.random.Generator, n: int) -> np.ndarray:
    return BASES[rng.integers(0, 4, size=n)]


def _write_fasta(path: str, chrom: str, seq: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write(f">{chrom}\n")
        raw = seq.tobytes().decode()
        for i in range(0, len(raw), 70):
            f.write(raw[i : i + 70] + "\n")
    with open(path + ".fai", "w") as f:
        # offset of first base = len(">chrom\n")
        f.write(f"{chrom}\t{len(seq)}\t{len(chrom) + 2}\t70\t71\n")


def _make_variants(rng: np.random.Generator, seq: np.ndarray, cfg: SimConfig) -> list[tuple]:
    """Returns [(pos0, ref_bytes, alt_bytes)] sorted, non-overlapping, with
    >=2bp spacing like typical population VCF sites."""
    variants = []
    pos = 100
    end_limit = len(seq) - 100
    while pos < end_limit:
        gap = int(rng.geometric(cfg.snp_rate))
        pos += max(2, gap)
        if pos >= end_limit:
            break
        if rng.random() < cfg.indel_rate / cfg.snp_rate:
            ilen = int(rng.integers(1, cfg.max_indel_len + 1))
            if rng.random() < 0.5 and pos + 1 + ilen < end_limit:
                ref = seq[pos : pos + 1 + ilen].tobytes()  # deletion
                alt = seq[pos : pos + 1].tobytes()
            else:
                ref = seq[pos : pos + 1].tobytes()  # insertion
                alt = ref + _random_seq(rng, ilen).tobytes()
            variants.append((pos, ref, alt))
            pos += len(ref) + 1
        else:
            refb = seq[pos : pos + 1].tobytes()
            alt = BASES[(int(np.searchsorted(BASES, refb[0])) + int(rng.integers(1, 4))) % 4]
            variants.append((pos, refb, bytes([alt])))
    return variants


def _write_vcf(path: str, chrom: str, variants: list[tuple]) -> None:
    """Plain-text sites VCF (VcfReader scans plain files without an index)."""
    lines = [
        "##fileformat=VCFv4.2",
        f"##contig=<ID={chrom}>",
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO",
    ]
    for pos, ref, alt in variants:
        lines.append(f"{chrom}\t{pos + 1}\t.\t{ref.decode()}\t{alt.decode()}\t.\t.\t.")
    text = "\n".join(lines) + "\n"
    with open(path, "w") as f:
        f.write(text)


def _apply_haplotype(seq: np.ndarray, variants: list[tuple], alleles: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Apply chosen alleles; returns (hap_seq, ref_pos_of_each_hap_base)."""
    chunks = []
    positions = []
    cur = 0
    for (pos, ref, alt), a in zip(variants, alleles):
        if pos < cur:
            continue
        chunks.append(seq[cur:pos])
        positions.append(np.arange(cur, pos))
        chosen = ref if a == 0 else alt
        chunks.append(np.frombuffer(chosen, dtype=np.uint8))
        # indel bases map onto the site start (approximate mapping pos)
        positions.append(np.full(len(chosen), pos))
        cur = pos + len(ref)
    chunks.append(seq[cur:])
    positions.append(np.arange(cur, len(seq)))
    return np.concatenate(chunks), np.concatenate(positions)


def _revcomp_bytes(s: bytes) -> bytes:
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    return s.translate(comp)[::-1]


def simulate_cohort(out_dir: str, cfg: SimConfig) -> SimResult:
    rng = np.random.default_rng(cfg.seed)
    os.makedirs(out_dir, exist_ok=True)
    seq = _random_seq(rng, cfg.region_length)
    fasta = os.path.join(out_dir, "ref.fa")
    _write_fasta(fasta, cfg.chrom, seq)
    variants = _make_variants(rng, seq, cfg)
    vcf = os.path.join(out_dir, "sites.vcf")
    _write_vcf(vcf, cfg.chrom, variants)

    result = SimResult(fasta=fasta, vcf=vcf, sams=[])
    for pos, ref, alt in variants:
        result.truth[(pos, ref, alt)] = []

    n_pairs_per_sample = int(cfg.coverage * cfg.region_length / (2 * cfg.read_length))
    for s in range(cfg.n_samples):
        gts = rng.integers(0, 2, size=(len(variants), 2))
        for (pos, ref, alt), gt in zip(variants, gts):
            result.truth[(pos, ref, alt)].append((int(gt.min()), int(gt.max())))
        haps = []
        for h in range(2):
            hap_seq, hap_pos = _apply_haplotype(seq, variants, gts[:, h])
            haps.append((hap_seq, hap_pos))
        sam_path = os.path.join(out_dir, f"sample{s}.sam")
        _write_sample_sam(sam_path, cfg, rng, haps, f"sample{s}", n_pairs_per_sample)
        if cfg.out_format == "bam":
            from graphtyper_tpu_torch.io.bam import read_alignments
            from graphtyper_tpu_torch.io.bam_writer import write_bam

            header, reads = read_alignments(sam_path, parse_tags=True)
            bam_path = sam_path[:-4] + ".bam"
            write_bam(bam_path, header, reads)
            os.remove(sam_path)
            result.sams.append(bam_path)
        else:
            result.sams.append(sam_path)
        result.n_reads += 2 * n_pairs_per_sample
    return result


def _cigar_from_positions(pos: np.ndarray) -> str:
    """Aligner-style CIGAR from the per-base reference positions of a read
    (insertions repeat the anchor position; deletions jump it). Without this,
    reads spanning a simulated indel would carry an all-M CIGAR whose
    frame-shifted tail looks like a wall of mismatches — real aligners emit
    I/D operations there, which is what reference-based discovery consumes."""
    ops: list[tuple[int, str]] = [(1, "M")]
    for k in range(1, len(pos)):
        d = int(pos[k]) - int(pos[k - 1])
        if d == 0:
            op = "I"
        elif d == 1:
            op = "M"
        else:
            ops.append((d - 1, "D"))
            op = "M"
        if ops[-1][1] == op:
            ops[-1] = (ops[-1][0] + 1, op)
        else:
            ops.append((1, op))
    return "".join(f"{n}{o}" for n, o in ops)


def _write_sample_sam(
    path: str, cfg: SimConfig, rng: np.random.Generator, haps, sample: str, n_pairs: int
) -> None:
    L = cfg.read_length
    records = []
    for i in range(n_pairs):
        hap_seq, hap_pos = haps[i % 2]
        frag = int(rng.normal(cfg.insert_mean, cfg.insert_sd))
        frag = max(L + 10, min(frag, len(hap_seq) - 1))
        start = int(rng.integers(0, len(hap_seq) - frag))
        r1 = hap_seq[start : start + L].copy()
        r2 = hap_seq[start + frag - L : start + frag].copy()
        for r in (r1, r2):
            n_err = rng.binomial(L, cfg.error_rate)
            if n_err:
                at = rng.integers(0, L, size=n_err)
                r[at] = BASES[(np.searchsorted(BASES, r[at]) + rng.integers(1, 4, size=n_err)) % 4]
        p1 = int(hap_pos[start])
        p2 = int(hap_pos[start + frag - L])
        c1 = _cigar_from_positions(hap_pos[start : start + L])
        c2 = _cigar_from_positions(hap_pos[start + frag - L : start + frag])
        tlen = p2 + L - p1
        qual = "I" * L
        name = f"{sample}_r{i}"
        records.append(
            (p1, f"{name}\t99\t{cfg.chrom}\t{p1 + 1}\t60\t{c1}\t=\t{p2 + 1}\t{tlen}\t{r1.tobytes().decode()}\t{qual}\tRG:Z:rg_{sample}")
        )
        records.append(
            (p2, f"{name}\t147\t{cfg.chrom}\t{p2 + 1}\t60\t{c2}\t=\t{p1 + 1}\t{-tlen}\t{r2.tobytes().decode()}\t{qual}\tRG:Z:rg_{sample}")
        )
    records.sort(key=lambda t: t[0])
    with open(path, "w") as f:
        f.write("@HD\tVN:1.6\tSO:coordinate\n")
        f.write(f"@SQ\tSN:{cfg.chrom}\tLN:{cfg.region_length}\n")
        f.write(f"@RG\tID:rg_{sample}\tSM:{sample}\n")
        for _, line in records:
            f.write(line + "\n")
