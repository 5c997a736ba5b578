"""Independent read-simulator recipe for benchmark realism.

`utils/simulate.py` is the regression simulator the pipeline was tuned
against; this module is a deliberately *different* generative recipe so the
benchmark also runs on input the code was never fitted to (VERDICT r2 #8):

- reference: first-order Markov chain with GC bias and homopolymer
  stretches (not iid uniform), so k-mer seeding sees realistic repeat
  structure;
- variants: clustered by a hotspot intensity process, 4x the indel
  fraction, geometric indel lengths up to 20bp, occasional 2-3bp MNPs;
- reads: position-dependent error ramp (Q40 at the 5' end decaying toward
  Q22 at the 3' end) with per-base quality strings the scorer actually
  consumes (eps varies per base, unlike the regression simulator's flat
  'I' quals);
- short fragments read through into a fixed adapter and are emitted with
  aligner-style soft clips (nS CIGAR operations, clipped bases = adapter);
- output is CRAM (io/cram_writer), exercising the codec path end-to-end.

Everything is derived from `seed` — the workload is a committed recipe,
not committed binary data. The truth dict allows recall sanity checks.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
ADAPTER = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"  # Illumina TruSeq R1 adapter


@dataclass
class IndepConfig:
    region_length: int = 120_000
    chrom: str = "chrI"
    n_samples: int = 1
    coverage: float = 30.0
    read_length: int = 151
    insert_mean: int = 320
    insert_sd: int = 90  # wide: the short tail produces adapter read-through
    site_rate: float = 1.0 / 280.0
    indel_fraction: float = 0.04  # ~4x the regression simulator
    max_indel_len: int = 20
    mnp_fraction: float = 0.02
    seed: int = 0


@dataclass
class IndepResult:
    fasta: str
    vcf: str
    sams: list[str]
    n_reads: int = 0
    truth: dict = field(default_factory=dict)


def _markov_seq(rng: np.random.Generator, n: int) -> np.ndarray:
    """First-order Markov chain: GC-rich transitions with sticky
    homopolymers (P(stay)=0.35), vectorized via inverse-CDF sampling."""
    # transition rows indexed by previous base A,C,G,T
    P = np.array(
        [
            [0.35, 0.25, 0.25, 0.15],
            [0.15, 0.35, 0.30, 0.20],
            [0.20, 0.30, 0.35, 0.15],
            [0.15, 0.25, 0.25, 0.35],
        ]
    )
    cdf = np.cumsum(P, axis=1)
    u = rng.random(n)
    out = np.empty(n, dtype=np.int8)
    prev = int(rng.integers(0, 4))
    for i in range(n):
        prev = int(np.searchsorted(cdf[prev], u[i]))
        out[i] = prev
    return BASES[out]


def _hotspot_variants(rng: np.random.Generator, seq: np.ndarray, cfg: IndepConfig) -> list[tuple]:
    """Clustered sites: a two-state (cold/hot) renewal process modulates the
    local site rate 1x/6x."""
    variants = []
    pos = 120
    end_limit = len(seq) - 120
    hot = False
    switch_at = pos + int(rng.geometric(1.0 / 8000))
    while pos < end_limit:
        rate = cfg.site_rate * (6.0 if hot else 1.0)
        pos += max(2, int(rng.geometric(rate)))
        if pos >= switch_at:
            hot = not hot
            switch_at = pos + int(rng.geometric(1.0 / (2500 if hot else 8000)))
        if pos >= end_limit:
            break
        r = rng.random()
        if r < cfg.indel_fraction:
            ilen = min(int(rng.geometric(0.25)), cfg.max_indel_len)
            if rng.random() < 0.5 and pos + 1 + ilen < end_limit:
                ref = seq[pos : pos + 1 + ilen].tobytes()
                alt = seq[pos : pos + 1].tobytes()
            else:
                ref = seq[pos : pos + 1].tobytes()
                alt = ref + _markov_seq(rng, ilen).tobytes()
            variants.append((pos, ref, alt))
            pos += len(ref) + 1
        elif r < cfg.indel_fraction + cfg.mnp_fraction:
            w = int(rng.integers(2, 4))
            ref = seq[pos : pos + w].tobytes()
            alt = bytes(
                BASES[(int(np.searchsorted(BASES, b)) + int(rng.integers(1, 4))) % 4] for b in ref
            )
            variants.append((pos, ref, alt))
            pos += w + 1
        else:
            refb = seq[pos : pos + 1].tobytes()
            alt = BASES[(int(np.searchsorted(BASES, refb[0])) + int(rng.integers(1, 4))) % 4]
            variants.append((pos, refb, bytes([alt])))
    return variants


def _qual_profile(rng: np.random.Generator, L: int) -> np.ndarray:
    """Phred per cycle: Q40 -> ~Q22 ramp plus per-read jitter."""
    base = 40.0 - 18.0 * (np.arange(L) / max(1, L - 1)) ** 1.5
    q = base + rng.normal(0, 2.0, L)
    return np.clip(q, 5, 41).astype(np.int32)


def simulate_indep(out_dir: str, cfg: IndepConfig) -> IndepResult:
    from graphtyper_tpu_torch.utils.simulate import _apply_haplotype, _write_fasta, _write_vcf

    rng = np.random.default_rng(cfg.seed)
    os.makedirs(out_dir, exist_ok=True)
    seq = _markov_seq(rng, cfg.region_length)
    fasta = os.path.join(out_dir, "ref.fa")
    _write_fasta(fasta, cfg.chrom, seq)
    variants = _hotspot_variants(rng, seq, cfg)
    vcf = os.path.join(out_dir, "sites.vcf")
    _write_vcf(vcf, cfg.chrom, variants)

    result = IndepResult(fasta=fasta, vcf=vcf, sams=[])
    for v in variants:
        result.truth[v] = []

    n_pairs = int(cfg.coverage * cfg.region_length / (2 * cfg.read_length))
    adapter = np.frombuffer(ADAPTER, dtype=np.uint8)
    for s in range(cfg.n_samples):
        gts = rng.integers(0, 2, size=(len(variants), 2))
        for v, gt in zip(variants, gts):
            result.truth[v].append((int(gt.min()), int(gt.max())))
        haps = [_apply_haplotype(seq, variants, gts[:, h]) for h in range(2)]
        sam_path = os.path.join(out_dir, f"isample{s}.sam")
        result.n_reads += _write_reads(sam_path, cfg, rng, haps, f"isample{s}", n_pairs, adapter)
        cram_path = sam_path[:-4] + ".cram"
        _to_cram(sam_path, cram_path, fasta)
        os.remove(sam_path)
        result.sams.append(cram_path)
    return result


def _to_cram(sam_path: str, cram_path: str, fasta: str) -> None:
    from graphtyper_tpu_torch.io.bam import read_alignments
    from graphtyper_tpu_torch.io.cram_writer import write_cram

    header, reads = read_alignments(sam_path, parse_tags=True)
    write_cram(cram_path, header, reads)


def _write_reads(path, cfg: IndepConfig, rng, haps, sample, n_pairs, adapter) -> int:
    from graphtyper_tpu_torch.utils.simulate import _cigar_from_positions

    L = cfg.read_length
    records = []
    for i in range(n_pairs):
        hap_seq, hap_pos = haps[i % 2]
        frag = int(rng.normal(cfg.insert_mean, cfg.insert_sd))
        frag = max(60, min(frag, len(hap_seq) - 1))
        start = int(rng.integers(0, len(hap_seq) - frag))
        for mate in (0, 1):
            if frag >= L:
                ss = start if mate == 0 else start + frag - L
                bases = hap_seq[ss : ss + L].copy()
                cigar = _cigar_from_positions(hap_pos[ss : ss + L])
                p = int(hap_pos[ss])
                clip = 0
            else:
                # adapter read-through: `frag` template bases + adapter fill,
                # soft-clipped by the aligner
                ss = start
                clip = L - frag
                tmpl = hap_seq[ss : ss + frag].copy()
                # both mates cover the whole template then run into adapter;
                # SAM stores reference orientation, so the template part is
                # the same forward sequence for either mate
                bases = np.concatenate([tmpl, np.resize(adapter, clip)])
                cigar = _cigar_from_positions(hap_pos[ss : ss + frag]) + f"{clip}S"
                p = int(hap_pos[ss])
            q = _qual_profile(rng, L)
            err = rng.random(L) < 10.0 ** (-q / 10.0)
            n_err = int(err.sum())
            if n_err:
                at = np.nonzero(err)[0]
                bases[at] = BASES[
                    (np.searchsorted(BASES, bases[at]) + rng.integers(1, 4, size=n_err)) % 4
                ]
            p_other = int(hap_pos[start + max(0, frag - L)]) if frag >= L else p
            tlen = frag if mate == 0 else -frag
            flag = 99 if mate == 0 else 147
            qual = "".join(chr(33 + int(x)) for x in q)
            records.append(
                (
                    p,
                    f"{sample}_r{i}\t{flag}\t{cfg.chrom}\t{p + 1}\t60\t{cigar}\t=\t{p_other + 1}"
                    f"\t{tlen}\t{bases.tobytes().decode()}\t{qual}\tRG:Z:rg_{sample}",
                )
            )
    records.sort(key=lambda t: t[0])
    with open(path, "w") as f:
        f.write("@HD\tVN:1.6\tSO:coordinate\n")
        f.write(f"@SQ\tSN:{cfg.chrom}\tLN:{cfg.region_length}\n")
        f.write(f"@RG\tID:rg_{sample}\tSM:{sample}\n")
        for _, line in records:
            f.write(line + "\n")
    return 2 * n_pairs
