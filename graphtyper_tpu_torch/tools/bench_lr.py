"""Long-read pipeline benchmark of the port (the counterpart of
tools/bench_lr.py): simulate PacBio/ONT-style long reads over a region with
SNPs, run the port's `genotype_lr`, report throughput.

`genotype_lr` runs on the host only, in both packages: its pileup, its
haplotype phasing and its calls are numpy and Python, with no device op to
put on a card. So this tool takes no --device, and its numbers are host
numbers.

The cohort is the JAX tool's `sim_lr` with the same numpy draws (seed 3):
a random contig `chrLR` of --kb kb, a het SNP every 900 bp, and per sample
8 kb reads at --coverage from two haplotypes with 1 % sequencing errors.

    python -m graphtyper_tpu_torch.tools.bench_lr [--kb 500] [--samples 2]
        [--coverage 20] [--profile]

Prints the JAX tool's line: snps, records, bases, wall, mbases_per_sec.
"""

from __future__ import annotations

import argparse
import gzip
import os
import shutil
import tempfile
import time

import numpy as np


def sim_lr(tmp: str, kb: int, n_samples: int, coverage: float, seed: int):
    """(fasta, BAM paths, region, total bases, SNP count) of the long-read
    cohort under `tmp` (tools/bench_lr.py sim_lr)."""
    from graphtyper_tpu_torch.io.bam import AlignedRead, BamHeader
    from graphtyper_tpu_torch.io.bam_writer import write_bam
    from graphtyper_tpu_torch.utils.simulate import _random_seq, _write_fasta

    rng = np.random.default_rng(seed)
    L = kb * 1000
    chrom = "chrLR"
    seq = _random_seq(rng, L)
    fasta = os.path.join(tmp, "ref.fa")
    _write_fasta(fasta, chrom, seq)

    # het SNPs every ~900bp
    snp_pos = np.arange(500, L - 500, 900)
    alt = seq.copy()
    BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
    for p in snp_pos:
        alt[p] = BASES[(np.where(BASES == seq[p])[0][0] + 1 + rng.integers(0, 3)) % 4]

    read_len = 8000
    n_reads = int(coverage * L / read_len)
    bams = []
    total_bases = 0
    for s in range(n_samples):
        recs = []
        for i in range(n_reads):
            hap = (seq, alt)[int(rng.random() < 0.5)]
            start = int(rng.integers(0, max(1, L - read_len)))
            r = hap[start : start + read_len].copy()
            # sprinkle sequencing errors (1%)
            errs = rng.random(len(r)) < 0.01
            r[errs] = BASES[rng.integers(0, 4, int(errs.sum()))]
            qual = rng.integers(20, 50, len(r)).astype(np.uint8)
            mapq = int(rng.choice([10, 40, 60], p=[0.05, 0.15, 0.8]))
            recs.append(AlignedRead(
                name=f"s{s}_r{i}", flag=0, ref_id=0, pos=start, mapq=mapq,
                cigar=[(0, len(r))], mate_ref_id=-1, mate_pos=-1, tlen=0,
                seq=r.tobytes(), qual=qual, tags={"RG": f"rg_s{s}"}))
            total_bases += len(r)
        recs.sort(key=lambda x: x.pos)
        header = BamHeader(
            text=f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{chrom}\tLN:{L}\n"
            f"@RG\tID:rg_s{s}\tSM:s{s}\n",
            ref_names=[chrom], ref_lengths=[L])
        bam = os.path.join(tmp, f"s{s}.bam")
        write_bam(bam, header, recs)
        bams.append(bam)
    return fasta, bams, f"{chrom}:1-{L}", total_bases, len(snp_pos)


def main(argv: list[str] | None = None) -> int:
    from graphtyper_tpu_torch.pipeline.genotype_lr import genotype_lr

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--kb", type=int, default=500)
    ap.add_argument("--samples", type=int, default=2)
    ap.add_argument("--coverage", type=float, default=20.0)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)

    tmp = tempfile.mkdtemp(prefix="gt_lrbench_")
    try:
        fasta, bams, region, total_bases, n_snps = sim_lr(tmp, args.kb, args.samples, args.coverage, 3)
        t0 = time.monotonic()
        if args.profile:
            import cProfile
            import pstats

            prof = cProfile.Profile()
            prof.enable()
        out = genotype_lr(fasta, bams, region, os.path.join(tmp, "out"))
        wall = time.monotonic() - t0
        if args.profile:
            prof.disable()
            pstats.Stats(prof).sort_stats("cumulative").print_stats(20)
        with gzip.open(out, "rt") as f:
            records = sum(1 for line in f if not line.startswith("#"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"snps={n_snps} records={records} bases={total_bases} wall={wall:.3f}s "
          f"mbases_per_sec={total_bases / wall / 1e6:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
