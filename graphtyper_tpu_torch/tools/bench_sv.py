"""The SV workload of the port: simulate a region with DEL/DUP/INV SVs and
paired reads for a small cohort, run the port's `genotype_sv` on a device,
and report reads/s (the counterpart of tools/bench_sv.py).

    python -m graphtyper_tpu_torch.tools.bench_sv [--kb 300] [--samples 4]
        [--coverage 30] [--device cuda|cpu] [--keep DIR]

The cohort is tools/bench_sv.py's, made from numpy seed 7: a random contig
`chrSV` of --kb kb, one SV every 25 kb from 12 kb on (DEL, DUP, INV in
turn, 60-399 bp), and per sample 125 bp read pairs (fragment 340) at
--coverage from two haplotypes, one carrying each SV with probability 0.4.
The run passes --coverage / 125 as every sample's avg_cov_by_readlen, so
the coverage filter is active. The last line is one JSON object with the
result and this process's event counters.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from dataclasses import dataclass

import numpy as np

from graphtyper_tpu_torch.utils.simulate import _random_seq, _write_fasta

CHROM = "chrSV"
READ_LEN, FRAG = 125, 340


def _write_sv_vcf(path, chrom, svs):
    lines = [
        "##fileformat=VCFv4.2",
        f"##contig=<ID={chrom}>",
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO",
    ]
    for kind, pos1, ref_base, size, end1 in svs:
        if kind == "DEL":
            info = f"SVTYPE=DEL;SVLEN=-{size};SVSIZE={size};END={end1}"
        elif kind == "DUP":
            info = f"SVTYPE=DUP;SVLEN={size};SVSIZE={size};END={end1}"
        else:
            info = f"SVTYPE=INV;SVLEN={size};SVSIZE={size};END={end1}"
        lines.append(f"{chrom}\t{pos1}\t.\t{ref_base}\t<{kind}>\t.\t.\t{info}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _apply_svs(seq: np.ndarray, svs, carry: np.ndarray) -> np.ndarray:
    out = []
    cur = 0
    for (kind, pos1, _rb, size, end1), c in zip(svs, carry):
        p0 = pos1 - 1
        out.append(seq[cur : p0 + 1])
        if not c:
            out.append(seq[p0 + 1 : end1])
            cur = end1
            continue
        if kind == "DEL":
            cur = end1
        elif kind == "DUP":
            out.append(seq[p0 + 1 : end1])
            out.append(seq[p0 + 1 : end1])
            cur = end1
        else:  # INV
            seg = seq[p0 + 1 : end1]
            comp = {65: 84, 84: 65, 67: 71, 71: 67}
            out.append(np.array([comp.get(int(b), 78) for b in seg[::-1]], dtype=seq.dtype))
            cur = end1
    out.append(seq[cur:])
    return np.concatenate(out)


def _sim_sample_bam(path, chrom, contig_len, haps, n_pairs, sample, seed, read_len=125, frag=340):
    from graphtyper_tpu_torch.io.bam import AlignedRead, BamHeader
    from graphtyper_tpu_torch.io.bam_writer import write_bam

    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n_pairs):
        hap = haps[i % len(haps)]
        f = max(read_len + 10, min(frag + int(rng.normal(0, 30)), len(hap) - 1))
        start = int(rng.integers(0, len(hap) - f))
        r1 = hap[start : start + read_len].tobytes()
        r2 = hap[start + f - read_len : start + f].tobytes()
        p1, p2 = start, start + f - read_len
        name = f"{sample}_r{i}"
        qual = np.full(read_len, 40, dtype=np.uint8)
        cig = [(0, read_len)]
        recs.append(
            AlignedRead(name=name, flag=99, ref_id=0, pos=p1, mapq=60, cigar=cig,
                        mate_ref_id=0, mate_pos=p2, tlen=p2 + read_len - p1,
                        seq=r1, qual=qual, tags={"RG": f"rg_{sample}"})
        )
        recs.append(
            AlignedRead(name=name, flag=147, ref_id=0, pos=p2, mapq=60, cigar=cig,
                        mate_ref_id=0, mate_pos=p1, tlen=-(p2 + read_len - p1),
                        seq=r2, qual=qual, tags={"RG": f"rg_{sample}"})
        )
    recs.sort(key=lambda r: r.pos)
    header = BamHeader(
        text=f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{chrom}\tLN:{contig_len}\n"
        f"@RG\tID:rg_{sample}\tSM:{sample}\n",
        ref_names=[chrom],
        ref_lengths=[contig_len],
    )
    write_bam(path, header, recs)
    return len(recs)


@dataclass
class SvCohort:
    fasta: str
    sv_vcf: str
    bams: list[str]
    region: str  # chrSV:1-L
    n_svs: int
    n_reads: int
    avg_cov_by_readlen: list[float]


def build_cohort(out_dir: str, kb: int = 300, samples: int = 4, coverage: float = 30.0) -> SvCohort:
    """tools/bench_sv.py:115-146: the reference, the SV VCF and one BAM per
    sample under `out_dir`, from numpy seed 7."""
    L = kb * 1000
    rng = np.random.default_rng(7)
    seq = _random_seq(rng, L)
    os.makedirs(out_dir, exist_ok=True)
    fasta = os.path.join(out_dir, "ref.fa")
    _write_fasta(fasta, CHROM, seq)

    # one SV per ~25kb, mixed types
    svs = []
    kinds = ["DEL", "DUP", "INV"]
    for k, p in enumerate(range(12000, L - 15000, 25000)):
        size = int(rng.integers(60, 400))
        svs.append((kinds[k % 3], p + 1, chr(seq[p]), size, p + 1 + size))
    sv_vcf = os.path.join(out_dir, "sv.vcf")
    _write_sv_vcf(sv_vcf, CHROM, svs)

    n_pairs = int(coverage * L / (2 * READ_LEN))
    bams = []
    n_reads = 0
    for s in range(samples):
        carry = (rng.random(len(svs)) < 0.4).astype(np.int8)
        hap_a = _apply_svs(seq, svs, carry)
        bam = os.path.join(out_dir, f"s{s}.bam")
        n_reads += _sim_sample_bam(bam, CHROM, L, [hap_a, seq], n_pairs, f"s{s}", 100 + s,
                                   read_len=READ_LEN, frag=FRAG)
        bams.append(bam)
    return SvCohort(fasta, sv_vcf, bams, f"{CHROM}:1-{L}", len(svs), n_reads,
                    [coverage / READ_LEN] * samples)


def main(argv: list[str] | None = None) -> int:
    from graphtyper_tpu_torch import counters
    from graphtyper_tpu_torch.device import resolve_device
    from graphtyper_tpu_torch.pipeline.genotype import genotype_sv

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--kb", type=int, default=300)
    ap.add_argument("--samples", type=int, default=4)
    ap.add_argument("--coverage", type=float, default=30.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--keep", default="", help="build the cohort and the output in this directory and keep them")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    tmp = args.keep or tempfile.mkdtemp(prefix="gt_svbench_")
    cohort = build_cohort(tmp, args.kb, args.samples, args.coverage)
    counters.reset()
    t0 = time.perf_counter()
    out = genotype_sv(cohort.fasta, cohort.sv_vcf, cohort.bams, cohort.region, os.path.join(tmp, "out"),
                      device, avg_cov_by_readlen=cohort.avg_cov_by_readlen)
    wall = time.perf_counter() - t0

    import gzip

    with gzip.open(out, "rt") as f:
        records = sum(1 for line in f if not line.startswith("#"))
    print(f"svs={cohort.n_svs} records={records} reads={cohort.n_reads} wall={wall:.3f}s "
          f"reads_per_sec={cohort.n_reads / wall:.1f} device={device.type}")
    print(json.dumps(dict(svs=cohort.n_svs, records=records, reads=cohort.n_reads, wall_s=wall,
                          reads_per_sec=cohort.n_reads / wall, device=device.type, out=out,
                          counters=counters.totals())))
    if not args.keep:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
