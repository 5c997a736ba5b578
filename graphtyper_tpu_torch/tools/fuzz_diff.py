"""Cross-path differential fuzzing of the port (the counterpart of
tools/fuzz_diff.py).

For random workloads, the pipeline must produce the same final VCF records
no matter which implementation path runs. The reference of each seed is
the port's own `genotype` on --device; every leg below runs the same
cohort another way and must equal it line for line (the `##` header lines
dropped):

    python_caller, python_aligner   the Python oracles of the C++ engine
    stream_on                       the streaming pooled caller
    threads1, threads4              1 and 4 pool threads
    host_sw                         device_sw="off": the engine's host SW
    bai                             BAI-sliced bamshrink (BAM seeds)
    cram, cram_pyrans               the BAMs re-encoded as CRAM
                                    (io/cram_writer.py), decoded natively and
                                    with the Python rANS (BAM seeds)
    sam                             the BAMs re-encoded as SAM (BAM seeds)
    regions                         pooled region fan-out (2 spawn workers)
                                    against the serial loop, 12 kb units
    vcf_mode                        genotype_only_with_a_vcf twice on the
                                    reference's input sites: equal outputs
    popvcf                          popVCF encoding decoded back
    sv                              genotype_sv on messy SV reads: the
                                    engine's pooled loop against the Python
                                    loop, the Python aligner and the object
                                    path (SAM input), with and without the
                                    coverage filter
    cpu                             --device cpu, the plain PyTorch versions
                                    (when --device is not cpu)
    device_align                    GT_DEVICE_ALIGN=on: the verdict kernel
    device_seed                     device_seed="on": the seed-probe kernel

Every third seed (seed % 3 == 2) is the independent CRAM workload
(utils/simulate_indep.py), the others a BAM cohort (utils/simulate.py).

    python -m graphtyper_tpu_torch.tools.fuzz_diff [--device cuda|cpu] [n_seeds] [base]

Prints one line per seed with each leg's wall, and exits 1 on any
difference.
"""

from __future__ import annotations

import argparse
import gzip
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field, replace
from types import SimpleNamespace

import torch

from graphtyper_tpu_torch.config import current_options, set_options
from graphtyper_tpu_torch.io.bai import ensure_bai
from graphtyper_tpu_torch.pipeline.genotype import genotype
from graphtyper_tpu_torch.utils.simulate import SimConfig, simulate_cohort
from graphtyper_tpu_torch.utils.simulate_indep import IndepConfig, simulate_indep


def vcf_text(path: str) -> list[str]:
    with gzip.open(path, "rt") as f:
        return [line for line in f if not line.startswith("##")]


def run(sim, region, out_dir, device, **opt_over):
    base = current_options()
    if opt_over:
        set_options(replace(base, **opt_over))
    try:
        return genotype(sim.fasta, sim.sams, region, out_dir, device)
    finally:
        set_options(base)


def bam_to_other(sim, fmt: str, out_dir: str):
    """Re-encode the cohort's BAMs as CRAM or SAM with identical records."""
    from graphtyper_tpu_torch.io.bam import read_alignments
    from graphtyper_tpu_torch.io.cram_writer import write_cram
    from graphtyper_tpu_torch.io.sam_writer import write_sam

    out = []
    for i, p in enumerate(sim.sams):
        header, reads = read_alignments(p, parse_tags=True)
        dst = os.path.join(out_dir, f"re{i}.{fmt}")
        if fmt == "cram":
            write_cram(dst, header, reads)
        else:
            write_sam(dst, header, reads)
        out.append(dst)
    return out


@dataclass
class SeedResult:
    """One seed's failures, each leg's wall (s, host clock), the cohort and
    the reference run's output VCF."""

    seed: int
    fails: list[str] = field(default_factory=list)
    walls: dict[str, float] = field(default_factory=dict)
    sim: object = None
    region: str = ""
    ref_out: str = ""


class _Legs:
    """Runs the legs of one seed against its reference records."""

    def __init__(self, res: SeedResult, ref: list[str]):
        self.res = res
        self.ref = ref

    def check(self, name: str, fn, what: str = "output differs") -> None:
        """fn() -> VCF lines or None; a difference or an exception fails the leg."""
        t0 = time.perf_counter()
        try:
            got = fn()
            if got is not None and got != self.ref:
                self.res.fails.append(f"seed {self.res.seed}: {name} {what}")
        except Exception as e:
            self.res.fails.append(f"seed {self.res.seed}: {name} raised {e!r}")
        self.res.walls[name] = self.res.walls.get(name, 0.0) + time.perf_counter() - t0


def fuzz_seed(seed: int, tmp: str, device: torch.device | str) -> SeedResult:
    device = torch.device(device)
    res = SeedResult(seed)
    rng_len = 30_000 + (seed * 7919) % 25_000
    if seed % 3 == 2:
        cfg = IndepConfig(region_length=rng_len, n_samples=1 + seed % 2, coverage=12.0, seed=seed)
        sim = simulate_indep(os.path.join(tmp, "sim"), cfg)
    else:
        cfg = SimConfig(region_length=rng_len, n_samples=1 + seed % 3,
                        coverage=10.0 + (seed % 3) * 4, seed=seed, out_format="bam")
        sim = simulate_cohort(os.path.join(tmp, "sim"), cfg)
    region = f"{cfg.chrom}:1-{rng_len}"
    res.sim, res.region = sim, region

    t0 = time.perf_counter()
    res.ref_out = run(sim, region, os.path.join(tmp, "ref"), device)
    res.walls["reference"] = time.perf_counter() - t0
    ref = vcf_text(res.ref_out)
    if len(ref) < 3:
        res.fails.append(f"seed {seed}: reference run produced {len(ref)} lines")
        return res
    legs = _Legs(res, ref)

    def leg(name, out_sim=sim, **over):
        legs.check(name, lambda: vcf_text(run(out_sim, region, os.path.join(tmp, f"v_{name}"),
                                              device, **over)))

    leg("python_caller", native_caller="off")
    leg("python_aligner", native_aligner="off")
    leg("stream_on", streaming_caller="on")
    leg("threads1", threads=1)
    leg("threads4", threads=4)
    # the engine's host SW in place of the device's (ops/sw.py align_batch_host)
    leg("host_sw", device_sw="off")

    if all(p.endswith(".bam") for p in sim.sams):
        def bai():
            for p in sim.sams:
                ensure_bai(p, min_size=0)
            try:
                return vcf_text(run(sim, region, os.path.join(tmp, "v_bai"), device))
            finally:
                for p in sim.sams:
                    if os.path.exists(p + ".bai"):
                        os.remove(p + ".bai")

        legs.check("bai", bai, "BAI-sliced output differs")

        sim_cram = SimpleNamespace(fasta=sim.fasta, sams=bam_to_other(sim, "cram", tmp))
        leg("cram", sim_cram)
        from graphtyper_tpu_torch.io import cram as crammod

        saved_rans = crammod._rans_decode_native
        crammod._rans_decode_native = lambda *a, **k: None
        try:
            leg("cram_pyrans", sim_cram)
        finally:
            crammod._rans_decode_native = saved_rans
        leg("sam", SimpleNamespace(fasta=sim.fasta, sams=bam_to_other(sim, "sam", tmp)))

    # pooled region fan-out vs the serial loop (3 units)
    from graphtyper_tpu_torch.pipeline.genotype import genotype_regions, shutdown_region_pool

    def regions():
        serial = genotype_regions(sim.fasta, sim.sams, region, os.path.join(tmp, "r_ser"), device,
                                  max_region_size=12_000, processes=1)
        try:
            pooled = genotype_regions(sim.fasta, sim.sams, region, os.path.join(tmp, "r_pool"), device,
                                      max_region_size=12_000, processes=2)
        finally:
            shutdown_region_pool()
        for a, b in zip(serial, pooled):
            if vcf_text(a) != vcf_text(b):
                res.fails.append(f"seed {seed}: pooled regions differ at {os.path.basename(a)}")

    legs.check("regions", regions)

    # --vcf mode determinism: two runs on the reference's input sites
    from graphtyper_tpu_torch.pipeline.genotype import genotype_only_with_a_vcf

    site_files = []
    for root, _, files in os.walk(os.path.join(tmp, "ref", "input_sites")):
        site_files += [os.path.join(root, f) for f in files if f.endswith(".vcf.gz")]
    if site_files:
        def vcf_mode():
            o1, o2 = (genotype_only_with_a_vcf(sim.fasta, sim.sams, site_files[0], region,
                                               os.path.join(tmp, d), device) for d in ("gv1", "gv2"))
            if vcf_text(o1) != vcf_text(o2):
                res.fails.append(f"seed {seed}: --vcf mode nondeterministic")

        legs.check("vcf_mode", vcf_mode)

    # popVCF final encoding must decode back to the plain output
    def popvcf():
        from graphtyper_tpu_torch.io.popvcf import decode_file

        out_pop = run(sim, region, os.path.join(tmp, "v_pop"), device, encoding="p")
        dec = os.path.join(tmp, "pop_decoded.vcf.gz")
        decode_file(out_pop, dec)
        return vcf_text(dec)

    legs.check("popvcf", popvcf, "roundtrip differs")

    t0 = time.perf_counter()
    res.fails += fuzz_sv(seed, os.path.join(tmp, "sv"), device)
    res.walls["sv"] = time.perf_counter() - t0

    # the port's own device legs
    if device.type != "cpu":
        legs.check("cpu", lambda: vcf_text(run(sim, region, os.path.join(tmp, "v_cpu"), "cpu")))

    def device_align():
        os.environ["GT_DEVICE_ALIGN"] = "on"
        try:
            return vcf_text(run(sim, region, os.path.join(tmp, "v_device_align"), device))
        finally:
            os.environ.pop("GT_DEVICE_ALIGN")

    legs.check("device_align", device_align)
    leg("device_seed", device_seed="on")
    return res


def _sim_sv_messy(tmp: str, seed: int):
    """An SV cohort with deliberately messy reads: low/edge mapq, soft clips
    (one- and both-ended), far mates, unmapped(-mate) flags, unpaired reads,
    duplicates and flag-filtered mates (leftover-mate fodder), everything
    is_good_sv_read, the coverage bins and the leftover resolution branch
    on (tools/fuzz_diff.py:214, the same records for the same seed)."""
    import numpy as np

    from graphtyper_tpu_torch.io.bam import AlignedRead, BamHeader
    from graphtyper_tpu_torch.io.bam_writer import write_bam
    from graphtyper_tpu_torch.utils.simulate import _random_seq, _write_fasta

    rng = np.random.default_rng(seed * 131 + 7)
    L = 24_000 + (seed * 4099) % 12_000
    chrom = "chrFSV"
    seq = _random_seq(rng, L)
    os.makedirs(tmp, exist_ok=True)
    fasta = os.path.join(tmp, "ref.fa")
    _write_fasta(fasta, chrom, seq)

    svs = []  # (kind, pos1, size)
    p = 5000
    kinds = ["DEL", "DUP", "INV"]
    while p < L - 3000:
        svs.append((kinds[len(svs) % 3], p + 1, int(rng.integers(60, 300))))
        p += int(rng.integers(5000, 9000))
    with open(os.path.join(tmp, "sv.vcf"), "w") as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write(f"##contig=<ID={chrom}>\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for kind, pos1, size in svs:
            sgn = "-" if kind == "DEL" else ""
            f.write(f"{chrom}\t{pos1}\t.\t{chr(seq[pos1 - 1])}\t<{kind}>\t.\t.\t"
                    f"SVTYPE={kind};SVLEN={sgn}{size};SVSIZE={size};END={pos1 + size}\n")

    # alt haplotype: apply every SV
    parts, cur = [], 0
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    for kind, pos1, size in svs:
        p0 = pos1 - 1
        parts.append(seq[cur : p0 + 1])
        seg = seq[p0 + 1 : p0 + 1 + size]
        if kind == "DUP":
            parts.append(seg)
            parts.append(seg)
        elif kind == "INV":
            parts.append(np.frombuffer(seg.tobytes().translate(comp), dtype=np.uint8)[::-1])
        cur = p0 + 1 + size
    parts.append(seq[cur:])
    hap_alt = np.concatenate(parts)

    read_len, frag = 100, 300
    n_pairs = int(14.0 * L / (2 * read_len))
    bams = []
    for s in range(2):
        recs = []
        for i in range(n_pairs):
            hap = (seq, hap_alt)[int(rng.random() < 0.5)] if s == 0 else seq
            f = max(read_len + 8, min(frag + int(rng.normal(0, 40)), len(hap) - 1))
            start = int(rng.integers(0, len(hap) - f))
            r1 = hap[start : start + read_len].tobytes()
            r2 = hap[start + f - read_len : start + f].tobytes()
            p1, p2 = start, start + f - read_len
            mapq = int(rng.choice([0, 10, 15, 16, 30, 60], p=[0.05, 0.1, 0.05, 0.1, 0.2, 0.5]))
            cig1 = [(0, read_len)]
            roll = rng.random()
            if roll < 0.12:  # front clip
                c = int(rng.integers(8, 20))
                cig1 = [(4, c), (0, read_len - c)]
            elif roll < 0.2:  # back clip
                c = int(rng.integers(8, 20))
                cig1 = [(0, read_len - c), (4, c)]
            elif roll < 0.25:  # both clipped
                cig1 = [(4, 10), (0, read_len - 22), (4, 12)]
            flag1, flag2 = 99, 147
            mp1, mp2 = p2, p1
            roll2 = rng.random()
            if roll2 < 0.06:  # far mate
                mp1 = p1 + 250_000
                mp2 = p1 + 250_000
            elif roll2 < 0.1:  # mate unmapped
                flag1 = (flag1 | 0x8) & ~0x2
            elif roll2 < 0.14:  # unpaired read (drop the mate entirely)
                flag1 &= ~(0x1 | 0x2 | 0x8 | 0x20 | 0x40)
                flag2 = -1
            elif roll2 < 0.2:  # mate flag-filtered (0x400 dup) -> leftover
                flag2 |= 0x400
            qual = np.full(read_len, 35, dtype=np.uint8)
            name = f"s{s}_r{i}"
            recs.append(AlignedRead(name=name, flag=flag1, ref_id=0, pos=p1, mapq=mapq,
                                    cigar=cig1, mate_ref_id=0, mate_pos=mp1,
                                    tlen=p2 + read_len - p1, seq=r1, qual=qual,
                                    tags={"RG": f"rg_s{s}"}))
            if flag2 >= 0:
                recs.append(AlignedRead(name=name, flag=flag2, ref_id=0, pos=p2, mapq=mapq,
                                        cigar=[(0, read_len)], mate_ref_id=0, mate_pos=mp2,
                                        tlen=-(p2 + read_len - p1), seq=r2, qual=qual,
                                        tags={"RG": f"rg_s{s}"}))
            if rng.random() < 0.05 and flag2 >= 0:
                # dedup fodder: another pair with identical (pos, seq) under
                # a different name (the alignment is computed once, reused)
                d = recs[-1]
                recs.append(AlignedRead(name=name + "d", flag=d.flag, ref_id=0, pos=d.pos,
                                        mapq=d.mapq, cigar=list(d.cigar), mate_ref_id=0,
                                        mate_pos=d.mate_pos, tlen=d.tlen, seq=d.seq,
                                        qual=d.qual, tags=dict(d.tags)))
        recs.sort(key=lambda r: r.pos)
        header = BamHeader(
            text=f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{chrom}\tLN:{L}\n"
            f"@RG\tID:rg_s{s}\tSM:s{s}\n",
            ref_names=[chrom],
            ref_lengths=[L],
        )
        bam = os.path.join(tmp, f"s{s}.bam")
        write_bam(bam, header, recs)
        bams.append(bam)
    return fasta, os.path.join(tmp, "sv.vcf"), bams, f"{chrom}:1-{L}", L


def fuzz_sv(seed: int, tmp: str, device: torch.device | str) -> list[str]:
    """SV differential axis: the engine's pooled SV loop (BAM bytes and
    object paths), the Python loop with the engine's batch aligner, and the
    pure Python loop must emit the same VCF records, with and without the
    coverage-bin filter, on messy inputs."""
    from graphtyper_tpu_torch.io.bam import read_alignments
    from graphtyper_tpu_torch.io.sam_writer import write_sam
    from graphtyper_tpu_torch.pipeline.genotype import genotype_sv

    fails: list[str] = []
    os.makedirs(tmp, exist_ok=True)
    fasta, sv_vcf, bams, region, _L = _sim_sv_messy(tmp, seed)

    def run_sv(name, inputs, avg, **opt_over):
        base = current_options()
        if opt_over:
            set_options(replace(base, **opt_over))
        try:
            return genotype_sv(fasta, sv_vcf, inputs, region, os.path.join(tmp, f"out_{name}"), device,
                               avg_cov_by_readlen=avg)
        finally:
            set_options(base)

    for tag, avg in (("cov", [0.05, 0.05]), ("nocov", None)):
        try:
            ref = vcf_text(run_sv(f"{tag}_native", bams, avg))
        except Exception as e:
            fails.append(f"seed {seed}: SV {tag} native raised {e!r}")
            continue
        for name, over in (
            ("pyloop", dict(native_caller="off")),
            ("pyall", dict(native_caller="off", native_aligner="off")),
        ):
            try:
                if vcf_text(run_sv(f"{tag}_{name}", bams, avg, **over)) != ref:
                    fails.append(f"seed {seed}: SV {tag} {name} differs")
            except Exception as e:
                fails.append(f"seed {seed}: SV {tag} {name} raised {e!r}")
        # object-array path (SAM re-encode defeats the BAM-bytes fast path)
        try:
            sam_paths = []
            for i, p in enumerate(bams):
                header, reads = read_alignments(p, parse_tags=True)
                dst = os.path.join(tmp, f"re{i}.sam")
                write_sam(dst, header, list(reads))
                sam_paths.append(dst)
            if vcf_text(run_sv(f"{tag}_objpath", sam_paths, avg)) != ref:
                fails.append(f"seed {seed}: SV {tag} object-path differs")
        except Exception as e:
            fails.append(f"seed {seed}: SV {tag} object-path raised {e!r}")
    return fails


def main(argv: list[str] | None = None) -> int:
    from graphtyper_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("n_seeds", nargs="?", type=int, default=6)
    ap.add_argument("base", nargs="?", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    all_fails = []
    t0 = time.time()
    for seed in range(args.base, args.base + args.n_seeds):
        with tempfile.TemporaryDirectory(prefix="gt_fuzz_") as tmp:
            res = fuzz_seed(seed, tmp, device)
        status = "OK" if not res.fails else "; ".join(res.fails)
        walls = ", ".join(f"{k} {v:.3f}" for k, v in res.walls.items())
        print(f"[{time.time() - t0:6.1f}s] seed {seed} on {device}: {status} (leg walls, s: {walls})",
              flush=True)
        all_fails.extend(res.fails)
    if all_fails:
        print(f"\nFUZZ FAILURES ({len(all_fails)}):")
        for f in all_fails:
            print(" ", f)
        return 1
    print(f"\nall {args.n_seeds} seeds clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
