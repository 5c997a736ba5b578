"""Population-scale soak of the port (the counterpart of
tools/soak_population.py): a simulated cohort through the port's
`genotype_regions` on a device, with a wall and RSS ledger and the md5 of
the VCF records as the parity signature.

Simulation runs in a spawn process pool with per-sample RNG streams
(seeded by (seed, sample)), the same streams as the JAX package's tool, so
the same recipe gives the same cohort. The inputs are kept under --cache
(default: gt_soak_cache_<samples>x<kb>kb in the temporary directory),
keyed by the recipe. The genotyping run takes the port's population path
end to end: bamshrink, sam_merge chunking (more inputs than
max_files_open, or >= 200 samples a thread, collapse into merged pool
files), the streaming pooled caller, cohort-size tuning and the three
iterations, with --processes region workers on --device.

RSS ledger: a monitor thread samples the resident set of the whole
process tree (this process and its region and simulation workers) once a
second. The line before the last gives the peaks of this process alone
and of its descendants apart: with --processes N on cuda each region
worker holds a CUDA context and its pinned buffers, which the tree's
figure includes. The line before it gives the run's event counters
(counters.py: kernel launches and scoring rows, the region workers'
included).

    python -m graphtyper_tpu_torch.tools.soak_population [--samples 500] [--kb 1000]
        [--coverage 20] [--processes 4] [--threads 0] [--max-files-open 0]
        [--device cuda|cpu] [--cache DIR]

The last line is one JSON object: samples, kb, coverage, n_reads, wall_s,
reads_per_sec, peak_tree_rss_mb, n_records, md5.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import threading
import time

from graphtyper_tpu_torch.tools.common import records_md5


def _sim_one(args) -> tuple[str, int]:
    """One sample's BAM, deterministic under (seed, sample_i)."""
    import numpy as np

    (out_dir, sample_i, seed, region_length, coverage, read_length, chrom) = args
    from graphtyper_tpu_torch.io.bam import read_alignments
    from graphtyper_tpu_torch.io.bam_writer import write_bam
    from graphtyper_tpu_torch.utils import simulate as sm

    rng = np.random.default_rng((seed, sample_i))
    # regenerate the shared reference and variants from the cohort seed
    # (cheap beside the reads; keeps the workers independent)
    ref_rng = np.random.default_rng(seed)
    seq = sm._random_seq(ref_rng, region_length)
    cfg = sm.SimConfig(region_length=region_length, coverage=coverage, seed=seed,
                       read_length=read_length, chrom=chrom)
    variants = sm._make_variants(ref_rng, seq, cfg)
    gts = rng.integers(0, 2, size=(len(variants), 2))
    haps = [sm._apply_haplotype(seq, variants, gts[:, h]) for h in range(2)]
    n_pairs = int(coverage * region_length / (2 * read_length))
    sam_path = os.path.join(out_dir, f"sample{sample_i}.sam")
    sm._write_sample_sam(sam_path, cfg, rng, haps, f"sample{sample_i}", n_pairs)
    header, reads = read_alignments(sam_path, parse_tags=True)
    bam_path = sam_path[:-4] + ".bam"
    write_bam(bam_path, header, reads)
    os.remove(sam_path)
    return bam_path, 2 * n_pairs


def simulate_population(cache: str, n_samples: int, kb: int, coverage: float,
                        processes: int, seed: int = 42):
    """(fasta, BAM paths, read count) of the cohort, built under `cache` or
    found there from an earlier run of the same recipe."""
    import numpy as np

    meta_p = os.path.join(cache, "meta.json")
    key = dict(n_samples=n_samples, kb=kb, coverage=coverage, seed=seed)
    if os.path.exists(meta_p):
        with open(meta_p) as f:
            meta = json.load(f)
        if meta.get("key") == key and all(os.path.exists(p) for p in meta["sams"]):
            return meta["fasta"], meta["sams"], meta["n_reads"]
    os.makedirs(cache, exist_ok=True)
    from graphtyper_tpu_torch.utils import simulate as sm

    region_length = kb * 1000
    chrom = "chrP"
    ref_rng = np.random.default_rng(seed)
    seq = sm._random_seq(ref_rng, region_length)
    fasta = os.path.join(cache, "ref.fa")
    sm._write_fasta(fasta, chrom, seq)

    jobs = [(cache, i, seed, region_length, coverage, 151, chrom) for i in range(n_samples)]
    t0 = time.perf_counter()
    from multiprocessing import get_context

    with get_context("spawn").Pool(processes) as pool:
        results = pool.map(_sim_one, jobs, chunksize=4)
    sams = [r[0] for r in results]
    n_reads = sum(r[1] for r in results)
    print(f"sim: {n_samples} samples, {n_reads} reads in {time.perf_counter() - t0:.3f} s", flush=True)
    with open(meta_p, "w") as f:
        json.dump({"key": key, "fasta": fasta, "sams": sams, "n_reads": n_reads}, f)
    return fasta, sams, n_reads


class TreeRssMonitor:
    """Peak RSS of this process and all its descendants, sampled once a
    second: `peak_mb` of the tree, and apart `self_peak_mb` (this process)
    and `children_peak_mb` (the descendants' sum, with `children_at_peak`
    processes and `worker_peak_mb` the largest one)."""

    def __init__(self):
        self.peak_mb = 0.0
        self.self_peak_mb = 0.0
        self.children_peak_mb = 0.0
        self.children_at_peak = 0
        self.worker_peak_mb = 0.0
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)

    @staticmethod
    def _proc_table() -> tuple[dict[int, list[int]], dict[int, float]]:
        """Children of each pid, and each pid's VmRSS in MB."""
        children: dict[int, list[int]] = {}
        rss: dict[int, float] = {}
        for pid_s in os.listdir("/proc"):
            if not pid_s.isdigit():
                continue
            try:
                with open(f"/proc/{pid_s}/status") as f:
                    ppid = 0
                    kb = 0.0
                    for line in f:
                        if line.startswith("PPid:"):
                            ppid = int(line.split()[1])
                        elif line.startswith("VmRSS:"):
                            kb = float(line.split()[1])
                children.setdefault(ppid, []).append(int(pid_s))
                rss[int(pid_s)] = kb / 1024.0
            except OSError:
                continue
        return children, rss

    def sample(self) -> None:
        children, rss = self._proc_table()
        me = os.getpid()
        desc = []
        stack = list(children.get(me, []))
        while stack:
            p = stack.pop()
            desc.append(rss.get(p, 0.0))
            stack.extend(children.get(p, []))
        mine, theirs = rss.get(me, 0.0), sum(desc)
        self.peak_mb = max(self.peak_mb, mine + theirs)
        self.self_peak_mb = max(self.self_peak_mb, mine)
        if theirs > self.children_peak_mb:
            self.children_peak_mb, self.children_at_peak = theirs, len(desc)
        self.worker_peak_mb = max(self.worker_peak_mb, max(desc, default=0.0))

    def _run(self):
        while not self._stop.is_set():
            self.sample()
            self._stop.wait(1.0)

    def __enter__(self):
        self._t.start()
        return self

    def __exit__(self, *a):
        self._stop.set()
        self._t.join(timeout=3)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--samples", type=int, default=500)
    ap.add_argument("--kb", type=int, default=1000)
    ap.add_argument("--coverage", type=float, default=20.0)
    ap.add_argument("--processes", type=int, default=4)
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--max-files-open", type=int, default=0,
                    help="lower the pool-size cap so sam_merge chunking and the multi-pool "
                         "reduction engage below 864 samples (genotype.cpp:174-260)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cache", default="", help="where the cohort and the output go")
    args = ap.parse_args(argv)

    from graphtyper_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    if args.max_files_open or args.threads:
        from dataclasses import replace

        from graphtyper_tpu_torch.config import current_options, set_options

        kw = {}
        if args.max_files_open:
            kw["max_files_open"] = args.max_files_open
        if args.threads:
            # sam_merge chunking engages at >= 200 samples a thread
            # (genotype.cpp:174-260); fewer threads cross it below 800
            kw["threads"] = args.threads
        set_options(replace(current_options(), **kw))

    cache = args.cache or os.path.join(tempfile.gettempdir(), f"gt_soak_cache_{args.samples}x{args.kb}kb")
    fasta, sams, n_reads = simulate_population(cache, args.samples, args.kb, args.coverage, args.processes)

    from graphtyper_tpu_torch import counters
    from graphtyper_tpu_torch.pipeline.genotype import genotype_regions, shutdown_region_pool

    out = os.path.join(cache, f"out_{device.type}")
    shutil.rmtree(out, ignore_errors=True)
    counters.reset()
    t0 = time.perf_counter()
    with TreeRssMonitor() as mon:
        try:
            outs = genotype_regions(fasta, sams, f"chrP:1-{args.kb * 1000}", out, device,
                                    processes=args.processes)
            wall = time.perf_counter() - t0
            mon.sample()  # the region workers are still up here
        finally:
            shutdown_region_pool()
    md5, n_records = records_md5(outs)
    print("counters: " + json.dumps(counters.totals(), sort_keys=True), flush=True)
    print(f"rss: peak of the tree {mon.peak_mb} MB; this process {mon.self_peak_mb} MB; its"
          f" {mon.children_at_peak} descendants {mon.children_peak_mb} MB together, the largest"
          f" {mon.worker_peak_mb} MB (device {device}, --processes {args.processes})", flush=True)
    print(json.dumps({
        "samples": args.samples, "kb": args.kb, "coverage": args.coverage,
        "n_reads": n_reads, "wall_s": wall, "reads_per_sec": n_reads / wall,
        "peak_tree_rss_mb": mon.peak_mb, "n_records": n_records, "md5": md5,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
