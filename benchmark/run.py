"""Run one cell of the benchmark once.

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (an entry of `workloads` in
BENCHMARK.json) names a configuration (benchmark/configs/<name>.json)
and a traffic mix (benchmark/traffic/<name>.json); each metric is read by
benchmark/metrics/<name>.py. A run:

1. makes K regions in rotation and one warm-up region from the seed
   (benchmark/gen), as indexed BAMs in a new directory under TMPDIR (and,
   for a configuration with SVs, each region's SV panel VCF);
2. starts the port on cuda: the options of the traffic's subcommand
   (`subcommand`: `genotype`, the default, or `genotype_sv`) with the
   traffic's flags, one warm-up job of the cell's own shape on the
   warm-up region (which spawns the region workers where a `genotype`
   job has more than one unit);
3. measures a closed loop: one client sends the next job when the last
   returns, cycling over the K regions, each job through fresh hard links
   in a new directory and into a new output directory, with the options
   set before it as the subcommand sets them; the window ends with the
   first job to finish after --seconds, and its length is measured;
4. compares every job's VCF records with the plain reference of its
   subcommand (benchmark/reference.py; benchmark/reference_sv.py for
   `genotype_sv`) and prints the numbers beside their limits, last on
   standard error and under `limits` in the result line;
5. prints the result as the last line of standard output.

Without a CUDA device it exits 2 and prints no result; it never falls
back to the CPU. With `--trace 1` it reports the cell's per-layer
metrics instead of its end-to-end ones, from the scoring telemetry
(GT_SCORING_STATS), the port's counters and spans (GT_TRACE; the spans
are written at exit to benchmark/.cache/trace/<workload>.json, which
Perfetto opens), a profiler range around each kernel call of this
process (the device time of what each call launched), NVML's
utilization, and torch.profiler in every process that drives the card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

from benchmark import harness
from benchmark.harness import Run, print_err

#: limits of the numbers compared, each between the readings of sound runs
#: and of the control or a planted fault (PERF.md §2): a `genotype` cell's
LIMITS = {"pl_mismatch": 0.25, "ad_gap": 0.02, "pl_steps": 4, "false_sites": 0.03}
#: and a `genotype_sv` cell's
SV_LIMITS = {"sv_gt_mismatch": 0.52, "sv_missed": 0.09}
SUBCOMMANDS = ("genotype", "genotype_sv")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cell(name: str) -> tuple[dict, dict, dict, dict]:
    """(BENCHMARK.json, the workload, its configuration, its traffic)."""
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    cfg = harness.load_json(harness.ROOT, conf["file"])
    traffic = harness.load_json(harness.HERE, "traffic", work["traffic"] + ".json")
    if traffic.get("subcommand", "genotype") not in SUBCOMMANDS:
        raise SystemExit(f"traffic {work['traffic']!r}: subcommand {traffic['subcommand']!r} is none of {SUBCOMMANDS}")
    return bench, work, cfg, traffic


class Jobs:
    """The port's `genotype` or `genotype_sv` subcommand as a function of
    one region, set up as one CLI invocation a job: options from the
    subcommand's own parser and `_options_from_args` before every job (the
    options are process-global and `genotype_regions` changes them),
    inputs through fresh hard links, a new output directory."""

    def __init__(self, fasta: str, cli_flags: list, work_dir: str, device, subcommand: str = "genotype"):
        from graphtyper_tpu_torch import cli
        from graphtyper_tpu_torch.config import set_options
        from graphtyper_tpu_torch.pipeline.genotype import genotype_regions, genotype_sv

        self.cli, self.set_options = cli, set_options
        self.genotype_regions, self.genotype_sv = genotype_regions, genotype_sv
        self.fasta, self.flags, self.dir, self.device = fasta, cli_flags, work_dir, device
        self.run = self.run_sv if subcommand == "genotype_sv" else self.run_genotype
        self.n = 0

    def threads(self) -> int:
        """`--threads` of the traffic's flags as the subcommand parses it:
        the region pool's size."""
        return self.cli.parse_args(["genotype", self.fasta, *self.flags]).threads

    def links(self, region) -> list[str]:
        d = os.path.join(self.dir, f"job{self.n:06d}", "in")
        os.makedirs(d)
        out = []
        for bam in region.bams:
            dst = os.path.join(d, os.path.basename(bam))
            os.link(bam, dst)
            os.link(bam + ".bai", dst + ".bai")
            out.append(dst)
        return out

    def run_genotype(self, region) -> tuple[float, list]:
        sams = self.links(region)
        out_dir = os.path.join(self.dir, f"job{self.n:06d}", "out")
        self.n += 1
        where = f"{region.contig}:1-{len(region.seq)}"
        t0 = time.perf_counter()
        args = self.cli.parse_args(["genotype", self.fasta, "--region", where, "-O", out_dir, *self.flags,
                                    "--device", self.device.type, *sams])
        self.set_options(self.cli._options_from_args(args))
        outs = self.genotype_regions(args.ref, sams, where, out_dir, self.device, avg_cov_by_readlen=None,
                                     prior_vcf=None, output_all_variants=False)
        return time.perf_counter() - t0, outs

    def run_sv(self, region) -> tuple[float, list]:
        """A `genotype_sv` job against the region's SV panel (hard-linked
        with the BAMs), `--avg_cov_by_readlen` read as the subcommand
        reads it."""
        sams = self.links(region)
        panel = os.path.join(self.dir, f"job{self.n:06d}", "in", os.path.basename(region.panel))
        os.link(region.panel, panel)
        out_dir = os.path.join(self.dir, f"job{self.n:06d}", "out")
        self.n += 1
        where = f"{region.contig}:1-{len(region.seq)}"
        t0 = time.perf_counter()
        args = self.cli.parse_args(["genotype_sv", self.fasta, panel, "--region", where, "-O", out_dir, *self.flags,
                                    "--device", self.device.type, *sams])
        self.set_options(self.cli._options_from_args(args))
        avg_cov = None
        if args.avg_cov_by_readlen:
            avg_cov = self.cli._read_avg_cov(args.avg_cov_by_readlen, len(sams))
            if avg_cov is None:
                raise SystemExit(f"--avg_cov_by_readlen {args.avg_cov_by_readlen}: not one value a BAM")
        out = self.genotype_sv(args.ref, args.sv_vcf, sams, where, out_dir, self.device, avg_cov_by_readlen=avg_cov)
        return time.perf_counter() - t0, [out]


def check(seed: int, cfg: dict, length: int, regions: list, jobs: list,
          subcommand: str = "genotype") -> tuple[bool, dict]:
    """Every job's records against the reference's calls of its region,
    the reads made again from the seed."""
    if subcommand == "genotype_sv":
        return check_sv(seed, cfg, length, regions, jobs)
    from benchmark import reference
    from benchmark.gen import make_region

    refs, per_job = {}, []
    for job in jobs:
        reg = regions[job.region]
        if job.region not in refs:
            full = make_region(seed, job.region + 1, reg.contig, length, cfg)
            refs[job.region] = reference.call_region(full.seq, full.variants, full.reads)
        calls = reference.read_vcfs(job.outputs, reg.seq, len(reg.samples))
        per_job.append(reference.compare(calls, reg.seq, reg.variants, refs[job.region]))
    return decide(per_job)


def sv_reference_gts(seed: int, cfg: dict, length: int, index: int, contig: str):
    """The SV reference's GT of region `index` (reads made again from the
    seed), and its SVs."""
    from benchmark import reference_sv
    from benchmark.gen import make_region

    full = make_region(seed, index, contig, length, cfg)
    return reference_sv.call_svs(full.seq, full.svs, full.reads), full.svs


def sv_references(seed: int, cfg: dict, length: int, used: list) -> dict:
    """`sv_reference_gts` of the regions in rotation `used` (0-based), a
    region a spawned process, at most one a core."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(max_workers=min(os.cpu_count() or 1, len(used)),
                             mp_context=mp.get_context("spawn")) as pool:
        got = pool.map(sv_reference_gts, [seed] * len(used), [cfg] * len(used), [length] * len(used),
                       [r + 1 for r in used], [f"r{r}" for r in used])
        return dict(zip(used, got))


def check_sv(seed: int, cfg: dict, length: int, regions: list, jobs: list) -> tuple[bool, dict]:
    """Every `genotype_sv` job's AGGREGATED records against the SV
    reference's calls of its region, the reads made again from the seed."""
    from benchmark import reference_sv

    refs = sv_references(seed, cfg, length, sorted({j.region for j in jobs}))
    per_job = []
    for job in jobs:
        gt, svs = refs[job.region]
        calls = reference_sv.read_sv_vcfs(job.outputs, len(regions[job.region].samples))
        per_job.append(reference_sv.compare(calls, svs, length, gt))
    return decide(per_job, "genotype_sv")


def decide(per_job: list[dict], subcommand: str = "genotype") -> tuple[bool, dict]:
    """`correct`, and the numbers compared, from the sums that
    `reference.compare` (a `genotype` cell) or `reference_sv.compare` (a
    `genotype_sv` cell) gives for each job."""
    if subcommand == "genotype_sv":
        tot = {k: sum(g[k] for g in per_job) for k in ("sv_pairs", "sv_mismatch_pairs", "sv_carried", "sv_missed")}
        numbers = {"sv_gt_mismatch": tot["sv_mismatch_pairs"] / max(tot["sv_pairs"], 1),
                   "sv_missed": tot["sv_missed"] / max(tot["sv_carried"], 1)}
        ok = tot["sv_pairs"] > 0 and tot["sv_carried"] > 0 and all(numbers[k] <= SV_LIMITS[k] for k in SV_LIMITS)
        return ok, numbers
    tot = {k: sum(g[k] for g in per_job) for k in ("pairs", "pl_mismatch_pairs", "ad_abs", "ad_ref",
                                                   "called_sites", "false_sites")}
    numbers = {"pl_mismatch": tot["pl_mismatch_pairs"] / max(tot["pairs"], 1),
               "ad_gap": tot["ad_abs"] / max(tot["ad_ref"], 1),
               "pl_steps": max((g["pl_steps"] for g in per_job), default=0),
               "false_sites": tot["false_sites"] / max(tot["called_sites"], 1)}
    ok = tot["pairs"] > 0 and all(numbers[k] <= LIMITS[k] for k in LIMITS)
    return ok, numbers


def main(argv=None) -> int:
    args = parse_args(argv)
    t_proc = harness.process_start_time()
    import torch

    chips = cell(args.workload)[1]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print_err(f"benchmark: needs {chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    return run_cell(args, torch.device("cuda", 0), t_proc)


def run_cell(args, device, t_proc: float) -> int:
    """A run of the cell on `device` (the CPU only in the harness's own
    tests), from the process start at wall time `t_proc`."""
    bench, work, cfg, traffic = cell(args.workload)
    # the deployment's settings of the port's environment, before any of it
    # loads (the region workers inherit them)
    os.environ.update(traffic.get("env", {}))
    cache = os.path.join(harness.HERE, ".cache")
    os.makedirs(os.path.join(cache, "triton"), exist_ok=True)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    work_dir = tempfile.mkdtemp(prefix="gt_bench_")
    trace_dir = os.path.join(work_dir, "trace")
    os.makedirs(trace_dir)
    if args.trace:
        os.environ["GT_SCORING_STATS"] = os.path.join(trace_dir, "scoring_stats.jsonl")
        # the port's spans, on in every process that imports it after this;
        # written when this process exits, after the result, so the file lies
        # at a fixed place in the checkout and not in the work directory
        os.makedirs(os.path.join(cache, "trace"), exist_ok=True)
        os.environ["GT_TRACE"] = os.path.join(cache, "trace", args.workload + ".json")
    run = Run()
    try:
        return measure(args, bench, work, cfg, traffic, run, work_dir, trace_dir, device, t_proc)
    finally:
        from graphtyper_tpu_torch.pipeline.genotype import shutdown_region_pool

        shutdown_region_pool()
        shutil.rmtree(work_dir, ignore_errors=True)


def measure(args, bench, work, cfg, traffic, run: Run, work_dir, trace_dir, device, t_proc) -> int:
    import torch

    from benchmark.gen import make_inputs

    length, K = traffic["job_bp"], traffic["regions_in_rotation"]
    t_gen = time.perf_counter()
    fasta, warm, regions = make_inputs(args.seed, cfg, length, K, os.path.join(work_dir, "in"))
    t_gen = time.perf_counter() - t_gen
    made = warm.n_reads + sum(r.n_reads for r in regions)
    print_err(f"inputs: {made} reads in {K + 1} regions made and indexed in {t_gen:.3f} s "
              f"({made / t_gen:.1f} reads/s)")
    subcommand = traffic.get("subcommand", "genotype")
    jobs = Jobs(fasta, traffic["cli"], os.path.join(work_dir, "jobs"), device, subcommand)
    cuda = device.type == "cuda"
    if args.trace:
        _trace_region_pool(jobs.threads(), trace_dir, cuda)
    calls = harness.KernelCalls() if args.trace and cuda else None
    if calls:
        calls.__enter__()
    t_warm = time.perf_counter()
    jobs.run(warm)
    run.warmup_s = time.perf_counter() - t_warm
    print_err(f"warm-up job: {run.warmup_s:.3f} s")
    if calls:
        calls.calls.clear()
    from graphtyper_tpu_torch import counters

    if args.trace and hasattr(counters, "trace"):
        counters.trace(True)     # where the port was imported before GT_TRACE was set
    counters.reset()
    stats_path = os.environ.get("GT_SCORING_STATS")
    if stats_path:
        open(stats_path, "w").close()
    if cuda:
        # the allocator of this process starts at its first allocation (a
        # region-pool cell allocates nothing here until then)
        torch.zeros(1, device=device)
        torch.cuda.reset_peak_memory_stats(device)
    nvml = harness.NvmlUtilization() if args.trace and cuda else None
    prof = harness.start_profiler(cuda) if args.trace else None
    with harness.Sampler(device if cuda else None) as sampler:
        if nvml:
            nvml.__enter__()
        w0_ns = time.time_ns()
        run.setup_s = time.time() - t_proc
        cpu0 = harness.cpu_ticks(os.getpid())
        run.jobs, run.window_s = harness.closed_loop(jobs.run, regions, args.seconds)
        cpu1 = harness.cpu_ticks(os.getpid())
        w1_ns = time.time_ns()
        if nvml:
            nvml.__exit__(None, None, None)
    run.window = (w0_ns, w1_ns)
    if args.trace and hasattr(counters, "spans"):
        from benchmark import spans

        run.spans = spans.clip(counters.spans(), run.window)
    run.peak_rss_bytes = sampler.peak_rss
    run.workers_rss_bytes = sampler.peak_children_rss
    run.memory_peak_bytes = max(sampler.peak_device, torch.cuda.max_memory_allocated(device) if cuda else 0)
    run.counters = counters.totals()
    from graphtyper_tpu_torch.pipeline.genotype import shutdown_region_pool

    shutdown_region_pool()
    result_breakdown = None
    if args.trace:
        if calls:
            calls.__exit__(None, None, None)
        if stats_path and os.path.exists(stats_path):
            with open(stats_path) as f:
                run.scoring_stats = [json.loads(line) for line in f if line.strip()]
        if nvml:
            run.util_samples = nvml.samples
        prof.stop()
        events = prof.profiler.kineto_results.events()
        if calls:
            run.kernel_calls = harness.kernel_calls(events, calls.calls)
            print_err(f"kernel calls: {len(calls.calls)} in the window, {len(run.kernel_calls)} with device time")
        intervals, named = harness.device_intervals(prof, events)
        w_int, w_named = harness.read_worker_traces(trace_dir)
        intervals, named = intervals + w_int, named + w_named
        run.intervals = intervals
        inside = [(max(s, w0_ns), min(e, w1_ns)) for s, e in intervals if e > w0_ns and s < w1_ns]
        run.busy_s = harness.union_seconds(inside) / 1e9
        result_breakdown = harness.breakdown(named, intervals, run.window, spans=run.spans or None)
    metrics = {}
    for m in harness.metrics_of(bench, work["name"], bool(args.trace)):
        value = harness.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    t_check = time.perf_counter()
    ok, numbers = check(args.seed, cfg, length, regions, run.jobs, subcommand)
    print_err(f"check: {time.perf_counter() - t_check:.3f} s")
    found = harness.forbidden_modules(list(sys.modules))
    if found:
        print_err("benchmark: modules of JAX or the JAX package are loaded: " + ", ".join(found))
        return 3
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu", "count": work["chips"],
                   "memory_peak_bytes": int(run.memory_peak_bytes)}
    if args.trace:
        device_info.update(busy_s=run.busy_s, window_s=run.window_s)
    walls = [round(j.wall_s, 4) for j in run.jobs]
    print_err(f"jobs: {len(walls)} in {run.window_s:.3f} s; walls (s): {walls}")
    print_err(f"peak RSS: harness {sampler.peak_self_rss} B, its descendants {sampler.peak_children_rss} B, "
              f"tree {sampler.peak_rss} B")
    print_err(harness.cpu_report(cpu0, cpu1, run.window_s))
    limits = {k: {"value": numbers[k], "limit": lim}
              for k, lim in (SV_LIMITS if subcommand == "genotype_sv" else LIMITS).items()}
    for k, v in limits.items():
        print_err(f"compared {k} = {v['value']!r} (limit {v['limit']!r})")
    result = {"correct": ok, "attempted": len(run.jobs), "failed": 0 if ok else len(run.jobs),
              "metrics": metrics, "device": device_info}
    if result_breakdown is not None:
        result["breakdown"] = result_breakdown
    result["limits"] = limits
    print(json.dumps(result), flush=True)
    return 0


def _trace_region_pool(n: int, trace_dir: str, cuda: bool) -> None:
    """Start the port's region pool as `genotype_regions` would (n spawn
    workers), with a profiler in each worker."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    from graphtyper_tpu_torch.pipeline import genotype

    genotype._POOL = ProcessPoolExecutor(max_workers=n, mp_context=mp.get_context("spawn"),
                                         initializer=harness.worker_trace_init, initargs=(trace_dir, cuda))
    genotype._POOL_SIZE = n


if __name__ == "__main__":
    sys.exit(main())
