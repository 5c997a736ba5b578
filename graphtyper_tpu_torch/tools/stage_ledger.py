"""Per-stage wall ledger of the port's genotype pipeline on a device (the
counterpart of tools/stage_ledger.py).

Runs one workload in this process (one region worker, one pool thread,
so the stages run one after another and their walls add up to the run's),
three times: a warm run, a clean run (the wall without tracing) and a
traced run, with the port's spans (counters.py), the C++ engine's stage
counters (GT_NATIVE_PROFILE=1) and the scoring telemetry
(GT_SCORING_STATS, ops/site_scoring.py) on. Each stage is the self time of
its spans (a span's wall less its children's), each marked device-eligible
when the port launches a CUDA kernel or torch op for it:

    bamshrink               bamshrink
    discovery_first_pass    discovery
    fp_aggregation_device   discovery.pileup (ops/discovery_pileup.py
                            aggregate_rows)
    graph_build             graph.build
    kmer_index              index.build
    align_genotype_host     call and call.pool, less the engine's seed share
                            and the verdicts below
    site_scoring_device     scoring.flush and scoring.materialize
                            (ops/site_scoring.py finalize: staging, launch,
                            collect and the fold into site state)
    sw_realign_device       realign (ops/sw.py align_batch, csrc/sw_rot.cu)
    merge_decompose         merge
    vcf_write               sites.write and write (the sites VCF, the copy
                            of the results)
    align_clean_device      the verdict kernel's align_wall_s from the
                            telemetry lines, with its clean share from
                            device_align_stats
    seed_device             the engine's seed share of its stage 1

The last two are the call iterations' align stage, device work only with
--device-align (GT_DEVICE_ALIGN=on and device_seed="on"); without it they
are host work and the verdicts do not run. `scoring_cprofile_s`, the JAX
tool's cProfile time of the scoring finalize, is here the wall of the
scoring.flush spans.

Every other stage is host work. CUDA launches are asynchronous, so a
stage's time is the host's wall up to the collect of its device work: the
device time that overlaps host work is not split out, and the output line
says so under "timing". The fraction is over the clean wall, and the
Amdahl ceiling is what accelerating the device-eligible stages alone could
give.

    python -m graphtyper_tpu_torch.tools.stage_ledger [--indep] [--samples 1] [--kb 200]
        [--device cuda|cpu] [--device-align]

The workload is 30x: a simulated BAM cohort of --samples samples over
--kb kb (seed 1), or with --indep the independent CRAM workload (120 kb,
seed 9).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import sys
import tempfile
import time
from dataclasses import replace

from graphtyper_tpu_torch import counters

# stage -> (its spans, device-eligible?)
STAGES = [
    ("bamshrink", ("bamshrink",), False),
    ("discovery_first_pass", ("discovery",), False),
    ("fp_aggregation_device", ("discovery.pileup",), True),
    ("graph_build", ("graph.build",), False),
    ("kmer_index", ("index.build",), False),
    # align + score: the pooled caller; its device-eligible inner parts are
    # measured apart below and subtracted
    ("align_genotype_host", ("call", "call.pool"), False),
    ("site_scoring_device", ("scoring.flush", "scoring.materialize"), True),
    ("sw_realign_device", ("realign",), True),
    ("merge_decompose", ("merge",), False),
    ("vcf_write", ("sites.write", "write"), False),
]

TIMING = ("host wall per stage, up to the collect of its device work; CUDA launches are "
          "asynchronous, so device time that overlaps host work is not split out")


def _native_profile_seed_s(stderr_text: str) -> dict:
    """The engine's GT_NATIVE_PROFILE lines: stage 1's wall, and its seed
    share (stage 1's wall times the seed's share of the thread sums of
    seed, lattice and walk; valid for one region worker's serial calls)."""
    out = {"seed_s": 0.0, "stage1_s": 0.0}
    for m in re.finditer(
        r"\[gt_native\].*?stage1=([\d.]+)s stage2=[\d.]+s "
        r"\(thread-sum: seed=([\d.]+)s lattice=([\d.]+)s walk=([\d.]+)s",
        stderr_text,
    ):
        stage1 = float(m.group(1))
        seed, lattice, walk = (float(m.group(k)) for k in (2, 3, 4))
        denom = seed + lattice + walk
        if denom > 0:
            out["seed_s"] += stage1 * (seed / denom)
        out["stage1_s"] += stage1
    return out


def _telemetry(path: str) -> dict:
    """The GT_SCORING_STATS lines of `path`, summed key by key."""
    tot: dict = {}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                for k, v in json.loads(line).items():
                    if k != "pid":
                        tot[k] = tot.get(k, 0) + v
    return tot


def build_workload(tmp: str, workload: str, n_samples: int, kb: int):
    from graphtyper_tpu_torch.simulate import IndepConfig, SimConfig, simulate_cohort, simulate_indep

    if workload == "indep":
        cfg = IndepConfig(region_length=120_000, coverage=30.0, seed=9)
        sim = simulate_indep(os.path.join(tmp, "m"), cfg)
        return sim, f"{cfg.chrom}:1-120000"
    cfg = SimConfig(region_length=kb * 1000, coverage=30.0, seed=1, n_samples=n_samples,
                    out_format="bam")
    sim = simulate_cohort(os.path.join(tmp, "m"), cfg)
    return sim, f"{cfg.chrom}:1-{kb * 1000}"


def run(workload: str, device="cuda", n_samples: int = 1, kb: int = 200,
        device_align: bool = False) -> dict:
    import torch

    from graphtyper_tpu_torch.config import current_options, set_options
    from graphtyper_tpu_torch.pipeline.genotype import genotype_regions
    from graphtyper_tpu_torch.pipeline.native_caller import device_align_stats

    device = torch.device(device)
    tmp = tempfile.mkdtemp(prefix="gt_ledger_")
    base = current_options()
    saved_env = {k: os.environ.get(k) for k in ("GT_NATIVE_PROFILE", "GT_SCORING_STATS", "GT_DEVICE_ALIGN")}
    tracing = counters.tracing()
    try:
        sim, region = build_workload(tmp, workload, n_samples, kb)
        # pool threads would run the scorer's launches and collects side by
        # side, and the telemetry sums their walls
        set_options(replace(base, threads=1, **({"device_seed": "on"} if device_align else {})))
        if device_align:
            os.environ["GT_DEVICE_ALIGN"] = "on"
        tuned = current_options()

        def one(out):
            set_options(tuned)  # genotype_regions tunes the options per cohort size
            return genotype_regions(sim.fasta, sim.sams, region, os.path.join(tmp, out), device, processes=1)

        # the engine reads GT_NATIVE_PROFILE once, before its first call
        os.environ["GT_NATIVE_PROFILE"] = "1"
        stats_path = os.path.join(tmp, "scoring_stats.jsonl")
        os.environ["GT_SCORING_STATS"] = stats_path
        one("warm")  # builds, first launches; its profile lines go to stderr
        t0 = time.perf_counter()
        one("clean")
        wall_clean = time.perf_counter() - t0
        open(stats_path, "w").close()  # keep only the traced run's lines

        prof_path = os.path.join(tmp, "native_prof.txt")
        device_align_stats()  # reset the engine's verdict counters
        saved_fd = os.dup(2)
        prof_fd = os.open(prof_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
        counters.reset()
        counters.trace(True)
        t0 = time.perf_counter()
        os.dup2(prof_fd, 2)
        try:
            one("out")
        finally:
            os.dup2(saved_fd, 2)
            os.close(prof_fd)
            os.close(saved_fd)
            counters.trace(tracing)
        wall = time.perf_counter() - t0
        spans = counters.spans()
        clean, fallback, _bad = device_align_stats()
        with open(prof_path) as f:
            native = _native_profile_seed_s(f.read())
        tel = _telemetry(stats_path)
    finally:
        set_options(base)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    shutil.rmtree(tmp, ignore_errors=True)

    own = counters.self_seconds(spans)
    scoring_flush = sum((s.end_ns - s.start_ns) / 1e9 for s in spans if s.name == "scoring.flush")
    align_s = tel.get("align_wall_s", 0.0) if device_align else 0.0
    ledger = {}
    for stage, names, dev in STAGES:
        v = sum(own.get(name, 0.0) for name in names)
        if stage == "align_genotype_host":
            # the pooled caller's own time holds the seed and the verdicts
            v = max(0.0, v - native["seed_s"] - align_s)
        ledger[stage] = {"wall_s": v, "device_eligible": dev}
    ledger["seed_device"] = {"wall_s": native["seed_s"], "device_eligible": device_align}
    ledger["align_clean_device"] = {
        "wall_s": align_s,
        "device_eligible": device_align,
        "clean_fraction": clean / (clean + fallback) if clean + fallback else 0.0,
    }
    staged = sum(v["wall_s"] for v in ledger.values())
    device_s = sum(v["wall_s"] for v in ledger.values() if v["device_eligible"])
    f_dev = device_s / wall_clean if wall_clean else 0.0
    return {
        "workload": workload,
        "device": str(device),
        "n_samples": n_samples,
        "kb": kb,
        "n_reads": sim.n_reads,
        "wall_s": wall,
        "wall_clean_s": wall_clean,
        "stages": ledger,
        "telemetry": tel,
        "scoring_cprofile_s": scoring_flush,
        "unattributed_s": max(0.0, wall - staged),
        "device_eligible_fraction": f_dev,
        "amdahl_speedup_ceiling": 1.0 / (1.0 - f_dev) if f_dev < 1 else None,
        "timing": TIMING,
    }


def main(argv: list[str] | None = None) -> int:
    from graphtyper_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--indep", action="store_true", help="the independent 120 kb CRAM workload")
    ap.add_argument("--samples", type=int, default=1)
    ap.add_argument("--kb", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--device-align", action="store_true",
                    help='the align stage on the device: GT_DEVICE_ALIGN=on and device_seed="on"')
    args = ap.parse_args(argv)
    out = run("indep" if args.indep else "snp", resolve_device(args.device), n_samples=args.samples,
              kb=args.kb, device_align=args.device_align)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
