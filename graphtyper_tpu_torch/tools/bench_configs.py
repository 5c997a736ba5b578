"""BASELINE configs 1, 2 and 4 measured end to end on a device (the
counterpart of tools/bench_configs.py):

  config 1: the reference's bundled test region (tests/data/index_test.fa,
            index_test.vcf.gz prior sites, test.sam) through
            `genotype_only_with_a_vcf`: the median of 5 walls in this
            process, then 3 cold `python -m graphtyper_tpu_torch.cli
            genotype` processes (what a user sees: interpreter start,
            imports, the engine and kernel loads);
  config 2: 5 Mb chromosome-scale, 30x, one sample, seed 6, the full
            3-iteration pipeline over 4 region workers;
  config 4: a 50-sample × 1 Mb × 30x cohort, seed 8, 4 region workers.

Configs 2 and 4 first warm the region workers on a 200 kb, 30x sample
(seed 2), as the JAX tool does, so the timed run finds them up.

Simulated inputs are kept under --cache (default: the temporary
directory), in gt_cfg2_cache and gt_cfg4_cache, keyed by the recipe in
meta.json, so reruns skip the simulation; outputs go beside them.
`--kb` and `--samples` override configs 2 and 4's region length and
sample count (the CPU tests run them small).

    python -m graphtyper_tpu_torch.tools.bench_configs [1|2|4|both]
        [--device cuda|cpu] [--cache DIR] [--kb N] [--samples N]

Each config prints one JSON line with the JAX tool's keys and "device".
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from graphtyper_tpu_torch.tools.common import ROOT, child_env


def cached_sim(cache: str, cfg):
    """The cohort of `cfg` under `cache`, simulated once a recipe (the JAX
    tool's `_cached_sim` layout: meta.json holds the key and the paths)."""
    from types import SimpleNamespace

    from graphtyper_tpu_torch.utils.simulate import simulate_cohort

    meta_p = os.path.join(cache, "meta.json")
    key = dict(region_length=cfg.region_length, coverage=cfg.coverage, n_samples=cfg.n_samples, seed=cfg.seed)
    if os.path.exists(meta_p):
        with open(meta_p) as f:
            meta = json.load(f)
        if meta.get("key") == key and all(os.path.exists(p) for p in meta["sams"]):
            return SimpleNamespace(fasta=meta["fasta"], sams=meta["sams"], n_reads=meta["n_reads"])
    os.makedirs(cache, exist_ok=True)
    t0 = time.perf_counter()
    sim = simulate_cohort(os.path.join(cache, "m"), cfg)
    print(f"sim: {time.perf_counter() - t0:.3f} s", flush=True)
    with open(meta_p, "w") as f:
        json.dump({"key": key, "fasta": sim.fasta, "sams": list(sim.sams), "n_reads": sim.n_reads}, f)
    return sim


def warm(device) -> None:
    """Spawn the region workers and load the kernels outside the timed
    window (the shape bench.py uses: production runs keep workers hot)."""
    from graphtyper_tpu_torch.pipeline.genotype import genotype_regions
    from graphtyper_tpu_torch.utils.simulate import SimConfig, simulate_cohort

    tmp = tempfile.mkdtemp(prefix="gt_cfgwarm_")
    try:
        cfg = SimConfig(region_length=200_000, coverage=30.0, n_samples=1, seed=2, out_format="bam")
        sim = simulate_cohort(os.path.join(tmp, "w"), cfg)
        genotype_regions(sim.fasta, sim.sams, f"{cfg.chrom}:1-200000", os.path.join(tmp, "out"), device,
                         processes=4)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def config1(device, out_dir: str, reps: int = 5, cold: int = 3) -> dict:
    """BASELINE config 1: the median of `reps` in-process walls (the
    workload is tiny, so this measures fixed costs: graph and index build,
    the single-process pipeline) and of `cold` CLI processes. The VCF of
    the last in-process run is kept under `out_dir`/warm."""
    from graphtyper_tpu_torch.pipeline.genotype import genotype_only_with_a_vcf

    fa = os.path.join(ROOT, "tests", "data", "index_test.fa")
    vcf = os.path.join(ROOT, "tests", "data", "index_test.vcf.gz")
    sam = os.path.join(ROOT, "tests", "data", "test.sam")
    walls = []
    for _ in range(reps):
        out = os.path.join(out_dir, "warm")
        shutil.rmtree(out, ignore_errors=True)
        t0 = time.perf_counter()
        path = genotype_only_with_a_vcf(fa, [sam], vcf, "chr1:1-100000", out, device)
        walls.append(time.perf_counter() - t0)
    walls.sort()
    colds = []
    for rep in range(cold):
        out = os.path.join(out_dir, f"cold{rep}")
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "graphtyper_tpu_torch.cli", "genotype", fa, "--sam", sam, "--vcf", vcf,
             "--region", "chr1:1-100000", "--output", out, "--device", str(device)],
            cwd=ROOT, env=child_env(), capture_output=True, text=True, timeout=600)
        colds.append(time.perf_counter() - t0)
        if p.returncode != 0:
            sys.stderr.write(p.stderr[-4000:])
            raise SystemExit(f"bench_configs: the cold CLI process exited {p.returncode}")
    colds.sort()
    line = {"config": 1, "device": str(device), "wall_s_median": walls[len(walls) // 2],
            "wall_s_min": walls[0],
            "cold_process_wall_s_median": colds[len(colds) // 2] if colds else None}
    print(json.dumps(line), flush=True)
    return {**line, "out": path}


def config2(device, cache: str, kb: int = 5000) -> dict:
    """BASELINE config 2: one sample's `kb` kb at 30x, seed 6."""
    from graphtyper_tpu_torch.pipeline.genotype import genotype_regions
    from graphtyper_tpu_torch.utils.simulate import SimConfig

    L = kb * 1000
    cfg = SimConfig(region_length=L, coverage=30.0, n_samples=1, seed=6, out_format="bam")
    sim = cached_sim(os.path.join(cache, "gt_cfg2_cache"), cfg)
    out = os.path.join(cache, "gt_cfg2_out")
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    genotype_regions(sim.fasta, sim.sams, f"{cfg.chrom}:1-{L}", out, device, processes=4)
    wall = time.perf_counter() - t0
    line = {"config": 2, "device": str(device), "wall_s": wall, "reads_per_sec": sim.n_reads / wall,
            "s_per_mb": wall / (L / 1e6), "n_reads": sim.n_reads}
    print(json.dumps(line), flush=True)
    return line


def config4(device, cache: str, kb: int = 1000, samples: int = 50) -> dict:
    """BASELINE config 4: `samples` samples × `kb` kb at 30x, seed 8."""
    from graphtyper_tpu_torch.pipeline.genotype import genotype_regions
    from graphtyper_tpu_torch.utils.simulate import SimConfig

    L = kb * 1000
    cfg = SimConfig(region_length=L, coverage=30.0, n_samples=samples, seed=8, out_format="bam")
    sim = cached_sim(os.path.join(cache, "gt_cfg4_cache"), cfg)
    out = os.path.join(cache, "gt_cfg4_out")
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    genotype_regions(sim.fasta, sim.sams, f"{cfg.chrom}:1-{L}", out, device, processes=4)
    wall = time.perf_counter() - t0
    line = {"config": 4, "device": str(device), "wall_s": wall, "reads_per_sec": sim.n_reads / wall,
            "n_reads": sim.n_reads}
    print(json.dumps(line), flush=True)
    return line


def main(argv: list[str] | None = None) -> int:
    from graphtyper_tpu_torch.device import resolve_device
    from graphtyper_tpu_torch.pipeline.genotype import shutdown_region_pool

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("which", nargs="?", default="both", choices=("1", "2", "4", "both"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cache", default="", help="where the simulated inputs and outputs go")
    ap.add_argument("--kb", type=int, default=0, help="region length of configs 2 and 4 (5000, 1000)")
    ap.add_argument("--samples", type=int, default=0, help="samples of config 4 (50)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cache = args.cache or tempfile.gettempdir()
    if args.which == "1":
        # tiny fixture workload: no worker warm-up needed
        out = tempfile.mkdtemp(prefix="gt_cfg1_")
        try:
            config1(device, out)
        finally:
            shutil.rmtree(out, ignore_errors=True)
        return 0
    try:
        warm(device)
        if args.which in ("2", "both"):
            config2(device, cache, args.kb or 5000)
        if args.which in ("4", "both"):
            config4(device, cache, args.kb or 1000, args.samples or 50)
    finally:
        shutdown_region_pool()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
