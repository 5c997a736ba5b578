"""The port's VCFs against the JAX package's under several hash seeds, on
the cohorts of chip_smoke.py whose discovery realigns tied indels: camou
(genotype_camou over two intervals at ploidy 4), dist_e2e (the
sample-sharded cohort of the dist phase, through `genotype` in one
process, whose output the two ranks' must equal) and dist_cli (the dist
phase's two-region CLI cohort, through `genotype --region_file`).

Each cohort is simulated once; then each package's CLI runs it in a fresh
process under each PYTHONHASHSEED, the port on --device cpu, counting its
Smith-Waterman calls (`sw_plain`, the region workers' included). Python
salts the hashes of `str` and `bytes` per process, and the JAX package
orders tied indels by that salt, so its VCF may vary with the seed; the
port's VCF and SW calls must not. `--port-tree DIR` runs the port of
another checkout (an older commit's, say) against this one's JAX package.
Prints one line a run and, last, one JSON object {cohort: {"port": {seed:
md5}, "port_sw": {seed: calls}, "jax": {seed: md5}}}; exits 1 when the
port's records md5 or SW calls differ between seeds, or its md5 from the
JAX package's under a seed where the JAX package's does not vary.

    python tests/hash_seed_parity.py [--seeds 0,1,2] [--work DIR] [--port-tree DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import CAMOU, DIST_CLI, DIST_E2E, THREADS  # noqa: E402
from graphtyper_tpu_torch.simulate import SimConfig, simulate_cohort  # noqa: E402
from graphtyper_tpu_torch.tools.common import records_md5  # noqa: E402


def cohorts(work: str) -> dict:
    """{name: argv after the subcommand's output flag is added}, simulated once."""
    out = {}
    sim_kw, intervals = CAMOU
    cfg = SimConfig(**sim_kw)
    sim = simulate_cohort(os.path.join(work, "camou"), cfg)
    bed = os.path.join(work, "camou", "intervals.bed")
    with open(bed, "w") as f:
        f.writelines(f"{cfg.chrom}\t{lo}\t{hi}\n" for lo, hi in intervals)
    sams = [a for p in sim.sams for a in ("--sam", p)]
    out["camou"] = ["genotype_camou", sim.fasta, bed, "--threads", str(THREADS), *sams]

    e2e = SimConfig(**DIST_E2E)
    sim = simulate_cohort(os.path.join(work, "dist_e2e"), e2e)
    out["dist_e2e"] = ["genotype", sim.fasta, "--region", f"{e2e.chrom}:1-{e2e.region_length}",
                       *[a for p in sim.sams for a in ("--sam", p)]]

    two = SimConfig(**DIST_CLI)
    sim = simulate_cohort(os.path.join(work, "dist_cli"), two)
    regions = os.path.join(work, "dist_cli", "regions.txt")
    with open(regions, "w") as f:
        f.write(f"{two.chrom}:1-50000\n{two.chrom}:50001-100000\n")
    out["dist_cli"] = ["genotype", sim.fasta, "--region_file", regions, "--threads", "4", *sim.sams]
    return out


# the port's CLI in a fresh process, printing its SW calls after the run
PORT = """
import contextlib, io, json, sys
from graphtyper_tpu_torch import cli, counters
counters.reset()
with contextlib.redirect_stdout(io.StringIO()):
    rc = cli.main(json.loads(sys.argv[1]))
print("SW", counters.totals().get("sw_plain", 0))
sys.exit(rc)
"""


def run(pkg: str, argv: list[str], seed: str, out: str, tree: str) -> tuple[str, int | None]:
    """(records md5, the port's SW calls or None) of one CLI run."""
    env = dict(os.environ, PYTHONHASHSEED=seed, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = tree + os.pathsep + env.get("PYTHONPATH", "")
    if pkg == "graphtyper_tpu_torch":
        cmd = [sys.executable, "-c", PORT, json.dumps([*argv, "-O", out, "--device", "cpu"])]
    else:
        cmd = [sys.executable, "-m", f"{pkg}.cli", *argv, "-O", out]
    p = subprocess.run(cmd, cwd=tree, env=env, capture_output=True, text=True, timeout=1800)
    if p.returncode != 0:
        raise SystemExit(f"{pkg} {argv[0]} under PYTHONHASHSEED={seed} exited {p.returncode}:\n{p.stderr[-4000:]}")
    vcfs = [os.path.join(d, f) for d, _, fs in os.walk(out) for f in fs if f.endswith(".vcf.gz")]
    sw = [int(line.split()[1]) for line in p.stdout.splitlines() if line.startswith("SW ")]
    return records_md5(vcfs)[0], sw[-1] if sw else None


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--work", default="")
    ap.add_argument("--port-tree", default=REPO, help="the checkout whose port runs")
    args = ap.parse_args(argv)
    seeds = args.seeds.split(",")
    work = args.work or tempfile.mkdtemp(prefix="gt_hashseed_")
    result, ok = {}, True
    for name, cmd in cohorts(work).items():
        got = {"port": {}, "port_sw": {}, "jax": {}}
        for seed in seeds:
            for key, pkg, tree in (("port", "graphtyper_tpu_torch", os.path.abspath(args.port_tree)),
                                   ("jax", "graphtyper_tpu", REPO)):
                md5, sw = run(pkg, cmd, seed, os.path.join(work, f"{name}_{key}_{seed}"), tree)
                got[key][seed] = md5
                if sw is not None:
                    got["port_sw"][seed] = sw
                print(f"{name} {key} PYTHONHASHSEED={seed}: {md5}" + (f", {sw} SW calls" if sw is not None else ""),
                      flush=True)
        port, jax = set(got["port"].values()), set(got["jax"].values())
        ok &= len(port) == 1 and len(set(got["port_sw"].values())) == 1 and (len(jax) > 1 or port == jax)
        result[name] = got
    print(json.dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
