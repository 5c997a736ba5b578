"""BASELINE config 5 scaling measurement of the port (the counterpart of
tools/bench_distributed.py): two real OS processes against one, a stand-in
for several hosts.

Each mode runs one process pinned to half of the machine's cores, then two
processes, each pinned to its own half (equal resources a host), all on
--device (cuda by default; both ranks share the one card). Ideal 2-host
scaling halves the wall; efficiency = t1 / (2 × t2), and ≥ 0.8 meets the
BASELINE target.

  sample_sharded  the cohort path of parallel/distributed.py: two ranks
                  joined by a gloo process group at 127.0.0.1 (not
                  jax.distributed), samples sharded by host, partials and
                  pool files gathered, host 0 merges; against one process's
                  `genotype` of the whole region.
  region_sharded  BASELINE config 5's stated strategy: the region cut in 4,
                  `assign_regions` gives each host its share, each runs
                  `genotype_regions` over 2 region workers, and host 0
                  concatenates the region VCFs (`vcf_concatenate`, timed).

The cohort is the JAX tool's: n_samples (8) × region_kb (200) kb at 20x,
seed 12, BAM. Each mode warms once (single and pair), then takes the best
of --reps (2) runs each. The VCF of the two processes must equal the single
process's, record for record, in both modes; a difference, or a process
that fails, fails the tool.

    python -m graphtyper_tpu_torch.tools.bench_distributed [n_samples] [region_kb]
        [--device cuda|cpu] [--reps 2]

Prints one JSON line: the JAX tool's keys ("n_samples", "region_kb",
"n_reads", "half_machine_cores", "region_sharded", "sample_sharded") and,
at the top, the sample-sharded "t1_s", "t2_s" and "scaling_efficiency".
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

from graphtyper_tpu_torch.tools.common import ROOT, child_env, records_md5

SINGLE = r"""
import os, sys, time, json
os.sched_setaffinity(0, set(json.loads(sys.argv[1])))
meta = json.load(open(sys.argv[2]))
from graphtyper_tpu_torch.pipeline.genotype import genotype
t0 = time.perf_counter()
out = genotype(meta["fasta"], meta["sams"], meta["region"], sys.argv[3], sys.argv[4])
print("WALL", time.perf_counter() - t0)
print("OUTS", json.dumps([out]))
"""

REGION_HOST = r"""
import os, sys, time, json
host = int(sys.argv[1])
os.sched_setaffinity(0, set(json.loads(sys.argv[2])))
meta = json.load(open(sys.argv[3]))
from graphtyper_tpu_torch.parallel.distributed import assign_regions
from graphtyper_tpu_torch.pipeline.genotype import genotype_regions, shutdown_region_pool
mine = assign_regions(meta["regions"], n_hosts=2, host=host)
t0 = time.perf_counter()
outs = []
for r in mine:
    outs.extend(genotype_regions(meta["fasta"], meta["sams"], r, sys.argv[4], sys.argv[5], processes=2))
print("WALL", time.perf_counter() - t0)
print("OUTS", json.dumps(outs))
shutdown_region_pool()
"""

REGION_SINGLE = r"""
import os, sys, time, json
os.sched_setaffinity(0, set(json.loads(sys.argv[1])))
meta = json.load(open(sys.argv[2]))
from graphtyper_tpu_torch.pipeline.genotype import genotype_regions, shutdown_region_pool
t0 = time.perf_counter()
outs = []
for r in meta["regions"]:
    outs.extend(genotype_regions(meta["fasta"], meta["sams"], r, sys.argv[3], sys.argv[4], processes=2))
print("WALL", time.perf_counter() - t0)
print("OUTS", json.dumps(outs))
shutdown_region_pool()
"""

CHILD = r"""
import os, sys, time, json
pid = int(sys.argv[1]); port = sys.argv[2]
os.sched_setaffinity(0, set(json.loads(sys.argv[3])))
meta = json.load(open(sys.argv[4]))
from graphtyper_tpu_torch.parallel import distributed
distributed.initialize(f"127.0.0.1:{port}", 2, pid)
t0 = time.perf_counter()
out = distributed.genotype_distributed(meta["fasta"], meta["sams"], meta["region"], sys.argv[5], sys.argv[6])
print("WALL", time.perf_counter() - t0)
print("OUTS", json.dumps([out] if out else []))
distributed.shutdown()
"""


def _field(out: str, tag: str) -> str:
    for line in out.splitlines():
        if line.startswith(tag + " "):
            return line[len(tag) + 1:]
    raise RuntimeError(f"no {tag} line:\n" + out[-2000:])


def _free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def _check(procs, outs) -> None:
    for p, (o, e) in zip(procs, outs):
        if p.returncode != 0:
            sys.stderr.write(o[-2000:] + e[-6000:])
            raise SystemExit(f"bench_distributed: a process exited {p.returncode}")


class Legs:
    """The four timed runs of the tool over one simulated cohort under
    `tmp`, each returning (wall, VCF paths): one process or two, sample- or
    region-sharded, the single process pinned to the first half of the
    cores and the two to a half each."""

    def __init__(self, tmp: str, sim, cfg, kb: int, device: str, n_regions: int = 4):
        self.tmp, self.device = tmp, device
        cores = sorted(os.sched_getaffinity(0))
        self.half_a, self.half_b = cores[: max(1, len(cores) // 2)], cores[len(cores) // 2:] or cores[:1]
        self.meta_p = os.path.join(tmp, "meta.json")
        with open(self.meta_p, "w") as f:
            json.dump({"fasta": sim.fasta, "sams": list(sim.sams), "region": f"{cfg.chrom}:1-{kb * 1000}"}, f)
        # region sharding: hosts own disjoint regions, the final reduction
        # is the byte-level vcf_concatenate
        step = kb * 1000 // n_regions
        self.regions = [f"{cfg.chrom}:{i * step + 1}-{(i + 1) * step}" for i in range(n_regions)]
        self.rmeta_p = os.path.join(tmp, "rmeta.json")
        with open(self.rmeta_p, "w") as f:
            json.dump({"fasta": sim.fasta, "sams": list(sim.sams), "regions": self.regions}, f)
        self.scripts = {}
        for name, text in (("single", SINGLE), ("child", CHILD), ("rs", REGION_SINGLE), ("rh", REGION_HOST)):
            self.scripts[name] = os.path.join(tmp, f"{name}.py")
            with open(self.scripts[name], "w") as f:
                f.write(text)
        self.env = child_env()
        self.env.setdefault("GLOO_SOCKET_IFNAME", "lo")

    def _one(self, script: str, *argv_) -> tuple[float, list[str]]:
        p = subprocess.run([sys.executable, self.scripts[script], *argv_], capture_output=True, text=True,
                           timeout=1800, env=self.env, cwd=ROOT)
        _check([p], [(p.stdout, p.stderr)])
        return float(_field(p.stdout, "WALL")), json.loads(_field(p.stdout, "OUTS"))

    def _pair(self, script: str, argvs) -> tuple[float, list[str]]:
        procs = [subprocess.Popen([sys.executable, self.scripts[script], *a], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True, env=self.env, cwd=ROOT) for a in argvs]
        outs = [p.communicate(timeout=1800) for p in procs]
        _check(procs, outs)
        paths = [q for o, _ in outs for q in json.loads(_field(o, "OUTS"))]
        return max(float(_field(o, "WALL")) for o, _ in outs), paths

    def single(self, tag: str):
        return self._one("single", json.dumps(self.half_a), self.meta_p, os.path.join(self.tmp, tag), self.device)

    def dist(self, tag: str):
        port = _free_port()
        return self._pair("child", [[str(pid), port, json.dumps(c), self.meta_p, os.path.join(self.tmp, f"{tag}{pid}"),
                                     self.device] for pid, c in ((0, self.half_a), (1, self.half_b))])

    def region_single(self, tag: str):
        return self._one("rs", json.dumps(self.half_a), self.rmeta_p, os.path.join(self.tmp, tag), self.device)

    def region_dist(self, tag: str):
        from graphtyper_tpu_torch.pipeline.vcf_operations import vcf_concatenate

        wall, paths = self._pair("rh", [[str(hid), json.dumps(c), self.rmeta_p, os.path.join(self.tmp, f"{tag}{hid}"),
                                         self.device] for hid, c in ((0, self.half_a), (1, self.half_b))])
        # host-0 final reduction: concatenate the per-region VCFs
        t0 = time.perf_counter()
        cat = os.path.join(self.tmp, f"{tag}_cat.vcf.gz")
        vcf_concatenate(sorted(paths), cat)
        return wall + (time.perf_counter() - t0), [cat]


def main(argv: list[str] | None = None) -> int:
    from graphtyper_tpu_torch.device import resolve_device
    from graphtyper_tpu_torch.utils.simulate import SimConfig, simulate_cohort

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("n_samples", nargs="?", type=int, default=8)
    ap.add_argument("region_kb", nargs="?", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))
    n_samples, kb = args.n_samples, args.region_kb

    tmp = tempfile.mkdtemp(prefix="gt_dbench_")
    try:
        cfg = SimConfig(region_length=kb * 1000, coverage=20.0, seed=12, n_samples=n_samples, out_format="bam")
        sim = simulate_cohort(os.path.join(tmp, "c"), cfg)
        legs = Legs(tmp, sim, cfg, kb, device)

        def best(fn, tag: str):
            runs = [fn(f"{tag}{i}") for i in range(args.reps)]
            return min(w for w, _ in runs), runs[-1][1]

        legs.single("w1")  # warm (kernel and engine builds, page cache)
        legs.dist("w2")
        t1, s_outs = best(legs.single, "s")
        t2, d_outs = best(legs.dist, "d")
        legs.region_single("rw1")
        legs.region_dist("rw2")
        r1, rs_outs = best(legs.region_single, "rs")
        r2, rd_outs = best(legs.region_dist, "rd")

        (s_md5, _), (d_md5, _) = records_md5(s_outs), records_md5(d_outs)
        (rs_md5, _), (rd_md5, _) = records_md5(rs_outs), records_md5(rd_outs)
        line = {
            "n_samples": n_samples, "region_kb": kb, "n_reads": sim.n_reads, "device": device,
            "half_machine_cores": len(legs.half_a),
            "t1_s": t1, "t2_s": t2, "scaling_efficiency": t1 / (2 * t2),
            "region_sharded": {
                "n_regions": len(legs.regions), "t1_single_host_s": r1, "t2_two_host_s": r2,
                "scaling_efficiency": r1 / (2 * r2), "md5_single": rs_md5, "md5_two_host": rd_md5,
            },
            "sample_sharded": {
                "t1_single_host_s": t1, "t2_two_host_s": t2, "scaling_efficiency": t1 / (2 * t2),
                "md5_single": s_md5, "md5_two_host": d_md5,
            },
        }
        print(json.dumps(line), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if s_md5 != d_md5 or rs_md5 != rd_md5:
        raise SystemExit("bench_distributed: the two processes' VCF differs from the single process's")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
