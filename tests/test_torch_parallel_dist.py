"""The port's cross-process paths in two real processes joined by a gloo
process group at 127.0.0.1, on the CPU device:

- `genotype_distributed` (samples sharded over the hosts), plain and with
  GT_REP_SHARD=1 (the rep-sharded align exchange): host 0's VCF equals the
  JAX package's single-process `genotype` byte for byte (##fileDate
  masked), on tests/parallel/test_distributed_e2e.py's cohort;
- the CLI's `genotype --num_hosts 2 --host_id i --coordinator`: the union
  of the hosts' region VCFs equals the JAX package's single-process CLI;
- a global (host, data) mesh scorer whose host axis spans the group: each
  process applies its half of every flush and the totals are all-reduced,
  equal to the JAX package's call_pool on the same graph and reads.

And in one process: the rep-sharded oracle resolves every row of a pool to
the same state as the plain call, and `local_row_seqs` releases every
prepared-pool entry it takes."""

import gzip
import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest

from graphtyper_tpu import config as ref_config
from graphtyper_tpu.pipeline.genotype import genotype as ref_genotype
from graphtyper_tpu.utils.simulate import SimConfig, simulate_cohort

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/parallel/test_distributed_e2e.py's cohort
E2E = SimConfig(region_length=50_000, coverage=14.0, seed=31, n_samples=4, out_format="bam")
CHILD_TIMEOUT_S = 300

CHILD = r"""
import json, os, sys
rank, port, mode, meta_path, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4], sys.argv[5]
sys.path.insert(0, os.environ["GT_REPO"])
meta = json.load(open(meta_path))
from graphtyper_tpu_torch import counters
from graphtyper_tpu_torch.parallel import distributed
if mode == "cli":
    from graphtyper_tpu_torch import cli
    argv = ["genotype", meta["fasta"], "--region_file", meta["region_file"], "-O", out_dir,
            "--device", "cpu", "--threads", "2", "--num_hosts", "2", "--host_id", str(rank),
            "--coordinator", f"127.0.0.1:{port}", *meta["sams"]]
    assert cli.main(argv) == 0
    print("DONE", rank, json.dumps(counters.totals()))
    sys.exit(0)
distributed.initialize(f"127.0.0.1:{port}", 2, rank)
if mode == "distributed":
    out = distributed.genotype_distributed(meta["fasta"], meta["sams"], meta["region"], out_dir, "cpu")
    print("DONE", rank, out, json.dumps(counters.totals()))
elif mode == "mesh":
    import numpy as np, torch
    from graphtyper_tpu_torch.graph.build import construct_graph
    from graphtyper_tpu_torch.graph.coords import GenomicRegion
    from graphtyper_tpu_torch.index.build import index_graph
    from graphtyper_tpu_torch.pipeline.caller import call_pool
    region = GenomicRegion.parse(meta["region"])
    m = distributed.global_mesh(devices=[torch.device("cpu")] * 2)
    assert m.group is not None and m.devices.shape == (2, 2)
    counters.reset()
    g = construct_graph(meta["fasta"], meta["vcf"], meta["region"], use_index=True)
    sharded = call_pool(g, index_graph(g), meta["sams"], "cpu", region=region, scorer_mesh=m)
    mine = sorted(int(k[len("scoring_rows_shard"):]) for k in counters.COUNTS if k.startswith("scoring_rows_shard"))
    assert mine == [2 * rank, 2 * rank + 1], mine
    want = np.load(meta["want"])
    assert len(sharded.scorer.sites) == int(want["n_sites"])
    for i, b in enumerate(sharded.scorer.sites):
        np.testing.assert_array_equal(want[f"log_scores{i}"], b.log_scores)
        np.testing.assert_array_equal(want[f"gt_coverages{i}"], b.gt_coverages)
        assert int(want["mapq_squared"][i]) == b.var_stats.mapq_squared
    print("DONE", rank, json.dumps(counters.totals()))
distributed.shutdown()
"""


def _masked(path):
    with gzip.open(path, "rt") as f:
        return ["##fileDate=" if line.startswith("##fileDate=") else line for line in f.read().splitlines()]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pair(tmp_path, mode, meta, out_dir, **env_extra):
    """Both ranks as subprocesses; returns their stdouts. A child that fails
    or outlives CHILD_TIMEOUT_S fails the test, and both are killed."""
    meta_path = tmp_path / f"meta_{mode}.json"
    meta_path.write_text(json.dumps(meta))
    child = tmp_path / "child.py"
    child.write_text(CHILD)
    env = dict(os.environ, GT_REPO=REPO, GLOO_SOCKET_IFNAME="lo", **env_extra)
    env.pop("PYTHONPATH", None)
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, str(child), str(r), port, mode, str(meta_path), str(out_dir)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"DONE {r}" in out, f"rank {r} exited {p.returncode}:\n{out[-3000:]}"
    return outs


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_e2e")
    sim = simulate_cohort(str(root / "sim"), E2E)
    region = f"{E2E.chrom}:1-{E2E.region_length}"
    ref_config.set_options(ref_config.DEFAULT_OPTIONS)
    ref = ref_genotype(sim.fasta, sim.sams, region, str(root / "ref"))
    return sim, region, _masked(ref)


@pytest.mark.parametrize("rep_shard", ["0", "1"])
def test_two_process_genotype_distributed_matches_jax(e2e, tmp_path, rep_shard):
    sim, region, want = e2e
    outs = _run_pair(tmp_path, "distributed", {"fasta": sim.fasta, "sams": sim.sams, "region": region},
                     tmp_path / "out", GT_REP_SHARD=rep_shard)
    path = tmp_path / "out" / E2E.chrom / f"{1:09d}-{E2E.region_length:09d}.vcf.gz"
    assert f"DONE 0 {path}" in outs[0] and "DONE 1 None" in outs[1]
    got = _masked(path)
    assert sum(not line.startswith("#") for line in got) > 0
    assert got == want
    assert (tmp_path / "out" / "input_sites" / E2E.chrom).is_dir()
    for out in outs:  # each host scored its own shard
        assert json.loads(out.rsplit("DONE", 1)[1].split(None, 2)[2])["scoring_rows"] > 0


def test_two_process_cli_num_hosts_matches_jax(tmp_path):
    """Two 50 kb regions of a 100 kb cohort, one a host, through the CLI;
    the union of the hosts' outputs is the JAX package's single-process CLI
    output, file for file."""
    cfg = SimConfig(region_length=100_000, coverage=8.0, n_samples=2, seed=33, error_rate=0.01,
                    out_format="bam")
    sim = simulate_cohort(str(tmp_path / "sim"), cfg)
    region_file = tmp_path / "regions.txt"
    region_file.write_text(f"{cfg.chrom}:1-50000\n{cfg.chrom}:50001-100000\n")
    argv = ["-m", "graphtyper_tpu.cli", "genotype", sim.fasta, "--region_file", str(region_file),
            "-O", str(tmp_path / "ref"), "--threads", "1"]
    for s in sim.sams:
        argv += ["--sam", s]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, *argv], cwd=REPO, capture_output=True, text=True, env=env,
                          timeout=CHILD_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref_files = sorted(proc.stdout.split())
    assert len(ref_files) == 2

    outs = _run_pair(tmp_path, "cli", {"fasta": sim.fasta, "sams": sim.sams, "region_file": str(region_file)},
                     tmp_path / "port")
    got = {}
    for out in outs:
        for line in out.splitlines():
            if line.endswith(".vcf.gz"):
                got[os.path.relpath(line, tmp_path / "port")] = _masked(line)
    assert sorted(got) == sorted(os.path.relpath(p, tmp_path / "ref") for p in ref_files)
    for p in ref_files:
        assert got[os.path.relpath(p, tmp_path / "ref")] == _masked(p)


def test_global_mesh_scorer_over_two_processes(tmp_path):
    """Every flush splits over a (host 2, data 2) mesh; each process applies
    its row of entries and the totals are all-reduced over gloo. Both
    processes' site state equals the JAX package's call_pool on the same
    graph and reads."""
    from graphtyper_tpu.graph.build import construct_graph as ref_construct_graph
    from graphtyper_tpu.graph.coords import GenomicRegion as RefRegion
    from graphtyper_tpu.index.build import index_graph as ref_index_graph
    from graphtyper_tpu.pipeline.caller import call_pool as ref_call_pool

    cfg = SimConfig(region_length=4000, coverage=10.0, n_samples=2, seed=47, out_format="bam")
    sim = simulate_cohort(str(tmp_path / "sim"), cfg)
    region = f"{cfg.chrom}:1-{cfg.region_length}"
    ref_config.set_options(ref_config.DEFAULT_OPTIONS)
    g = ref_construct_graph(sim.fasta, sim.vcf, region, use_index=True)
    sites = ref_call_pool(g, ref_index_graph(g), sim.sams, region=RefRegion.parse(region)).scorer.sites
    want = tmp_path / "want.npz"
    arrays = {"n_sites": np.array(len(sites)), "mapq_squared": np.array([s.var_stats.mapq_squared for s in sites])}
    for i, s in enumerate(sites):
        arrays[f"log_scores{i}"] = np.asarray(s.log_scores)
        arrays[f"gt_coverages{i}"] = np.asarray(s.gt_coverages)
    assert any(a.max() > 0 for k, a in arrays.items() if k.startswith("log_scores"))
    np.savez(want, **arrays)
    _run_pair(tmp_path, "mesh", {"fasta": sim.fasta, "vcf": sim.vcf, "sams": sim.sams, "region": region,
                                 "want": str(want)}, tmp_path / "out")


# ---- in one process --------------------------------------------------------


@pytest.fixture(scope="module")
def rep_setup(tmp_path_factory):
    """tests/parallel/test_rep_shard.py's cohort."""
    from graphtyper_tpu_torch.graph.coords import GenomicRegion

    cfg = SimConfig(region_length=20000, coverage=18.0, n_samples=2, seed=77, out_format="bam")
    sim = simulate_cohort(str(tmp_path_factory.mktemp("rep_shard")), cfg)
    region = GenomicRegion.parse(f"{cfg.chrom}:1-{cfg.region_length}")

    def build():
        from graphtyper_tpu_torch.graph.build import construct_graph
        from graphtyper_tpu_torch.index.build import index_graph

        g = construct_graph(sim.fasta, sim.vcf, f"{cfg.chrom}:1-{cfg.region_length}", use_index=True)
        return g, index_graph(g)

    return sim, region, build


def test_oracle_roundtrip_parity(rep_setup):
    """A call whose every row resolves from the oracle (one host aligning
    everything) gives the plain call's state and phasing maps."""
    from graphtyper_tpu_torch.parallel import rep_shard
    from graphtyper_tpu_torch.pipeline.caller import SAM_FLAG_FILTER, call_pool, split_pools

    sim, region, build = rep_setup
    g1, i1 = build()
    base = call_pool(g1, i1, sim.sams, "cpu", region=region)
    g2, i2 = build()
    seqs = rep_shard.local_row_seqs(split_pools(sim.sams), region, SAM_FLAG_FILTER)
    assert len(seqs) > 1000
    oracle = rep_shard.build_oracle(g2, i2, seqs, lambda b: [b], 1, 0)
    shard = call_pool(g2, i2, sim.sams, "cpu", region=region, rep_oracle=oracle)
    assert oracle.n_rows > 0 and oracle.n_resolved == oracle.n_rows
    for a, b in zip(base.scorer.sites, shard.scorer.sites):
        np.testing.assert_array_equal(a.log_scores, b.log_scores)
        np.testing.assert_array_equal(a.gt_coverages, b.gt_coverages)
    assert base.ph == shard.ph


def test_local_row_seqs_releases_every_pin(rep_setup, monkeypatch, tmp_path):
    """More pools than the prepared-pool cache holds: every entry
    `local_row_seqs` takes is released, the cached ones are left unpinned,
    and each evicted one is freed once."""
    from graphtyper_tpu_torch.io.native import get_lib
    from graphtyper_tpu_torch.parallel import rep_shard
    from graphtyper_tpu_torch.pipeline import native_caller as nc
    from graphtyper_tpu_torch.pipeline.caller import SAM_FLAG_FILTER

    sim, region, _ = rep_setup
    lib = get_lib()
    for entry in list(nc._PREP_CACHE.values()):  # start from an empty cache
        entry.cached = False
        if entry.pins == 0:
            entry._free(lib)
    nc._PREP_CACHE.clear()
    made, freed = [], []
    orig_init, orig_free = nc._PrepEntry.__init__, nc._PrepEntry._free

    def init(self, *a, **k):
        orig_init(self, *a, **k)
        made.append(self)

    def free(self, lib_):
        freed.append(self)
        orig_free(self, lib_)

    monkeypatch.setattr(nc._PrepEntry, "__init__", init)
    monkeypatch.setattr(nc._PrepEntry, "_free", free)
    # six pools of one file, over the cache's four entries
    pools = []
    for k in range(3):
        for p in sim.sams:
            pools.append([str(tmp_path / f"copy{k}_{os.path.basename(p)}")])
            shutil.copyfile(p, pools[-1][0])
    mat = rep_shard.local_row_seqs(pools, region, SAM_FLAG_FILTER)
    assert mat.shape[0] > 1000
    assert len(made) == 6 and all(e.pins == 0 for e in made)
    cached = set(map(id, nc._PREP_CACHE.values()))
    assert len(cached) == nc._PREP_CACHE_MAX
    assert sorted(map(id, freed)) == sorted(id(e) for e in made if id(e) not in cached)
    assert len(set(map(id, freed))) == len(freed)
