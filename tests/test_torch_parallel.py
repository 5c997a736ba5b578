"""The port's parallel layer in one process on the CPU: meshes of one
device taken n times, against the unsharded computation and the JAX
package's sharded step on its virtual CPU devices (tests/conftest.py); the
mesh-sharded scoring apply through call_pool; the whole pipeline's mesh
dry run; region assignment; host-to-device prefetch."""

import numpy as np
import pytest
import torch

from graphtyper_tpu.parallel import distributed as ref_distributed
from graphtyper_tpu.parallel import mesh as ref_mesh
from graphtyper_tpu_torch.ops.genotype_step import genotype_forward
from graphtyper_tpu_torch.parallel import distributed, mesh, prefetch

CPU = torch.device("cpu")


def _inputs(R, L=64, H=16, A=4, seed=3):
    """tests/parallel/test_mesh.py's inputs."""
    rng = np.random.default_rng(seed)
    haps = rng.integers(0, 4, size=(H, L)).astype(np.uint8)
    reads = haps[rng.integers(0, H, size=R)].copy()
    err = rng.integers(0, L, size=R)
    reads[np.arange(R), err] = rng.integers(0, 4, size=R).astype(np.uint8)
    hap_allele = np.zeros((H, A), dtype=np.float32)
    hap_allele[np.arange(H), rng.integers(0, A, size=H)] = 1.0
    eps = rng.integers(4, 9, size=R).astype(np.float32)
    return reads, haps, hap_allele, eps


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_step_equals_unsharded(n):
    m = mesh.make_mesh(devices=[CPU] * n)
    reads, haps, hap_allele, eps = _inputs(R=16 * n)
    reads_d, eps_d = mesh.shard_reads(m, reads, eps)
    assert [len(r) for r in reads_d] == [16] * n
    delta, depth = mesh.sharded_genotype_step(m)(reads_d, haps, hap_allele, eps_d)
    ref_delta, ref_B = genotype_forward(*(torch.from_numpy(a) for a in (reads, haps, hap_allele, eps)))
    assert torch.equal(delta, ref_delta) and torch.equal(depth, ref_B.sum(dim=0))


def test_shard_reads_pads_like_jax():
    """R = 37 over 8 entries: pad reads of code 5 and eps 0, one contiguous
    shard an entry; delta and depth equal the JAX package's sharded step
    on the same padding."""
    reads, haps, hap_allele, eps = _inputs(R=37)
    m = mesh.make_mesh(8, devices=[CPU] * 8)
    reads_d, eps_d = mesh.shard_reads(m, reads, eps)
    assert [len(r) for r in reads_d] == [5] * 8
    padded = torch.cat(reads_d)
    assert torch.equal(padded[:37], torch.from_numpy(reads)) and bool((padded[37:] == 5).all())
    assert float(torch.cat(eps_d)[37:].abs().sum()) == 0
    delta, depth = mesh.sharded_genotype_step(m)(reads_d, haps, hap_allele, eps_d)

    jm = ref_mesh.make_mesh(8)
    jr, je = ref_mesh.shard_reads(jm, reads, eps)
    ref_delta, ref_depth = ref_mesh.sharded_genotype_step(jm)(jr, haps, hap_allele, je)
    np.testing.assert_array_equal(delta.numpy(), np.asarray(ref_delta))
    np.testing.assert_array_equal(depth.numpy(), np.asarray(ref_depth))


def test_mesh_grid_and_entries():
    m = mesh.Mesh(np.array(["cpu"] * 6, dtype=object).reshape(2, 3), ("host", "data"))
    assert m.size == 6 and m.shape == {"host": 2, "data": 3}
    assert [i for i, _ in m.local_entries()] == list(range(6))  # one process runs the grid
    t = torch.arange(3)
    assert m.host_sum(t) is t
    with pytest.raises(ValueError):
        mesh.Mesh(["cpu"] * 4, ("host", "data"))
    mh = distributed.host_mesh(devices=[CPU] * 3)
    mg = distributed.global_mesh(devices=[CPU] * 3)
    assert mh.axis_names == ("data",) and mh.devices.shape == (3,)
    assert mg.axis_names == ("host", "data") and mg.devices.shape == (1, 3) and mg.group is None


def test_make_mesh_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.global_mesh()


REGIONS = [f"chr1:{i * 50000 + 1}-{(i + 1) * 50000}" for i in range(23)]


@pytest.mark.parametrize("regions,n_hosts", [
    (REGIONS, 4), (REGIONS, 1), (["chr1", "chr2"], 1), (["chr1", "chr2"], 5), (REGIONS[:3], 3), ([], 2),
])
def test_assign_regions(regions, n_hosts):
    """Complete, disjoint, ordered and contiguous shares, sizes within one,
    each equal to the JAX package's."""
    shards = [distributed.assign_regions(regions, n_hosts, h) for h in range(n_hosts)]
    assert sum(shards, []) == list(regions)
    sizes = [len(s) for s in shards]
    assert max(sizes) - min(sizes) <= 1
    assert shards == [ref_distributed.assign_regions(regions, n_hosts, h) for h in range(n_hosts)]


def test_assign_regions_bad_host():
    with pytest.raises(ValueError):
        distributed.assign_regions(["chr1"], 2, 2)


def test_single_process_collectives_are_identities():
    assert distributed.num_hosts() == 1 and distributed.host_id() == 0
    assert distributed._allgather_bytes(b"abc") == [b"abc"]
    d = distributed.DiscoveryDist(5)
    assert (d.lo, d.hi) == (0, 5) and d.allgather({1: 2}) == [{1: 2}]
    assert distributed.DiscoveryDist(5, 2, 1).owns(4) and not distributed.DiscoveryDist(5, 2, 1).owns(1)


# ---- the mesh-sharded scoring apply through call_pool ---------------------


def _site_state(sites):
    """Each site's log scores, genotype coverages and MAPQ sum of squares."""
    return [(np.asarray(s.log_scores), np.asarray(s.gt_coverages), s.var_stats.mapq_squared) for s in sites]


@pytest.fixture(scope="module")
def pool_inputs(tmp_path_factory):
    """tests/parallel/test_mesh.py's native-caller cohort (BAM), and the
    JAX package's call_pool on it: the site state every mesh run is held to."""
    from graphtyper_tpu import config as ref_config
    from graphtyper_tpu.graph.build import construct_graph as ref_construct_graph
    from graphtyper_tpu.index.build import index_graph as ref_index_graph
    from graphtyper_tpu.pipeline.caller import call_pool as ref_call_pool
    from graphtyper_tpu_torch.graph.coords import GenomicRegion
    from graphtyper_tpu_torch.simulate import SimConfig, simulate_cohort

    cfg = SimConfig(region_length=4000, coverage=10.0, n_samples=2, seed=47, out_format="bam")
    sim = simulate_cohort(str(tmp_path_factory.mktemp("mesh_pool")), cfg)
    region_str = f"{cfg.chrom}:1-{cfg.region_length}"
    region = GenomicRegion.parse(region_str)
    ref_config.set_options(ref_config.DEFAULT_OPTIONS)
    g = ref_construct_graph(sim.fasta, sim.vcf, region_str, use_index=True)
    ref = ref_call_pool(g, ref_index_graph(g), sim.sams, region=region)
    return sim, region_str, region, _site_state(ref.scorer.sites)


def _graph(sim, region_str):
    from graphtyper_tpu_torch.graph.build import construct_graph
    from graphtyper_tpu_torch.index.build import index_graph

    g = construct_graph(sim.fasta, sim.vcf, region_str, use_index=True)
    return g, index_graph(g)


@pytest.mark.parametrize("streaming,shape", [("off", (4,)), ("on", (4,)), ("off", (2, 3))])
def test_call_pool_mesh_scorer_equals_unsharded(pool_inputs, monkeypatch, streaming, shape):
    """The rows of every flush split over the mesh's entries and summed: the
    site state of the JAX package's call_pool on the same graph and reads,
    bit for bit, in memory and in the streaming caller; the native path
    received the mesh, and every entry scored rows."""
    from dataclasses import replace

    from graphtyper_tpu_torch import config, counters
    from graphtyper_tpu_torch.pipeline import native_caller as nc
    from graphtyper_tpu_torch.pipeline.caller import call_pool

    sim, region_str, region, want = pool_inputs
    config.set_options(replace(config.DEFAULT_OPTIONS, streaming_caller=streaming))
    try:
        m = mesh.Mesh(np.array([CPU] * int(np.prod(shape)), dtype=object).reshape(shape),
                      ("data",) if len(shape) == 1 else ("host", "data"))
        seen = []
        entry_name = "run_native_call_pool_stream" if streaming == "on" else "run_native_call_pool_bam"
        orig = getattr(nc, entry_name)

        def spy(*args, **kwargs):
            out = orig(*args, **kwargs)
            seen.append((kwargs.get("mesh"), out is not None))
            return out

        monkeypatch.setattr(nc, entry_name, spy)
        counters.reset()
        g, i = _graph(sim, region_str)
        sharded = call_pool(g, i, sim.sams, CPU, region=region, scorer_mesh=m)
        shard_rows = [counters.COUNTS[f"scoring_rows_shard{i}"] for i in range(m.size)]
    finally:
        config.set_options(config.DEFAULT_OPTIONS)
    assert seen == [(m, True)]
    assert sharded.scorer.batcher.mesh is m
    assert min(shard_rows) > 0 and sum(shard_rows) == counters.COUNTS["scoring_rows"]
    got = _site_state(sharded.scorer.sites)
    assert len(got) == len(want)
    n_scored = 0
    for (ls, gc, mq), (ref_ls, ref_gc, ref_mq) in zip(got, want):
        np.testing.assert_array_equal(ls, ref_ls)
        np.testing.assert_array_equal(gc, ref_gc)
        assert mq == ref_mq
        n_scored += int(ls.max() > 0)
    assert n_scored > 0


def _masked(path):
    import gzip

    with gzip.open(path, "rt") as f:
        return ["##fileDate=" if line.startswith("##fileDate=") else line for line in f.read().splitlines()]


def test_dryrun_multichip_on_cpu(tmp_path, capsys):
    """The whole pipeline with its call iterations' scoring over a 2 x 2
    mesh of the CPU: its final VCF and its discovery sites equal the JAX
    package's `genotype` at threads=1 on the same cohort and max_files_open,
    line for line (##fileDate masked). The JAX package's own dry run
    (tests/parallel/test_mesh.py::test_dryrun_entrypoint) fails on this
    machine's thread count, its prepared-pool fault; the port's passes."""
    import os
    from dataclasses import replace

    from graphtyper_tpu import config as ref_config
    from graphtyper_tpu.pipeline.genotype import genotype as ref_genotype
    from graphtyper_tpu_torch.entry import dryrun_multichip

    out = dryrun_multichip(4, device="cpu", out_dir=str(tmp_path / "port"))
    assert out["n_records"] > 0 and len(out["shard_rows"]) == 4 and min(out["shard_rows"]) > 0
    assert "dryrun_multichip OK on 4 mesh entries {'host': 2, 'data': 2}" in capsys.readouterr().out

    ref_config.set_options(replace(ref_config.DEFAULT_OPTIONS, threads=1, max_files_open=3))
    try:
        want = ref_genotype(out["fasta"], out["sams"], out["region"], str(tmp_path / "ref"))
    finally:
        ref_config.set_options(ref_config.DEFAULT_OPTIONS)
    got = _masked(out["vcf"])
    assert sum(not line.startswith("#") for line in got) == out["n_records"]
    assert got == _masked(want)
    ref_sites = os.path.join(tmp_path / "ref", os.path.relpath(out["sites"], tmp_path / "port" / "out_mesh"))
    assert _masked(out["sites"]) == _masked(ref_sites)


# ---- prefetch ---------------------------------------------------------------


def test_prefetch_preserves_order_and_values():
    batches = [{"a": np.full((4,), i, dtype=np.float32), "b": (np.arange(i + 1),)} for i in range(10)]
    out = list(prefetch.prefetch_to_device(iter(batches), size=3, device="cpu"))
    assert len(out) == 10
    for i, o in enumerate(out):
        assert isinstance(o["a"], torch.Tensor) and isinstance(o["b"], tuple)
        np.testing.assert_array_equal(o["a"].numpy(), batches[i]["a"])
        np.testing.assert_array_equal(o["b"][0].numpy(), batches[i]["b"][0])


def test_prefetch_propagates_producer_error():
    def gen():
        yield np.zeros(2, dtype=np.float32)
        raise RuntimeError("decode failed")

    it = prefetch.prefetch_to_device(gen(), size=2, device="cpu")
    np.testing.assert_array_equal(next(it).numpy(), np.zeros(2))
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)


def test_pipelined_map_matches_serial():
    rng = np.random.default_rng(0)
    data = [rng.normal(size=(8, 8)).astype(np.float32) for _ in range(6)]

    def step(x):
        return torch.as_tensor(x).square().sum()

    piped = prefetch.pipelined_map(lambda i: data[i], step, n_batches=6)
    assert [float(a) for a in piped] == [float(step(d)) for d in data]
    tuples = [(np.ones(4, np.float32) * i, np.ones(4, np.float32)) for i in range(4)]
    out = prefetch.pipelined_map(lambda i: tuples[i], lambda x, y: float((x + y).sum()), n_batches=4)
    assert out == [4.0, 8.0, 12.0, 16.0]


def test_pipelined_map_raises_decode_error():
    def decode(i):
        if i == 2:
            raise ValueError("bad batch")
        return np.zeros(1)

    with pytest.raises(ValueError, match="bad batch"):
        prefetch.pipelined_map(decode, lambda x: x, n_batches=4)
