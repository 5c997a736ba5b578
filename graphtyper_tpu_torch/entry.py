"""Entry points of the port's fused step and of its multi-device pipeline
check (the counterparts of the repository's __graft_entry__.py).

entry(device)                -> (genotype_forward, example tensors on device)
dryrun_multichip(n, device)  -> the whole `genotype` pipeline with every call
                                iteration's scoring over an n-entry mesh,
                                held to the single-device run record for
                                record; then the fused step over the same
                                mesh against the unsharded step.

One card stands in for n entries by taking each of them (cuda:0 four times
as a 2 x 2 mesh); so does the CPU with device="cpu".
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["dryrun_multichip", "entry", "example_inputs"]


def example_inputs(R=256, L=160, H=64, A=8, seed=0):
    """Reads [R, L] uint8 sampled from H haplotype windows with ~2 errors
    each, the windows, their allele assignment [H, A] and integer eps [R],
    from the same seeded generator as __graft_entry__._example_inputs."""
    rng = np.random.default_rng(seed)
    haps = rng.integers(0, 4, size=(H, L)).astype(np.uint8)
    src = rng.integers(0, H, size=R)
    reads = haps[src].copy()
    err_pos = rng.integers(0, L, size=(R, 2))
    for k in range(2):
        reads[np.arange(R), err_pos[:, k]] = rng.integers(0, 4, size=R).astype(np.uint8)
    hap_allele = np.zeros((H, A), dtype=np.float32)
    hap_allele[np.arange(H), rng.integers(0, A, size=H)] = 1.0
    eps = rng.integers(4, 9, size=R).astype(np.float32)
    return reads, haps, hap_allele, eps


def entry(device: torch.device | str = "cuda"):
    """(genotype_forward, its example arguments as tensors on `device`)."""
    from graphtyper_tpu_torch.device import resolve_device
    from graphtyper_tpu_torch.ops.genotype_step import genotype_forward

    dev = resolve_device(device)
    return genotype_forward, tuple(torch.from_numpy(a).to(dev) for a in example_inputs())


def _mesh_of(n_devices: int, device: torch.device):
    """n entries over `device` (cuda: the card's peers in turn), shaped
    (host 2, data n/2) when n is even and at least 4, else (data n)."""
    from graphtyper_tpu_torch.parallel.mesh import Mesh

    if device.type == "cuda":
        cards = min(n_devices, torch.cuda.device_count())
        devices = [torch.device("cuda", i % cards) for i in range(n_devices)]
    else:
        devices = [device] * n_devices
    if n_devices % 2 == 0 and n_devices >= 4:
        return Mesh(np.array(devices, dtype=object).reshape(2, -1), ("host", "data"))
    return Mesh(devices, ("data",))


def dryrun_multichip(n_devices: int, device: torch.device | str = "cuda", out_dir: str | None = None) -> dict:
    """Run the whole `genotype` pipeline (discovery, two call iterations,
    merge and decompose) on the 8-sample, 50 kb, 20x cohort of seed 41 with
    max_files_open 3, once on `device` and once with every call iteration's
    scoring over an n-entry mesh; the record lines of the final VCFs and of
    the discovery iteration's sites VCFs must be equal. Then the fused step
    over the same mesh against the unsharded step, exactly. Returns the
    record count, the scoring rows of each mesh shard and the step's delta
    shape (graphtyper_tpu: __graft_entry__.py:56). With `out_dir` the
    cohort and both runs' outputs stay there, and the result also names the
    cohort (fasta, sams, region) and the mesh run's VCF and sites VCF."""
    import gzip
    import os
    import shutil
    import tempfile
    from dataclasses import replace

    from graphtyper_tpu_torch import counters
    from graphtyper_tpu_torch.config import current_options, set_options
    from graphtyper_tpu_torch.device import resolve_device
    from graphtyper_tpu_torch.ops.genotype_step import genotype_forward
    from graphtyper_tpu_torch.parallel.mesh import shard_reads, sharded_genotype_step
    from graphtyper_tpu_torch.pipeline.genotype import genotype
    from graphtyper_tpu_torch.simulate import SimConfig, simulate_cohort

    dev = resolve_device(device)
    mesh = _mesh_of(n_devices, dev)
    cfg = SimConfig(region_length=50_000, coverage=20.0, n_samples=8, seed=41)
    tmp = out_dir or tempfile.mkdtemp(prefix="gt_dryrun_")
    try:
        sim = simulate_cohort(tmp, cfg)
        region_str = f"{cfg.chrom}:1-{cfg.region_length}"
        base_opts = current_options()
        set_options(replace(base_opts, max_files_open=3))  # a pool split and merge
        try:
            out_single = genotype(sim.fasta, sim.sams, region_str, os.path.join(tmp, "out_single"), dev)
            before = counters.totals()
            out_mesh = genotype(sim.fasta, sim.sams, region_str, os.path.join(tmp, "out_mesh"), dev,
                                scorer_mesh=mesh)
            after = counters.totals()
        finally:
            set_options(base_opts)

        def _lines(p: str) -> list[bytes]:
            with gzip.open(p, "rb") as f:
                return [line for line in f if not line.startswith(b"#")]

        def _sites(out: str) -> str:
            root = os.path.join(os.path.dirname(os.path.dirname(out)), "input_sites")
            hits = sorted(os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs if f.endswith(".vcf.gz"))
            if not hits:
                raise AssertionError(f"no sites VCF under {root}")
            return hits[0]

        rec_single, rec_mesh = _lines(out_single), _lines(out_mesh)
        if rec_single != rec_mesh:
            raise AssertionError(f"mesh pipeline diverged: {len(rec_single)} vs {len(rec_mesh)} records")
        if not rec_single:
            raise AssertionError("dryrun workload produced no variant records")
        if _lines(_sites(out_single)) != _lines(_sites(out_mesh)):
            raise AssertionError("the mesh run's discovery sites differ")
        files = dict(fasta=sim.fasta, sams=list(sim.sams), region=region_str, vcf=out_mesh,
                     sites=_sites(out_mesh))
    finally:
        if out_dir is None:
            shutil.rmtree(tmp, ignore_errors=True)
    shard_rows = [after.get(f"scoring_rows_shard{i}", 0) - before.get(f"scoring_rows_shard{i}", 0)
                  for i in range(mesh.size)]
    if min(shard_rows) <= 0:
        raise AssertionError(f"a mesh entry scored no rows: {shard_rows}")

    # the fused step over the same mesh
    step = sharded_genotype_step(mesh)
    reads, haps, hap_allele, eps = example_inputs(R=16 * n_devices, L=64, H=16, A=4)
    reads_d, eps_d = shard_reads(mesh, reads, eps)
    delta, depth = step(reads_d, haps, hap_allele, eps_d)
    ref_delta, ref_B = genotype_forward(*(torch.from_numpy(a).to(dev) for a in (reads, haps, hap_allele, eps)))
    if not (torch.equal(delta, ref_delta) and torch.equal(depth, ref_B.sum(dim=0))):
        raise AssertionError("sharded genotype step differs from the unsharded step")
    print(
        f"dryrun_multichip OK on {n_devices} mesh entries {dict(mesh.shape)} of {dev}: genotype with "
        f"mesh-sharded scoring equals the single-device run, {len(rec_single)} records at "
        f"{cfg.coverage:.0f}x, {cfg.n_samples} samples; scoring rows per shard {shard_rows}; "
        f"step delta {tuple(delta.shape)}",
        flush=True,
    )
    out = dict(n_records=len(rec_single), shard_rows=shard_rows, delta_shape=tuple(delta.shape))
    if out_dir is not None:
        out.update(files)
    return out


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry OK:", [tuple(o.shape) for o in out])
