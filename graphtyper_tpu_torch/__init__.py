"""PyTorch + CUDA port of graphtyper_tpu for one NVIDIA H100.

The port stands alone: it imports nothing of `graphtyper_tpu`. Its
backend-free host layer (io/, graph/, index/, models/, most of typer/ and
utils/) is a copy of the JAX package's, with only the import lines
rewritten. It builds the C++ engine itself from the repository's
native/*.cpp into kernel_build/ (io/native.py). What touches a device is its
own: ops/, the seam modules of typer/ and pipeline/ that call them, and the
hand-written CUDA kernels under csrc/. It never imports jax.

Entry points:
    python -m graphtyper_tpu_torch.cli <subcommand> ...   (all 15 of the JAX
        package's CLI; genotype, genotype_sv, genotype_camou, genotype_hla,
        discover and call run on --device, cuda by default)
    python -m graphtyper_tpu_torch.tools.bench_sw [--row|--rot]
    python -m graphtyper_tpu_torch.tools.bench_sv [--device cpu]
    python -m graphtyper_tpu_torch.tools.fuzz_diff [--device cuda|cpu] [n_seeds] [base]
        (every implementation path of the pipeline against the port's own run)
    python -m graphtyper_tpu_torch.tools.soak_population [--device cuda|cpu] ...
        (a simulated population cohort: wall, tree RSS, md5 of the records)
    python -m graphtyper_tpu_torch.tools.stage_ledger [--device cuda|cpu] ...
        (per-stage host walls and the device-eligible share)
    graphtyper_tpu_torch.entry.entry() / dryrun_multichip(n)   (the fused
        genotype_forward step, and the pipeline with mesh-sharded scoring)

parallel/ runs the port across processes (torch.distributed, gloo:
region sharding, the sample-sharded genotype_distributed, the rep-sharded
align exchange) and across the devices of a mesh (the sharded scoring
apply and genotyping step). The library modules that no subcommand
reaches are copies too: typer/haplotype_extractor, typer/variant_map,
io/crai, io/cram_writer and utils/simulate_indep (the CRAM cohorts of
simulate.py).

Device options of `graphtyper_tpu_torch.config.Options`, as the port reads
them: `device_sw` and `device_discovery` take "auto" and "on" as one value,
the work always going to the device it is given, whatever its size; "off"
keeps the host path. `device_scoring="off"` is refused: the port scores on
its device only. `device_seed="on"` runs the call iterations' 97-probe
seeding on the device (ops/seed_probe.py, csrc/seed_probe.cu), and
`device_align="on"` or `"verify"` (or the GT_DEVICE_ALIGN environment
variable) runs their verdict kernel (ops/device_align.py,
csrc/device_align.cu), in memory and in the streaming caller; both take
non-SV pools only, and "auto" resolves both to off, as in the JAX package.
On `--device cpu` they run the plain PyTorch versions. A kernel that fails
to build or launch raises.

Importing the package makes sure the C++ engine's runtime can load
(host.py).
"""

from graphtyper_tpu_torch.host import ensure_native_runtime as _ensure_native_runtime

_ensure_native_runtime()
