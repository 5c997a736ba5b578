"""The port stands alone and never hides the device: a whole CLI `genotype`
run, and CLI `genotype_sv`, `genotype_camou` and `genotype_hla` runs, leave
jax and the JAX package out of sys.modules, no source of the port imports
either, every import of the port resolves inside it, the C++ engine it
loads is its own build, every device subcommand of the CLI refuses to run
without a GPU unless told `--device cpu`, no orchestration module wraps a
device seam in a try/except, and a non-CPU tensor whose kernel cannot be
built raises."""

import ast
import os
import pathlib
import re
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "graphtyper_tpu_torch"

# modules of the JAX package that import jax at module level
JAX_MODULES = (
    "graphtyper_tpu.ops.sw_rot", "graphtyper_tpu.ops.sw_pallas", "graphtyper_tpu.ops.seed_probe",
    "graphtyper_tpu.ops.device_align", "graphtyper_tpu.ops.hamming", "graphtyper_tpu.ops.likelihood",
    "graphtyper_tpu.ops.genotype_step", "graphtyper_tpu.utils.jax_cache", "graphtyper_tpu.parallel",
)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """A CLI `genotype` run on the CPU device in a fresh process, started
    with the port's own simulator; (its stdout, its output directory)."""
    tmp_path = tmp_path_factory.mktemp("no_jax")
    script = textwrap.dedent(
        f"""
        import sys
        sys.path.insert(0, {str(REPO)!r})
        from graphtyper_tpu_torch.simulate import SimConfig, simulate_cohort
        from graphtyper_tpu_torch import cli, counters
        cfg = SimConfig(region_length=8000, coverage=12, n_samples=2, error_rate=0.005,
                        out_format="bam", seed=3)
        sim = simulate_cohort({str(tmp_path / "sim")!r}, cfg)
        argv = ["genotype", sim.fasta, "--region", f"{{cfg.chrom}}:1-{{cfg.region_length}}",
                "-O", {str(tmp_path / "out")!r}, "--device", "cpu", "--threads", "1"]
        for s in sim.sams:
            argv += ["--sam", s]
        rc = cli.main(argv)
        assert rc == 0, rc
        assert counters.totals().get("scoring_rows", 0) > 0
        print("JAX_LOADED", "jax" in sys.modules,
              sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")))
        print("JAX_PACKAGE_LOADED",
              sorted(m for m in sys.modules if m.split(".")[0] == "graphtyper_tpu"))
        from graphtyper_tpu_torch.io import native
        print("ENGINE", native.get_lib()._name)
        """
    )
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH",)}
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout, tmp_path / "out"


def test_cli_genotype_run_never_imports_jax(cli_run):
    out, out_dir = cli_run
    assert "JAX_LOADED False []" in out, out[-2000:]
    assert list(out_dir.rglob("*.vcf.gz"))


def test_cli_genotype_run_never_imports_jax_package(cli_run):
    """After the same run, no module of the JAX package is loaded, and the
    engine that the port loaded is the one it built into kernel_build/."""
    out, _ = cli_run
    assert "JAX_PACKAGE_LOADED []" in out, out[-2000:]
    engine = pathlib.Path(out.split("ENGINE ", 1)[1].split()[0])
    assert engine.parent == REPO / "kernel_build", engine
    assert engine.name.startswith("gt_native-") and engine.is_file()


IMPORT_OF_JAX_PACKAGE = re.compile(r"^\s*(from|import)\s+graphtyper_tpu(\.|\s|$)", re.M)


def _port_sources():
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_sources_import_no_jax_package():
    offenders = [f"{p.relative_to(REPO)}: {m.group(0).strip()}"
                 for p in _port_sources() for m in IMPORT_OF_JAX_PACKAGE.finditer(p.read_text())]
    assert not offenders, offenders


def test_port_imports_resolve_inside_the_port():
    """Every `graphtyper_tpu_torch.*` import of the port (module level or in a
    function) names a module file of the package, or a name that the
    module it is imported from defines."""
    unresolved = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [(a.name, None) for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [(node.module, a.name) for a in node.names]
            else:
                continue
            for module, name in names:
                if module.split(".")[0] != PKG.name:
                    continue
                base = REPO.joinpath(*module.split("."))
                mod_file = base.with_suffix(".py") if base.with_suffix(".py").is_file() else base / "__init__.py"
                if not mod_file.is_file():
                    unresolved.append(f"{path.relative_to(REPO)}:{node.lineno}: {module}")
                    continue
                if name is None or name == "*":
                    continue
                sub = base / name
                if sub.with_suffix(".py").is_file() or (sub / "__init__.py").is_file():
                    continue
                defined = {n.id for n in ast.walk(ast.parse(mod_file.read_text()))
                           if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)}
                for n in ast.walk(ast.parse(mod_file.read_text())):
                    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                        defined.add(n.name)
                    elif isinstance(n, (ast.Import, ast.ImportFrom)):
                        defined.update((a.asname or a.name).split(".")[0] for a in n.names)
                if name not in defined:
                    unresolved.append(f"{path.relative_to(REPO)}:{node.lineno}: {module}.{name}")
    assert not unresolved, unresolved


def test_package_sources_import_no_jax():
    pattern = re.compile(
        r"^\s*(import\s+jax\b|from\s+jax\b|"
        + r"(from|import)\s+(" + "|".join(re.escape(m) for m in JAX_MODULES) + r")\b)",
        re.M,
    )
    offenders = []
    for path in PKG.rglob("*.py"):
        for m in pattern.finditer(path.read_text()):
            offenders.append(f"{path.relative_to(REPO)}: {m.group(0).strip()}")
    assert not offenders, offenders
    assert len(list(PKG.rglob("*.py"))) >= 15


def test_cli_default_device_requires_cuda(monkeypatch, tmp_path):
    from graphtyper_tpu_torch import cli
    from graphtyper_tpu_torch.config import DEFAULT_OPTIONS, set_options

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            cli.main(["genotype", "ref.fa", "--sam", "a.bam", "-O", str(tmp_path)])
    finally:
        set_options(DEFAULT_OPTIONS)
    assert not list(tmp_path.iterdir())  # failed before doing any work


def test_resolve_device():
    from graphtyper_tpu_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_failed_kernel_build_raises(monkeypatch, tmp_path):
    """A tensor off the CPU takes the kernel route; with no nvcc the build
    fails and the call raises instead of running the plain version. This
    host has no CUDA tensors, so meta tensors stand in for them."""
    from graphtyper_tpu_torch import counters, kernels
    from graphtyper_tpu_torch.ops.sw_rot import sw_align_rot

    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path / "empty_bin"))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "kernel_build")
    monkeypatch.setattr(kernels, "_LIB", None)
    q = torch.zeros((4, 8), dtype=torch.uint8, device="meta")
    d = torch.zeros((4, 16), dtype=torch.uint8, device="meta")
    ln = torch.zeros(4, dtype=torch.int32, device="meta")
    plain_before = counters.COUNTS["sw_plain"]
    with pytest.raises(RuntimeError, match="nvcc not found"):
        sw_align_rot(q, ln, d, ln)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.load()
    assert counters.COUNTS["sw_plain"] == plain_before
    assert not (tmp_path / "kernel_build").exists()


# the modules of the call iterations' device-resident align stage, and the
# calls there that build or launch a kernel or lead to one
ALIGN_STAGE = ("ops/device_align.py", "ops/seed_probe.py", "pipeline/native_caller.py", "kernels.py")
LAUNCHING_CALLS = {
    "gt_device_align", "gt_seed_probe", "kernels.load", "launch", "verdicts", "verdicts_async", "wait",
    "probe_bits", "DeviceAligner", "DeviceSeeder", "_device_aligner", "_device_align_verdicts",
    "_device_seed_words", "do_stage", "stage_kmers", "stage_tails",
}


def test_align_stage_hides_no_device_failure():
    """The align stage's modules are among the scanned sources above; none
    of them wraps a kernel build, a launch or a hook that leads to one in a
    try/except (the JAX package catches every exception there and aligns on
    the host), and the hooks no longer refuse with NotImplementedError."""
    paths = [PKG / p for p in ALIGN_STAGE]
    assert set(paths) <= set(_port_sources())
    offenders = []
    for path in paths:
        src = path.read_text()
        assert "_refuse_device_hooks" not in src and "NotImplementedError" not in src, path
        for node in ast.walk(ast.parse(src)):
            if not (isinstance(node, ast.Try) and node.handlers):
                continue
            for inner in (n for stmt in node.body for n in ast.walk(stmt)):
                if isinstance(inner, ast.Call):
                    f = inner.func
                    name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")
                    owner = getattr(getattr(f, "value", None), "id", "")
                    if name in LAUNCHING_CALLS or f"{owner}.{name}" in LAUNCHING_CALLS:
                        offenders.append(f"{path.relative_to(REPO)}:{inner.lineno}: {name}")
    assert not offenders, offenders


def test_cli_device_align_on_requires_cuda(monkeypatch, tmp_path):
    """GT_DEVICE_ALIGN=on does not let the CLI run without a GPU: it asks
    for cuda unless told --device cpu."""
    from graphtyper_tpu_torch import cli
    from graphtyper_tpu_torch.config import DEFAULT_OPTIONS, set_options

    monkeypatch.setenv("GT_DEVICE_ALIGN", "on")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            cli.main(["genotype", "ref.fa", "--sam", "a.bam", "-O", str(tmp_path)])
    finally:
        set_options(DEFAULT_OPTIONS)
    assert not list(tmp_path.iterdir())


@pytest.fixture(scope="module")
def subcommand_runs(tmp_path_factory):
    """CLI genotype_sv, genotype_camou and genotype_hla runs on the CPU device
    in one fresh process, on inputs made by the port's SV cohort builder,
    its simulator and tests/test_torch_subcommand_data.py; its stdout."""
    tmp = tmp_path_factory.mktemp("no_jax_subcommands")
    script = textwrap.dedent(
        f"""
        import os, sys
        sys.path.insert(0, {str(REPO)!r})
        sys.path.append({str(REPO / "tests")!r})
        from graphtyper_tpu_torch import cli
        from graphtyper_tpu_torch.simulate import SimConfig, simulate_cohort
        from graphtyper_tpu_torch.tools.bench_sv import build_cohort
        from test_torch_subcommand_data import build_imgt_panel, write_pair_sam
        tmp = {str(tmp)!r}
        sv = build_cohort(os.path.join(tmp, "sv"), kb=40, samples=2, coverage=4.0)
        assert cli.main(["genotype_sv", sv.fasta, sv.sv_vcf, "--region", sv.region, "-O",
                         os.path.join(tmp, "sv_out"), "--device", "cpu", *[f"--sam={{b}}" for b in sv.bams]]) == 0
        cfg = SimConfig(region_length=6000, coverage=12.0, seed=17, out_format="bam")
        sim = simulate_cohort(os.path.join(tmp, "camou"), cfg)
        bed = os.path.join(tmp, "camou.bed")
        open(bed, "w").write(f"{{cfg.chrom}}\\t1000\\t5000\\n")
        assert cli.main(["genotype_camou", sim.fasta, bed, "-O", os.path.join(tmp, "camou_out"),
                         "--device", "cpu", *[f"--sam={{s}}" for s in sim.sams]]) == 0
        p = build_imgt_panel(os.path.join(tmp, "hla"), n_families=2, per_family=3)
        names = sorted(p["carried"])
        sam = write_pair_sam(os.path.join(tmp, "hla", "s.sam"), "s", p["haps"][names[0]],
                             p["haps"][names[4]], 5, n_pairs=300)
        assert cli.main(["genotype_hla", p["fasta"], p["hla_vcf"], "--region", "chr6:1-12000",
                         "--segment_fasta", p["panel"], "-O", os.path.join(tmp, "hla_out"),
                         "--device", "cpu", "--sam", sam]) == 0
        print("LOADED", sorted(m for m in sys.modules
                               if m.split(".")[0] in ("jax", "graphtyper_tpu")))
        """
    )
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH",)}
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout, tmp


def test_cli_subcommand_runs_never_import_jax(subcommand_runs):
    out, tmp = subcommand_runs
    assert "LOADED []" in out, out[-2000:]
    for pattern in ("sv_out/*.vcf.gz", "camou_out/*/*.camou.vcf.gz", "hla_out/*/*.hla.vcf.gz",
                    "hla_out/*/*.segments.vcf.gz"):
        assert list(tmp.glob(pattern)), pattern


@pytest.mark.parametrize("argv", [
    ["genotype_sv", "ref.fa", "sv.vcf", "--sam", "a.bam"],
    ["genotype_camou", "ref.fa", "intervals.bed", "--sam", "a.bam"],
    ["genotype_hla", "ref.fa", "hla.vcf", "--sam", "a.bam"],
    ["discover", "ref.fa", "--sam", "a.bam"],
    ["call", "graph.npz", "--sam", "a.bam"],
])
def test_device_subcommands_require_cuda(monkeypatch, tmp_path, argv):
    """Every device subcommand asks for cuda by default and raises before
    any work on a machine without a GPU."""
    from graphtyper_tpu_torch import cli
    from graphtyper_tpu_torch.config import DEFAULT_OPTIONS, set_options

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            cli.main([*argv, "-O", str(tmp_path / "out")])
    finally:
        set_options(DEFAULT_OPTIONS)
    assert not list(tmp_path.iterdir())


# the modules this slice added or forked, and the calls in them that reach a
# device (besides any name they import from the port's ops/)
SUBCOMMAND_MODULES = (
    "cli.py", "pipeline/genotype.py", "pipeline/genotype_camou.py", "pipeline/genotype_hla.py",
    "pipeline/genotype_lr.py", "pipeline/vcf_tools.py", "typer/hla.py", "typer/segment_calling.py",
    "typer/discovery_lr.py", "tools/bench_sv.py",
)
DEVICE_SEAMS = {
    "call_pool", "call_pools", "streamlined_discovery", "genotype", "genotype_regions",
    "genotype_only_with_a_vcf", "genotype_sv", "genotype_camou", "genotype_hla", "resolve_device",
    "_genotype_camou_body", "_genotype_hla_body",
}


def _hidden_seams(modules, device_seams):
    """Calls of a device seam, or of a name imported from the port's ops/,
    inside the body of a try/except of these modules."""
    offenders = []
    for rel in modules:
        path = PKG / rel
        tree = ast.parse(path.read_text())
        seams = set(device_seams)
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and (node.module or "").startswith(f"{PKG.name}.ops"):
                seams.update(a.asname or a.name for a in node.names)
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Try) and node.handlers):
                continue
            for inner in (n for stmt in node.body for n in ast.walk(stmt)):
                if isinstance(inner, ast.Call):
                    f = inner.func
                    name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")
                    if name in seams:
                        offenders.append(f"{rel}:{inner.lineno}: {name}")
    return offenders


def test_subcommand_modules_hide_no_device_failure():
    """No try/except in these modules has a device seam, or a name imported
    from the port's ops/, called in its body."""
    offenders = _hidden_seams(SUBCOMMAND_MODULES, DEVICE_SEAMS)
    assert not offenders, offenders


# the parallel layer and the fused step, and the calls in them that reach a
# device or a peer process
PARALLEL_MODULES = (
    "parallel/__init__.py", "parallel/distributed.py", "parallel/mesh.py", "parallel/prefetch.py",
    "parallel/rep_shard.py", "ops/hamming.py", "ops/likelihood.py", "ops/genotype_step.py", "entry.py",
)
PARALLEL_SEAMS = DEVICE_SEAMS | {
    "genotype_forward", "mismatch_matrix", "_int_mm", "apply_tier", "apply_tier_sharded",
    "genotype_distributed", "genotype_regions_distributed", "init_process_group", "all_gather",
    "all_reduce", "host_sum", "local_row_seqs", "build_oracle", "align_rows_raw", "dryrun_multichip",
}


def test_parallel_modules_hide_no_device_failure():
    """No try/except of the parallel layer or the fused step wraps a device
    seam or a collective: a failed card, kernel or peer raises."""
    assert all((PKG / rel).is_file() for rel in PARALLEL_MODULES)
    offenders = _hidden_seams(PARALLEL_MODULES, PARALLEL_SEAMS)
    assert not offenders, offenders


def test_parallel_layer_runs_without_jax():
    """The fused step, a sharded step over a mesh of the CPU taken twice,
    the prefetch and the rep-shard helpers run in a fresh process that never
    loads jax or the JAX package."""
    script = textwrap.dedent(
        f"""
        import sys
        sys.path.insert(0, {str(REPO)!r})
        import numpy as np, torch
        from graphtyper_tpu_torch import entry
        from graphtyper_tpu_torch.parallel import distributed, mesh, prefetch, rep_shard
        fn, args = entry.entry("cpu")
        delta, B = fn(*args)
        m = mesh.make_mesh(devices=["cpu"] * 2)
        reads, haps, hap_allele, eps = (a.numpy() for a in args)
        reads_d, eps_d = mesh.shard_reads(m, reads, eps)
        d2, depth = mesh.sharded_genotype_step(m)(reads_d, haps, hap_allele, eps_d)
        assert torch.equal(d2, delta) and torch.equal(depth, B.sum(0))
        assert [int(t) for t in prefetch.prefetch_to_device(iter([np.int64(1), np.int64(2)]), device="cpu")] == [1, 2]
        assert distributed.num_hosts() == 1 and rep_shard._digest_rows([b"ACGT"]).shape == (1, 16)
        print("LOADED", sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "graphtyper_tpu")))
        """
    )
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH",)}
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "LOADED []" in proc.stdout, proc.stdout[-2000:]
