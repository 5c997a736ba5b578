"""The port's C++ engine runtime: the engine that io/native.py builds from
native/*.cpp, and the zlib stand-in for libdeflate.so.0
(graphtyper_tpu_torch/host.py) that hosts without libdeflate need to load
it. Forced in a subprocess in place of the system library, the port's
engine must load against it and the port's genotype path must write the VCF
contents of the JAX package."""

import gzip
import hashlib
import json
import pathlib
import subprocess
import sys
import textwrap

import pytest

from graphtyper_tpu.config import DEFAULT_OPTIONS, set_options
from graphtyper_tpu.pipeline.genotype import genotype_regions
from graphtyper_tpu.utils.simulate import SimConfig, simulate_cohort

REPO = pathlib.Path(__file__).resolve().parent.parent


def _md5(paths):
    h = hashlib.md5()
    for p in sorted(paths):
        with gzip.open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def test_engine_runs_on_zlib_shim(tmp_path):
    cfg = SimConfig(region_length=12_000, coverage=12, n_samples=2, error_rate=0.005,
                    out_format="bam", seed=4)
    sim = simulate_cohort(str(tmp_path / "sim"), cfg)
    region = f"{cfg.chrom}:1-{cfg.region_length}"
    set_options(DEFAULT_OPTIONS)
    try:
        want = _md5(genotype_regions(sim.fasta, sim.sams, region, str(tmp_path / "lib"), processes=1))
    finally:
        set_options(DEFAULT_OPTIONS)

    script = textwrap.dedent(
        f"""
        import json, sys, types
        sys.path.insert(0, {str(REPO)!r})
        # the package's import would load the system libdeflate.so.0 first:
        # register the package bare so host.py can put the stand-in in its place
        pkg = types.ModuleType("graphtyper_tpu_torch")
        pkg.__path__ = [{str(REPO / "graphtyper_tpu_torch")!r}]
        sys.modules["graphtyper_tpu_torch"] = pkg
        from graphtyper_tpu_torch.host import ensure_native_runtime
        shim = ensure_native_runtime(build_dir={str(tmp_path / "build")!r}, force_shim=True)
        from graphtyper_tpu_torch.io.native import get_lib
        assert get_lib() is not None
        maps = open("/proc/self/maps").read()
        from graphtyper_tpu_torch.pipeline.genotype import genotype_regions
        outs = genotype_regions({sim.fasta!r}, {sim.sams!r}, {region!r}, {str(tmp_path / "shim")!r},
                                "cpu", processes=1)
        print(json.dumps({{"shim_mapped": shim in maps,
                           "system_mapped": any("libdeflate.so" in l and shim not in l
                                                for l in maps.splitlines()),
                           "outs": outs}}))
        """
    )
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["shim_mapped"] and not got["system_mapped"], got
    assert _md5(got["outs"]) == want


def test_engine_build_raises_without_sources(monkeypatch, tmp_path):
    """The port builds its engine from native/*.cpp or raises; it never
    looks for a prebuilt binary."""
    from graphtyper_tpu_torch.io import native

    monkeypatch.setattr(native, "NATIVE_DIR", tmp_path / "no_native")
    with pytest.raises(RuntimeError, match="sources are missing"):
        native.engine_path(tmp_path / "build")
    assert not (tmp_path / "build").exists()


def test_engine_links_libdeflate_by_soname():
    """The engine's DT_NEEDED entry is libdeflate.so.0, whichever library
    host.py loads under that name."""
    from graphtyper_tpu_torch.io.native import engine_path

    proc = subprocess.run(["readelf", "-d", str(engine_path())], capture_output=True, text=True)
    if proc.returncode != 0:
        proc = subprocess.run(["objdump", "-p", str(engine_path())], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    needed = [line for line in proc.stdout.splitlines() if "NEEDED" in line]
    assert any("libdeflate.so.0" in line for line in needed), needed
    assert not any("libdeflate_zlib" in line for line in needed), needed
