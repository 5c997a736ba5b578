"""The port's measurement tools (graphtyper_tpu_torch/tools/) on the CPU
device; bench_flush, bench_lr and bench_distributed each held to its JAX
original at a small size:

- bench_flush: `synth_rows` draws the JAX tool's rows; the port's
  `apply_tier` on the CPU equals the JAX package's `_apply_rows_numpy`;
- bench_lr: `sim_lr` writes the JAX tool's FASTA and BAM records, and the
  port's `genotype_lr` writes the JAX package's VCF;
- bench_distributed: two gloo ranks write the single process's VCF, in
  both modes, each leg run once (the warm-up and the repeats reuse it);
- each tool with a device asks for cuda by default and raises without a
  card; no tool imports jax or the JAX package or catches an exception.

Every compared value is an integer, a string or bytes: the tolerance is 0.
The JAX tools' output keys are read from their sources."""

import ast
import gzip
import hashlib
import importlib.util
import json
import pathlib
import re

import numpy as np
import pytest
import torch

from graphtyper_tpu.ops import site_scoring as ref_ss
from graphtyper_tpu.pipeline.genotype_lr import genotype_lr as ref_genotype_lr
from graphtyper_tpu_torch.io.bam import read_alignments
from graphtyper_tpu_torch.ops.site_scoring import obs_matrix
from graphtyper_tpu_torch.pipeline.genotype_lr import genotype_lr
from graphtyper_tpu_torch.tools import bench_align, bench_distributed, bench_flush, bench_lr, bench_sv, bench_sw

REPO = pathlib.Path(__file__).resolve().parent.parent
TOOLS = ("bench_flush", "bench_lr", "bench_distributed", "bench_sw", "bench_sv", "bench_align", "bench_scoring")


def _jax_tool(rel: str):
    """A JAX tool module loaded from its path (tools/ is no package)."""
    spec = importlib.util.spec_from_file_location("jax_" + pathlib.Path(rel).stem, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dict_keys(rel: str, marker: str) -> set:
    """Keys of the first dict literal in the JAX source `rel` with the key
    `marker`, and of the dict literals nested in it."""
    for node in ast.walk(ast.parse((REPO / rel).read_text())):
        if isinstance(node, ast.Dict) and any(isinstance(k, ast.Constant) and k.value == marker
                                              for k in node.keys):
            keys = set()
            for k, v in zip(node.keys, node.values):
                keys.add(k.value)
                if isinstance(v, ast.Dict):
                    keys |= {f"{k.value}.{kk.value}" for kk in v.keys}
            return keys
    raise AssertionError(f"no dict with {marker!r} in {rel}")


def _flat_keys(d: dict) -> set:
    keys = set(d)
    for k, v in d.items():
        if isinstance(v, dict):
            keys |= {f"{k}.{kk}" for kk in v}
    return keys


def _md5_vcfs(paths) -> str:
    """md5 of the VCFs in path order without their ##fileDate line."""
    h = hashlib.md5()
    for p in sorted(paths):
        with gzip.open(p, "rb") as f:
            for line in f:
                if not line.startswith(b"##fileDate"):
                    h.update(line)
    return h.hexdigest()


# ---- bench_flush -------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
def test_synth_rows_equal_jax_tool(seed):
    want = _jax_tool("tools/bench_flush.py").synth_rows(4096, 2, 512, 50, seed=seed)
    got = bench_flush.synth_rows(4096, 2, 512, 50, seed=seed)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("A", [2, 8])
def test_apply_tier_on_cpu_equals_jax_numpy_apply(A):
    n, n_sites, n_samples = 4096, 512, 50
    cols = bench_flush.synth_rows(n, A, n_sites, n_samples, seed=3)
    want = ref_ss._apply_rows_numpy(cols, n, A, n_sites, n_samples)
    got = bench_flush.flush(torch.from_numpy(obs_matrix(cols, n)), A, n_sites, n_samples, torch.device("cpu"))
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], np.asarray(want[k]).astype(np.int64)), k
    assert int(got["log_delta"].sum()) != 0


def test_bench_flush_cpu_line_has_jax_keys(capsys):
    assert bench_flush.main(["--device", "cpu", "--rows", "4096", "--samples", "4"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert _dict_keys("tools/bench_flush.py", "rows") <= set(line)
    assert line["rows"] == 4096 and line["chunks"] == 1 and line["device"] == "cpu"
    assert line["h2d_mb"] == 14 * 4 * 4096 / 1e6 and line["device_ms_steady"] is None


# ---- bench_lr ----------------------------------------------------------------

@pytest.fixture(scope="module")
def lr_cohorts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lr")
    (tmp / "port").mkdir()
    (tmp / "jax").mkdir()
    got = bench_lr.sim_lr(str(tmp / "port"), 20, 2, 20.0, 3)
    want = _jax_tool("tools/bench_lr.py").sim_lr(str(tmp / "jax"), 20, 2, 20.0, 3)
    return tmp, got, want


def _records(bam: str) -> list:
    header, reads = read_alignments(bam, parse_tags=True)
    return [header.text] + [(r.name, r.flag, r.ref_id, r.pos, r.mapq, r.cigar, r.mate_ref_id, r.mate_pos, r.tlen,
                             r.seq, r.qual.tobytes(), r.tags) for r in reads]


def test_sim_lr_equals_jax_tool(lr_cohorts):
    _tmp, got, want = lr_cohorts
    assert got[2:] == want[2:]  # region, bases, SNPs
    assert pathlib.Path(got[0]).read_bytes() == pathlib.Path(want[0]).read_bytes()
    assert len(got[1]) == len(want[1]) == 2
    for g, w in zip(got[1], want[1]):
        assert _records(g) == _records(w)


def test_genotype_lr_vcf_equals_jax(lr_cohorts):
    tmp, got, want = lr_cohorts
    out = genotype_lr(got[0], got[1], got[2], str(tmp / "port_out"))
    ref = ref_genotype_lr(want[0], want[1], want[2], str(tmp / "jax_out"))
    assert _md5_vcfs([out]) == _md5_vcfs([ref])
    with gzip.open(out, "rt") as f:
        assert sum(1 for line in f if not line.startswith("#")) > 5


def test_bench_lr_takes_no_device():
    with pytest.raises(SystemExit):
        bench_lr.main(["--device", "cpu"])


# ---- bench_distributed -------------------------------------------------------

def _once(leg):
    """`leg` run for real on its first call; later calls return that run."""
    runs = []

    def run(tag):
        if not runs:
            runs.append(leg(tag))
        return runs[0]

    return run


class OnceLegs(bench_distributed.Legs):
    """The tool's legs, each run once: the warm-up and the timed repeats
    return that run, so the test starts each process (pair) once."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for name in ("single", "dist", "region_single", "region_dist"):
            setattr(self, name, _once(getattr(self, name)))


def test_bench_distributed_two_ranks_write_the_single_vcf(monkeypatch, capsys):
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    monkeypatch.setattr(bench_distributed, "Legs", OnceLegs)
    assert bench_distributed.main(["4", "20", "--device", "cpu", "--reps", "1"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert _dict_keys("tools/bench_distributed.py", "n_samples") <= _flat_keys(line)
    assert {"t1_s", "t2_s", "scaling_efficiency"} <= set(line)
    for mode in ("sample_sharded", "region_sharded"):
        assert line[mode]["md5_single"] == line[mode]["md5_two_host"], mode
    assert line["sample_sharded"]["md5_single"] == line["region_sharded"]["md5_single"]


# ---- every tool --------------------------------------------------------------

@pytest.mark.parametrize("tool", [bench_flush, bench_distributed, bench_sw, bench_sv, bench_align],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_tool_asks_for_cuda_by_default(monkeypatch, tool):
    """Without --device (or --variants) the tool asks for cuda and raises
    before any work on a machine without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tool.main([])


JAX_IMPORT = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|(from|import)\s+graphtyper_tpu(\.|\s|$))", re.M)


@pytest.mark.parametrize("name", TOOLS)
def test_tool_imports_no_jax_and_catches_nothing(name):
    """The tool imports neither jax nor the JAX package, and has no
    try/except: no leg is retried on another device or turned into a
    number when it fails."""
    path = REPO / "graphtyper_tpu_torch" / "tools" / f"{name}.py"
    src = path.read_text()
    assert not JAX_IMPORT.search(src)
    handlers = [n.lineno for n in ast.walk(ast.parse(src)) if isinstance(n, ast.Try) and n.handlers]
    assert not handlers, handlers
    assert not re.search(r"[\"'](GT_BENCH_FORCE_CPU|GT_HOST_APPLY_ROWS|GT_FP_HOST_AGG_ROWS)[\"']", src)
