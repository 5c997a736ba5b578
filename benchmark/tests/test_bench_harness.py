"""The harness on the CPU: the window's arithmetic, the kernel byte
counts, the no-JAX check, the data it finds by name, the rotation, and
`correct` coming out false with the timed path broken underneath."""

from __future__ import annotations

import gzip
import os
import time

import numpy as np
import pytest

from benchmark import harness, reference
from benchmark import run as bench_run


class FakeRegion:
    def __init__(self, n_reads):
        self.n_reads = n_reads


def test_window_is_whole_jobs_over_its_measured_length():
    regions = [FakeRegion(100 * (i + 1)) for i in range(5)]

    def job(region):
        time.sleep(0.05)
        return 0.05, []

    t0 = time.perf_counter()
    jobs, window = harness.closed_loop(job, regions, 0.22)
    took = time.perf_counter() - t0
    # the window ends with the first job to finish after 0.22 s: 5 jobs
    assert len(jobs) == 5
    assert 0.22 <= window <= took
    assert [j.region for j in jobs] == [0, 1, 2, 3, 4]
    run = harness.Run(jobs=jobs, window_s=window)
    assert harness.metric_reader("reads_per_s")(run) == pytest.approx(1500 / window)
    assert harness.metric_reader("jobs.reads_per_s")(run) == pytest.approx(1500 / window)


def test_p95_is_over_every_job():
    walls = list(np.random.default_rng(1).exponential(0.3, 157))
    jobs = [harness.Job(0, w, 1, []) for w in walls]
    run = harness.Run(jobs=jobs, window_s=1.0)
    assert harness.metric_reader("jobs.p95_s")(run) == pytest.approx(np.percentile(walls, 95))
    assert harness.metric_reader("jobs.median_s")(run) == pytest.approx(np.median(walls))


def test_region_pool_readings():
    read = harness.metric_reader
    assert read("jobs.workers_rss_gib")(harness.Run()) is None   # jobs run in process: nothing to read
    assert read("jobs.workers_rss_gib")(harness.Run(workers_rss_bytes=3 * 2**30)) == 3.0
    assert read("jobs.warmup_s")(harness.Run(warmup_s=8.5)) == 8.5


def test_sampler_splits_the_tree_from_the_harness():
    import subprocess
    import sys

    child = subprocess.Popen([sys.executable, "-c", "import time; b = bytearray(64 << 20); time.sleep(30)"])
    try:
        time.sleep(1.0)
        with harness.Sampler(period_s=0.1) as s:
            time.sleep(0.3)
    finally:
        child.kill()
        child.wait()
    assert s.peak_children_rss >= 64 << 20
    assert s.peak_children_rss <= s.peak_rss <= s.peak_self_rss + s.peak_children_rss


@pytest.mark.parametrize("A,n_sites,n_samples,rows", [(2, 512, 50, 65536), (4, 128, 12, 3001), (64, 7, 3, 10)])
def test_apply_tier_bytes_from_shapes(A, n_sites, n_samples, rows):
    import torch

    from graphtyper_tpu_torch.ops.site_scoring import OBS_FIELDS, split_totals

    S = n_sites * n_samples
    T = A * (A + 1) // 2
    n_out = S * (T + A + 3) + n_sites * (2 + 8 * A)
    # the port's own split of its output vector takes exactly n_out entries
    assert sum(v.numel() for v in split_totals(torch.zeros(n_out, dtype=torch.int64), A, n_sites,
                                                n_samples).values()) == n_out
    assert harness.apply_tier_bytes(rows, A, n_sites, n_samples) == rows * 4 * len(OBS_FIELDS) + 8 * n_out


def test_segment_counters_bytes_from_shapes():
    assert harness.segment_counters_bytes(20_000, 2_500) == 20_000 * 6 * 8 + 2_500 * 8 * 8


def test_roofline_share():
    calls = [harness.KernelCall("apply_tier", 3_350_000, 2e-6), harness.KernelCall("apply_tier", 3_350_000, 2e-6),
             harness.KernelCall("segment_counters", 1, 1.0)]
    assert harness.roofline_percent(calls, "apply_tier") == pytest.approx(50.0)
    assert harness.roofline_percent(calls, "nothing") is None


class FakeEvent:
    def __init__(self, name, device, start_ns, duration_ns):
        self._n, self._d, self._s, self._ns = name, device, start_ns, duration_ns

    def name(self):
        return self._n

    def device_type(self):
        return type("D", (), {"name": self._d})

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._ns


ROWS = "void (anonymous namespace)::scoring_rows_kernel<2, false, true>(int const*, long)"
PILEUP = "(anonymous namespace)::discovery_pileup_kernel(long const*, long, long, long*)"


def test_kernel_time_is_what_each_call_launched():
    """A call's time is the device time of its own memset and kernels
    inside its range's device span: not the idle gap while the host
    launched the kernel, nor another thread's copy on the shared stream;
    a call whose span overlaps another's is left out."""
    calls = {"benchmark.apply_tier#0": ("apply_tier", 1000), "benchmark.segment_counters#1": ("segment_counters", 48),
             "benchmark.apply_tier#2": ("apply_tier", 3000), "benchmark.apply_tier#3": ("apply_tier", 7),
             "benchmark.apply_tier#4": ("apply_tier", 9), "benchmark.apply_tier#5": ("apply_tier", 11)}
    events = [FakeEvent("benchmark.apply_tier#0", "CPU", 0, 90_000),
              # call 0: memset, 20 us idle, a copy of another thread, the kernel
              FakeEvent("benchmark.apply_tier#0", "CUDA", 1_000, 40_000),
              FakeEvent("Memset (Device)", "CUDA", 1_000, 1_000),
              FakeEvent("Memcpy HtoD (Pageable -> Device)", "CUDA", 22_000, 5_000),
              FakeEvent(ROWS, "CUDA", 37_000, 4_000),
              # call 1
              FakeEvent("benchmark.segment_counters#1", "CUDA", 100_000, 3_000),
              FakeEvent("Memset (Device)", "CUDA", 100_000, 1_000),
              FakeEvent(PILEUP, "CUDA", 101_000, 2_000),
              # call 2, with the triangle pass
              FakeEvent("benchmark.apply_tier#2", "CUDA", 200_000, 9_000),
              FakeEvent("Memset (Device)", "CUDA", 200_000, 1_000),
              FakeEvent(ROWS, "CUDA", 202_000, 3_000),
              FakeEvent("(anonymous namespace)::scoring_triangle_kernel(Layout, long*, long const*)", "CUDA",
                        206_000, 3_000),
              # call 3 holds call 4's span and a later one's, call 5, which call 4 does not reach
              FakeEvent("benchmark.apply_tier#3", "CUDA", 300_000, 20_000),
              FakeEvent("benchmark.apply_tier#4", "CUDA", 302_000, 5_000),
              FakeEvent(ROWS, "CUDA", 303_000, 3_000),
              FakeEvent("benchmark.apply_tier#5", "CUDA", 310_000, 5_000),
              FakeEvent(ROWS, "CUDA", 311_000, 3_000)]
    got = {(c.name, c.bytes): c.seconds for c in harness.kernel_calls(events, calls)}
    assert got == {("apply_tier", 1000): pytest.approx(5e-6), ("segment_counters", 48): pytest.approx(3e-6),
                   ("apply_tier", 3000): pytest.approx(7e-6)}
    run = harness.Run(kernel_calls=harness.kernel_calls(events, calls))
    assert harness.metric_reader("apply_tier_roofline")(run) == pytest.approx(100 * 4000 / 3.35e12 / 12e-6)
    # the ranges' spans are no device work of their own
    intervals, named = harness.device_intervals(object(), events)
    assert len(intervals) == 10 and not any(n.startswith("benchmark.") for n, _ in named)


def test_cpu_report_over_the_window():
    tick = os.sysconf("SC_CLK_TCK")
    before = ([0] * 8, 0)
    # 10 s: 30 core-s of user time, 10 of it this run's, 5 stolen, the rest idle
    after = ([30 * tick, 0, 0, 40 * tick, 0, 0, 0, 5 * tick], 10 * tick)
    line = harness.cpu_report(before, after, 10.0)
    assert "this run's processes 1.00 cores of 3.50 busy" in line and "stolen 0.50" in line
    assert harness.cpu_report(before, ([0] * 8, 10 * tick), 10.0).endswith("the host's counters did not move")
    host, own = harness.cpu_ticks(os.getpid())
    assert len(host) == 8 and own > 0


def test_no_jax_by_whole_top_level_name():
    assert harness.forbidden_modules(["graphtyper_tpu_torch", "graphtyper_tpu_torch.ops", "jaxtyping"]) == []
    assert harness.forbidden_modules(["graphtyper_tpu", "graphtyper_tpu.ops.sw"]) == [
        "graphtyper_tpu", "graphtyper_tpu.ops.sw"]
    assert harness.forbidden_modules(["jax", "jaxlib.xla", "flax"]) == ["flax", "jax", "jaxlib.xla"]


def test_everything_is_found_by_name():
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    for work in bench["workloads"]:
        _, w, cfg, traffic = bench_run.cell(work["name"])
        assert cfg["name"] == w["config"]
        assert traffic["regions_in_rotation"] >= 5
        for trace in (False, True):
            for m in harness.metrics_of(bench, w["name"], trace):
                assert callable(harness.metric_reader(m["name"]))
    names = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    assert names == {f[:-3] for f in os.listdir(os.path.join(harness.HERE, "metrics")) if f.endswith(".py")}


def test_rotation_gives_every_job_fresh_paths(tmp_path):
    import json

    from benchmark.gen import make_inputs

    cfg = json.load(open(os.path.join(harness.HERE, "configs", "cohort48.json")))
    cfg["n_samples"] = 2
    fasta, _, regions = make_inputs(5, cfg, 5_000, 5, str(tmp_path / "in"))
    jobs = bench_run.Jobs(fasta, [], str(tmp_path / "jobs"), None)
    seen = set()
    for i in range(10):
        paths = jobs.links(regions[i % 5])
        jobs.n += 1
        for p, src in zip(paths, regions[i % 5].bams):
            assert p not in seen and os.path.samefile(p, src)
            assert os.path.samefile(p + ".bai", src + ".bai")
            seen.add(p)
    assert len(seen) == 20


# ---- the faults: a run with the timed path broken underneath -------------

def _small(name, n_samples):
    real = bench_run.cell

    def cell(w):
        bench, work, cfg, traffic = real(w)
        return bench, work, dict(cfg, n_samples=n_samples), dict(traffic, job_bp=30_000, regions_in_rotation=5)

    return cell


def _run_cpu(monkeypatch, capsys, workload, n_samples, wrap=None):
    import torch

    from graphtyper_tpu_torch.config import DEFAULT_OPTIONS, set_options
    from graphtyper_tpu_torch.pipeline import genotype

    monkeypatch.setattr(bench_run, "cell", _small(workload, n_samples))
    if wrap is not None:
        monkeypatch.setattr(genotype, "genotype_regions", wrap(genotype.genotype_regions))
    args = bench_run.parse_args(["--workload", workload, "--seed", str(2**31 + 77), "--seconds", "0.1",
                                 "--trace", "0"])
    try:
        assert bench_run.run_cell(args, torch.device("cpu"), time.time()) == 0
    finally:
        set_options(DEFAULT_OPTIONS)
    import json

    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_sound_run_is_correct(monkeypatch, capsys):
    res = _run_cpu(monkeypatch, capsys, "cohort48.pool", 4)
    assert res["correct"] is True and res["attempted"] >= 1


def _unchanged(real):
    """A job that returns the state it was given: no records."""
    def run(ref, sams, region, out, device, **kw):
        return []
    return run


def _half_batch(real):
    """Half of the batch (the samples) left out."""
    def run(ref, sams, region, out, device, **kw):
        return real(ref, sams[: len(sams) // 2], region, out, device, **kw)
    return run


def _altered(real):
    """One answer altered where it is produced: in the SNP record farthest
    from its neighbours (an isolated SNP, which the check holds exactly),
    the first sample's PL of hom-ref set to 255 where it is 0, else 0."""
    def run(ref, sams, region, out, device, **kw):
        outs = real(ref, sams, region, out, device, **kw)
        path = outs[0]
        with gzip.open(path, "rt") as f:
            lines = f.read().split("\n")
        recs = [i for i, line in enumerate(lines) if line and not line.startswith("#")]
        pos = np.array([int(lines[i].split("\t")[1]) for i in recs])
        gap = np.minimum(np.diff(pos, prepend=-10**9), np.diff(pos, append=10**9)[: len(pos)])
        snp = np.array([len(lines[i].split("\t")[3]) == 1 and len(lines[i].split("\t")[4]) == 1 for i in recs])
        i = recs[int(np.argmax(np.where(snp, gap, -1)))]
        col = lines[i].split("\t")
        keys, vals = col[8].split(":"), col[9].split(":")
        pl = vals[keys.index("PL")].split(",")
        pl[0] = "255" if pl[0] == "0" else "0"
        vals[keys.index("PL")] = ",".join(pl)
        col[9] = ":".join(vals)
        lines[i] = "\t".join(col)
        with gzip.open(path, "wt") as f:
            f.write("\n".join(lines))
        return outs
    return run


def _false_sites(real):
    """Sites that were never placed reported as carried: beside every
    tenth record, a copy 3 bp to its right with the reference's base there
    and another alt, its genotypes kept."""
    def run(ref, sams, region, out, device, **kw):
        from graphtyper_tpu_torch.io.fasta import FastaFile

        outs = real(ref, sams, region, out, device, **kw)
        fa = FastaFile(ref)
        seq = fa.fetch(region.split(":")[0])
        fa.close()
        for path in outs:
            with gzip.open(path, "rt") as f:
                lines = f.read().rstrip("\n").split("\n")
            body = [line for line in lines if not line.startswith("#")]
            extra = []
            for i, line in enumerate(body):
                col = line.split("\t")
                at = int(col[1]) + len(col[3]) + 3
                if i % 10 or at > len(seq):
                    continue
                base = chr(seq[at - 1])
                extra.append("\t".join([col[0], str(at), ".", base, "T" if base != "T" else "G", *col[5:]]))
            body = sorted(body + extra, key=lambda line: int(line.split("\t")[1]))
            with gzip.open(path, "wt") as f:
                f.write("\n".join([line for line in lines if line.startswith("#")] + body) + "\n")
        return outs
    return run


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered, _false_sites])
def test_fault_makes_correct_false(monkeypatch, capsys, fault):
    res = _run_cpu(monkeypatch, capsys, "cohort48.pool", 4, wrap=fault)
    assert res["correct"] is False
    if fault is _false_sites:
        # the false sites alone fail it
        assert [k for k, v in res["limits"].items() if v["value"] > v["limit"]] == ["false_sites"]


@pytest.mark.parametrize("fault,fails", [("half_depth", {"pl_mismatch", "ad_gap", "pl_steps"}),
                                         ("false_sites", {"false_sites"})])
def test_control_fails_at_a_tiny_size(fault, fails):
    """The control (the reference from half of the read pairs, in the
    program's place) and the planted false sites go through the harness's
    own decision, and read past the limits they are there for."""
    import json

    from benchmark import control

    cfg = json.load(open(os.path.join(harness.HERE, "configs", "wgs30x.json")))
    ok, got = bench_run.decide(control.fault_records(2**40 + 3, cfg, 60_000, 1, fault))
    assert ok is False
    assert {k for k, v in got.items() if v > bench_run.LIMITS[k]} == fails
