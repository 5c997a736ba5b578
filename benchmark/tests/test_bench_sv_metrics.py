"""The `genotype_sv` cell's per-layer readers (`sv.*`), on the CPU: on
recorded spans and counters, with nothing to read (as from a program
without the SV path's spans), and in a traced run of a tiny SV cell,
whose line holds each of them."""

from __future__ import annotations

import json
import os
import time

import pytest

from benchmark import harness, spans
from benchmark import run as bench_run
from benchmark.tests.test_bench_sv import SEED, sv_cell  # noqa: F401  (a fixture)

SV_METRICS = ("sv.reformat.s_per_job", "sv.call.s_per_job", "sv.index.s_per_job", "sv.alleles_per_job")


def _sv_job_spans():
    """Two `genotype_sv` jobs as the port records them: a job root, then
    the graph, its index, the call pool with the SV reformat inside it,
    the merge and the write."""
    from graphtyper_tpu_torch.counters import Span

    ms = 1_000_000
    out = []
    for j, t in enumerate((0, 1000 * ms)):
        job = 10 + 100 * j
        out += [Span("job", t, t + 900 * ms, job, None, job, 1, 1, None),
                Span("graph.build", t + 10 * ms, t + 40 * ms, job + 1, job, job, 1, 1, None),
                Span("index.build", t + 40 * ms, t + 60 * ms, job + 2, job, job, 1, 1, None),
                Span("call.pool", t + 60 * ms, t + 800 * ms, job + 3, job, job, 1, 1, 48),
                Span("scoring.flush", t + 600 * ms, t + 650 * ms, job + 4, job + 3, job, 1, 1, 5000),
                Span("sv.reformat", t + 700 * ms, t + 780 * ms, job + 5, job + 3, job, 1, 1, 60),
                Span("merge", t + 800 * ms, t + 870 * ms, job + 6, job, job, 1, 1, None),
                Span("write", t + 870 * ms, t + 880 * ms, job + 7, job, job, 1, 1, None)]
    return out, ms


def test_sv_readers_on_recorded_spans():
    recorded, ms = _sv_job_spans()
    window = (0, 2000 * ms)
    jobs = [harness.Job(0, 0.9, 1, []), harness.Job(1, 0.9, 1, [])]
    run = harness.Run(jobs=jobs, window=window, spans=spans.clip(recorded, window), counters={"sv_alleles": 82},
                      intervals=[(t + 610 * ms, t + 640 * ms) for t in (0, 1000 * ms)])
    read = lambda name: harness.metric_reader(name)(run)
    assert read("sv.reformat.s_per_job") == pytest.approx(0.080)
    assert read("sv.call.s_per_job") == pytest.approx(0.740 - 0.050 - 0.080)   # less its flush and reformat
    assert read("sv.index.s_per_job") == pytest.approx(0.050)
    assert read("sv.alleles_per_job") == pytest.approx(41)
    # the job's stages name all but the job's own edges: 10 ms before the graph, 20 ms after the write
    assert read("device.idle_named_share") == pytest.approx(100 * (1740 - 60) / (2000 - 60))
    # the window cuts a span
    half = harness.Run(jobs=jobs[:1], window=(0, 730 * ms), spans=spans.clip(recorded, (0, 730 * ms)))
    assert harness.metric_reader("sv.reformat.s_per_job")(half) == pytest.approx(0.030)


def test_sv_readers_find_nothing_without_the_sv_path_instrumented():
    """A program whose `genotype_sv` opens no span and keeps no
    `sv_alleles` counter: every reader gives nothing, and none raises."""
    run = harness.Run(jobs=[harness.Job(0, 1.0, 1, [])], window=(0, 10**9), intervals=[(0, 10)],
                      counters={"scoring_rows": 10})
    for name in SV_METRICS:
        assert harness.metric_reader(name)(run) is None
    assert harness.metric_reader("sv.alleles_per_job")(harness.Run()) is None


def test_the_sv_cell_is_listed_where_its_readers_read():
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    traced = {m["name"] for m in harness.metrics_of(bench, "sv48.pool", True)}
    assert set(SV_METRICS) | {"device.idle_named_share"} <= traced
    assert {m["name"] for m in harness.metrics_of(bench, "sv48.pool", False)} >= {"peak_rss_gib", "setup_s"}


def test_a_traced_sv_run_reads_every_sv_metric(sv_cell, monkeypatch, capsys):  # noqa: F811
    """A traced run of a tiny SV cell (a pool of one sample, 60 kb jobs)
    through the harness: the line holds each `sv.*` reading, and the
    named share of the device's idle time."""
    import torch

    from graphtyper_tpu_torch import counters
    from graphtyper_tpu_torch.config import DEFAULT_OPTIONS, set_options

    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    for m in bench["per_layer"]:
        if m["name"] in SV_METRICS or m["name"] == "device.idle_named_share":
            m["workloads"] = m["workloads"] + [sv_cell]
    with open(os.path.join(harness.ROOT, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    args = bench_run.parse_args(["--workload", sv_cell, "--seed", str(SEED), "--seconds", "0.1", "--trace", "1"])
    # the traced run sets both in this process's environment
    for name in ("GT_TRACE", "GT_SCORING_STATS"):
        monkeypatch.setenv(name, "")
    try:
        assert bench_run.run_cell(args, torch.device("cpu"), time.time()) == 0
    finally:
        set_options(DEFAULT_OPTIONS)
        counters.trace(False)
        counters.reset()
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = res["metrics"]
    for name in SV_METRICS:
        assert got[name]["value"] > 0, name
    assert got["sv.alleles_per_job"]["unit"] == "alleles/job"
    assert 0 < got["device.idle_named_share"]["value"] <= 100
