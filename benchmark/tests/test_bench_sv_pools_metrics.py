"""The readers of the `genotype_sv` path's call pools (`sv.pools_per_job`,
`sv.call.wall_s_per_job`), on the CPU: on recorded spans and counters, on
what a program with one call pool and no `call` span on that path
records (nothing to read), and in a traced run of a tiny SV cell, whose
line holds both."""

from __future__ import annotations

import json
import os
import time

import pytest

from benchmark import harness, spans
from benchmark import run as bench_run
from benchmark.tests.test_bench_sv import SEED, sv_cell  # noqa: F401  (a fixture)

POOL_METRICS = ("sv.pools_per_job", "sv.call.wall_s_per_job")
MS = 1_000_000


def _jobs_with_pools(pools: int) -> list:
    """Two `genotype_sv` jobs as the port records them at `pools` pools: a
    job root, its graph and index, `call` with a `call.pool` a pool (each
    with its flush and SV reformat) on threads of their own, or on the
    job's thread where there is one pool, the merge and the write."""
    from graphtyper_tpu_torch.counters import Span

    out = []
    for j, t in enumerate((0, 1000 * MS)):
        job = 10 + 100 * j
        out += [Span("job", t, t + 900 * MS, job, None, job, 1, 1, None),
                Span("graph.build", t + 10 * MS, t + 40 * MS, job + 1, job, job, 1, 1, None),
                Span("index.build", t + 40 * MS, t + 60 * MS, job + 2, job, job, 1, 1, None),
                Span("call", t + 60 * MS, t + 400 * MS, job + 3, job, job, 1, 1, None)]
        for p in range(pools):
            pool, tid = job + 10 + 3 * p, 1 if pools == 1 else 2 + p
            out += [Span("call.pool", t + 65 * MS, t + 380 * MS, pool, job + 3, job, 1, tid, 48 // pools),
                    Span("scoring.flush", t + 300 * MS, t + 320 * MS, pool + 1, pool, job, 1, tid, 900),
                    Span("sv.reformat", t + 330 * MS, t + 370 * MS, pool + 2, pool, job, 1, tid, 60)]
        out += [Span("merge", t + 400 * MS, t + 470 * MS, job + 4, job, job, 1, 1, None),
                Span("write", t + 470 * MS, t + 480 * MS, job + 5, job, job, 1, 1, None)]
    return out


def _run(recorded: list, window: tuple, n_jobs: int, counters: dict) -> harness.Run:
    jobs = [harness.Job(i, 0.9, 1, []) for i in range(n_jobs)]
    return harness.Run(jobs=jobs, window=window, spans=spans.clip(recorded, window), counters=counters)


def test_pool_readers_on_recorded_spans():
    window = (0, 2000 * MS)
    run = _run(_jobs_with_pools(4), window, 2, {"sv_alleles": 82, "sv_pools": 8})
    read = lambda name, r=run: harness.metric_reader(name)(r)
    assert read("sv.pools_per_job") == pytest.approx(4.0)
    # the duration of `call`, not the pools' self time summed over their threads
    assert read("sv.call.wall_s_per_job") == pytest.approx(0.340)
    assert read("sv.call.s_per_job") == pytest.approx(4 * (0.315 - 0.020 - 0.040))
    # one pool on the job's thread: the duration still, not `call`'s self time (0.025 s)
    one = _run(_jobs_with_pools(1), window, 2, {"sv_pools": 2})
    assert read("sv.call.wall_s_per_job", one) == pytest.approx(0.340)
    assert read("sv.pools_per_job", one) == pytest.approx(1.0)
    # the window cuts a span
    half = _run(_jobs_with_pools(4), (0, 200 * MS), 1, {"sv_pools": 4})
    assert read("sv.call.wall_s_per_job", half) == pytest.approx(0.140)


def test_a_genotype_call_is_not_read_as_the_sv_path():
    """`genotype`'s `call` sits under a `unit`, not right under the job's
    root: the wall reader leaves it out."""
    from graphtyper_tpu_torch.counters import Span

    recorded = [Span("job", 0, 900 * MS, 10, None, 10, 1, 1, None),
                Span("unit", 5 * MS, 890 * MS, 11, 10, 10, 1, 1, None),
                Span("call", 100 * MS, 500 * MS, 12, 11, 10, 1, 1, None),
                Span("call.pool", 110 * MS, 490 * MS, 13, 12, 10, 1, 2, 12)]
    run = _run(recorded, (0, 1000 * MS), 1, {"scoring_rows": 10})
    for name in POOL_METRICS:
        assert harness.metric_reader(name)(run) is None


def test_pool_readers_find_nothing_on_one_pool_without_a_call_span():
    """A program whose `genotype_sv` runs one `call.pool` right under the
    job's root and keeps no `sv_pools` counter: both readers give
    nothing, and neither raises."""
    recorded = [s._replace(parent=s.job) if s.name == "call.pool" else s
                for s in _jobs_with_pools(1) if s.name != "call"]
    run = _run(recorded, (0, 2000 * MS), 2, {"sv_alleles": 82})
    for name in POOL_METRICS:
        assert harness.metric_reader(name)(run) is None
        assert harness.metric_reader(name)(harness.Run()) is None


def test_the_sv_cell_lists_the_pool_readers():
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    assert set(POOL_METRICS) <= {m["name"] for m in harness.metrics_of(bench, "sv48.pool", True)}
    for name in POOL_METRICS:
        (m,) = [m for m in bench["per_layer"] if m["name"] == name]
        assert (m["layer"], m["moves"], m["workloads"]) == ("call pools", "reads_per_s", ["sv48.pool"])


def test_a_traced_sv_run_reads_the_pool_readers(sv_cell, monkeypatch, capsys):  # noqa: F811
    """A traced run of a tiny SV cell (a pool of one sample, 60 kb jobs)
    through the harness: the line holds both readings, one pool a job."""
    import torch

    from graphtyper_tpu_torch import counters
    from graphtyper_tpu_torch.config import DEFAULT_OPTIONS, set_options

    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    for m in bench["per_layer"]:
        if m["name"] in POOL_METRICS:
            m["workloads"] = m["workloads"] + [sv_cell]
    with open(os.path.join(harness.ROOT, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    args = bench_run.parse_args(["--workload", sv_cell, "--seed", str(SEED), "--seconds", "0.1", "--trace", "1"])
    for name in ("GT_TRACE", "GT_SCORING_STATS"):
        monkeypatch.setenv(name, "")
    try:
        assert bench_run.run_cell(args, torch.device("cpu"), time.time()) == 0
    finally:
        set_options(DEFAULT_OPTIONS)
        counters.trace(False)
        counters.reset()
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["metrics"]
    assert got["sv.pools_per_job"] == {"value": 1.0, "unit": "pools/job"}
    assert got["sv.call.wall_s_per_job"]["value"] > 0
