"""The port's span recorder (graphtyper_tpu_torch/counters.py) and the
benchmark's reading of it (benchmark/spans.py), on the CPU.

- off, `span()` is one shared no-op and records nothing;
- on, one in-process `genotype_regions` job on a small cohort: every stage
  span, the self times of a unit and its descendants on its own thread
  summing to the unit's duration, and the call pools' spans naming the
  `call` span as their parent from their pool threads;
- over two region workers, each worker's `unit` and `pool.wait` carry the
  parent's job id and come back in `counters.spans()`;
- GT_TRACE's exporter writes trace-event JSON at exit, and warns without
  failing where it cannot write;
- the benchmark's named breakdown on synthetic spans and device intervals.
"""

import json
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import pytest

from benchmark import harness
from benchmark import spans as bench_spans
from graphtyper_tpu_torch import config, counters
from graphtyper_tpu_torch.pipeline import genotype as port_genotype
from graphtyper_tpu_torch.simulate import SimConfig, simulate_cohort

REPO = Path(__file__).resolve().parents[1]
# two samples with indels and errors, so discovery realigns; two units of
# 15 kb for the region workers
CFG = SimConfig(region_length=30_000, coverage=8, n_samples=2, error_rate=0.02, out_format="bam", seed=2)
REGION = f"{CFG.chrom}:1-{CFG.region_length}"
STAGES = {"job", "unit", "bamshrink", "discovery", "discovery.pileup", "sites.write", "graph.build",
          "index.build", "call", "call.pool", "scoring.flush", "scoring.materialize", "merge", "write"}


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_trace")
    return simulate_cohort(str(root / "sim"), CFG), root


def _traced_job(cohort, name: str, processes: int, max_region_size: int, **opts) -> list:
    """The spans of one genotype_regions call with the recorder on."""
    sim, root = cohort
    config.set_options(replace(config.DEFAULT_OPTIONS, **opts))
    counters.reset()
    counters.trace(True)
    try:
        port_genotype.genotype_regions(sim.fasta, sim.sams, REGION, str(root / name), "cpu",
                                       max_region_size=max_region_size, processes=processes)
        return counters.spans()
    finally:
        counters.trace(False)
        counters.reset()
        config.set_options(config.DEFAULT_OPTIONS)
        port_genotype.shutdown_region_pool()


@pytest.fixture(scope="module")
def in_process(cohort):
    # one pool a sample, run on two call-pool threads
    return _traced_job(cohort, "in_process", 1, 50_000, threads=2, max_files_open=1)


def test_span_off_is_one_shared_noop():
    counters.reset()
    assert not counters.tracing()
    a, b = counters.span("x"), counters.span("y", n=3, parent=(1, 1))
    assert a is b
    with a as sp:
        sp.n = 5
        assert counters.current() is None
    counters.record("z", 0, 1)
    assert counters.spans() == [] and counters.SPANS == []


def test_spans_nest_on_threads_and_across_them():
    counters.reset()
    counters.trace(True)
    try:
        with counters.span("job") as job:
            with counters.span("a", n=2):
                here = counters.current()
            from concurrent.futures import ThreadPoolExecutor

            def child():
                with counters.span("b", parent=(job.id, job.job)):
                    pass
                with counters.span("orphan"):
                    pass

            with ThreadPoolExecutor(1) as ex:
                ex.submit(child).result()
        got = {s.name: s for s in counters.spans()}
    finally:
        counters.trace(False)
        counters.reset()
    assert got["job"].parent is None and got["job"].job == got["job"].id
    assert got["a"].parent == got["job"].id and got["a"].n == 2 and here == (got["a"].id, got["job"].id)
    assert got["b"].parent == got["job"].id and got["b"].job == got["job"].id
    assert got["b"].tid != got["job"].tid
    assert got["orphan"].parent is None
    # b runs on another thread: the job's self time keeps its interval
    pieces = counters.self_intervals(list(got.values()))
    assert sum(e - s for s, e in pieces[got["job"].id]) == (
        got["job"].end_ns - got["job"].start_ns - (got["a"].end_ns - got["a"].start_ns))


def test_in_process_job_records_every_stage(in_process):
    names = {s.name for s in in_process}
    assert STAGES <= names, STAGES - names
    assert "realign" in names  # the cohort's discovery reaches the SW path
    assert "pool.wait" not in names
    (job,) = [s for s in in_process if s.name == "job"]
    assert all(s.job == job.id for s in in_process)
    assert len({s.id for s in in_process}) == len(in_process)
    for s in in_process:
        assert s.start_ns <= s.end_ns and (s.n is None or s.n >= 0)
    pileup = [s for s in in_process if s.name == "discovery.pileup"]
    assert sum(s.n for s in pileup) > 0
    (shrink,) = [s for s in in_process if s.name == "bamshrink"]
    (disc,) = [s for s in in_process if s.name == "discovery"]
    assert shrink.n == disc.n > 0
    flushes = [s for s in in_process if s.name == "scoring.flush"]
    assert sum(s.n for s in flushes) > 0


def test_unit_self_times_sum_to_its_duration(in_process):
    (unit,) = [s for s in in_process if s.name == "unit"]
    by_id = {s.id: s for s in in_process}

    def under_unit(s):
        while s.parent is not None:
            if s.parent == unit.id:
                return True
            s = by_id[s.parent]
        return False

    mine = [unit] + [s for s in in_process if (s.pid, s.tid) == (unit.pid, unit.tid) and under_unit(s)]
    assert {"bamshrink", "discovery", "call", "merge", "write"} <= {s.name for s in mine}
    pieces = counters.self_intervals(in_process)
    assert sum(e - s for sp in mine for s, e in pieces[sp.id]) == unit.end_ns - unit.start_ns


def test_call_pool_spans_name_the_call_across_threads(in_process):
    by_id = {s.id: s for s in in_process}
    calls = [s for s in in_process if s.name == "call"]
    pools = [s for s in in_process if s.name == "call.pool"]
    assert len(calls) == 2 and len(pools) == 2 * len(calls)  # two call iterations of two pools
    for p in pools:
        parent = by_id[p.parent]
        assert parent.name == "call" and parent.start_ns <= p.start_ns <= p.end_ns <= parent.end_ns
        assert p.n == 1 and p.tid != parent.tid
    for f in (s for s in in_process if s.name == "scoring.flush"):
        assert by_id[f.parent].name == "call.pool" and f.tid == by_id[f.parent].tid


def test_region_workers_return_their_spans(cohort):
    got = _traced_job(cohort, "workers", 2, 15_000)
    (job,) = [s for s in got if s.name == "job"]
    units = [s for s in got if s.name == "unit"]
    waits = [s for s in got if s.name == "pool.wait"]
    assert len(units) == len(waits) == 2
    for s in units + waits:
        assert s.parent == job.id and s.job == job.id and s.pid != job.pid
    assert STAGES <= {s.name for s in got}
    assert all(s.job == job.id for s in got)
    assert len({s.id for s in got}) == len(got)


def _run_traced(path: str, code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, GT_TRACE=path, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)


def test_exporter_writes_trace_event_json(tmp_path):
    out = tmp_path / "trace.json"
    code = ("from graphtyper_tpu_torch import counters\n"
            "with counters.span('job'):\n"
            "    with counters.span('unit', n=7):\n"
            "        pass\n")
    proc = _run_traced(str(out), code)
    assert proc.returncode == 0, proc.stderr
    events = json.loads(out.read_text())["traceEvents"]
    assert {e["name"] for e in events} == {"job", "unit"}
    by_name = {e["name"]: e for e in events}
    for e in events:
        assert e["ph"] == "X" and e["dur"] >= 0 and isinstance(e["ts"], float)
        assert set(e["args"]) == {"id", "parent", "job", "n"}
    assert by_name["unit"]["args"]["parent"] == by_name["job"]["args"]["id"] == by_name["unit"]["args"]["job"]
    assert by_name["unit"]["args"]["n"] == 7


def test_exporter_warns_where_it_cannot_write(tmp_path):
    code = ("import sys\nfrom graphtyper_tpu_torch import counters\n"
            "with counters.span('job'):\n    pass\nsys.exit(3)\n")
    proc = _run_traced(str(tmp_path / "gone" / "trace.json"), code)
    assert proc.returncode == 3
    assert proc.stderr.count("GT_TRACE") == 1 and "Traceback" not in proc.stderr


# ---- the benchmark's named breakdown ---------------------------------------

def _span(name, start, end, sid, parent=None, pid=1, tid=1):
    return counters.Span(name, start, end, sid, parent, 1, pid, tid, None)


#: device operations at 0-10, 100-110 and 190-200 ns of a 0-300 ns window:
#: idle gaps 200-300, 10-100 and 110-190, longest first
OPS = [(0, 10), (100, 110), (190, 200)]
NAMED = [("k", 10e-9)] * 3
WINDOW = (0, 300)
SPANS = [
    _span("job", 0, 300, 1),
    _span("unit", 5, 105, 2, parent=1),
    # gap 10-100: call.pool on two threads (60 and 40 ns) against bamshrink's 85
    _span("bamshrink", 10, 95, 3, parent=2),
    _span("call.pool", 20, 80, 4, parent=2, tid=2),
    _span("call.pool", 50, 90, 5, parent=2, tid=3),
    # gap 110-190: the root and 30 ns of a span of another process
    _span("discovery", 150, 180, 6, pid=2),
    # gap 200-300: a unit's self time, 90 ns
    _span("unit", 195, 290, 7, parent=1),
]


def test_breakdown_without_spans_is_the_harness_breakdown():
    assert bench_spans.breakdown(NAMED, OPS, WINDOW) == harness.breakdown(NAMED, OPS, WINDOW)
    assert bench_spans.breakdown(NAMED, OPS, WINDOW, spans=None, top=2) == harness.breakdown(NAMED, OPS, WINDOW, 2)


def test_breakdown_names_gaps_by_their_largest_self_time():
    plain = harness.breakdown(NAMED, OPS, WINDOW)
    named = bench_spans.breakdown(NAMED, OPS, WINDOW, spans=SPANS)
    assert named["device_ops"] == plain["device_ops"]
    # each gap keeps its seconds and its place
    assert [g[1] for g in named["idle_gaps"]] == [g[1] for g in plain["idle_gaps"]]
    names = [g[0] for g in named["idle_gaps"]]
    # 200-300: the unit's self time, 90 of 100 ns
    assert names[0] == "host:unit"
    # 10-100: call.pool's 100 ns over two threads against bamshrink's 85
    assert names[1] == "host:call.pool"
    # 110-190: the root, and 30 of 80 ns: below half, unnamed
    assert names[2] == "idle between device operations"


def test_idle_named_share_and_stage_readings():
    share = bench_spans.idle_named_percent(OPS, SPANS, WINDOW)
    # of 270 idle ns, the non-root spans cover 10-100, 150-180 and 200-290
    assert share == pytest.approx(100 * 210 / 270)
    assert bench_spans.stage_s_per_job(SPANS, WINDOW, "call", 2) == pytest.approx(100e-9 / 2)
    assert bench_spans.stage_s_per_job(SPANS, WINDOW, "merge", 2) is None
    waits = [_span("pool.wait", 0, 10 * k, 10 + k, parent=1) for k in range(1, 21)]
    assert bench_spans.pool_wait_p95_s(waits, WINDOW) == pytest.approx(harness.quantile(
        [10e-9 * k for k in range(1, 21)], 0.95))
    assert bench_spans.overhangs([(30, 40), (75, 85)], SPANS, 1, ("call.pool",)) == [0, 0]
    assert bench_spans.overhangs([(85, 99)], SPANS, 1, ("call.pool",)) == [9]
