"""What a run of the benchmark collects, and the pieces that collect it.

`Run` holds everything a metric reader may read. The samplers, the
kernel calls' profiler ranges and the device trace are started around
the measured window by `benchmark.run`; none of them is on in a
`--trace 0` run but the tree-RSS and device-memory sampler that the
end-to-end metrics read.
"""

from __future__ import annotations

import bisect
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
#: whole top-level module names that may not be loaded in a run: JAX and
#: the JAX package (the port's name begins with the latter's)
FORBIDDEN = ("jax", "jaxlib", "flax", "graphtyper_tpu")
#: the kernel calls' profiler ranges are named RANGE_PREFIX + <name>#<i>
RANGE_PREFIX = "benchmark."
#: one H100 SXM's HBM bandwidth, bytes a second (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12


@dataclass
class Job:
    region: int          # index into the regions in rotation
    wall_s: float
    reads: int
    outputs: list


@dataclass
class KernelCall:
    name: str
    bytes: int           # least bytes the call must move, from its shapes
    seconds: float       # device time of the operations the call launched (profiler)


@dataclass
class Run:
    """Everything the metric readers read."""

    setup_s: float = 0.0
    window_s: float = 0.0
    jobs: list = field(default_factory=list)
    peak_rss_bytes: int = 0
    workers_rss_bytes: int = 0   # the largest VmRSS summed over the harness's descendants
    warmup_s: float = 0.0        # the warm-up job's wall, inside set-up
    memory_peak_bytes: int = 0
    counters: dict = field(default_factory=dict)
    scoring_stats: list = field(default_factory=list)
    kernel_calls: list = field(default_factory=list)
    util_samples: list = field(default_factory=list)   # (seconds, GPU utilization %) from NVML
    busy_s: float | None = None
    window: tuple = (0, 0)       # (start_ns, end_ns) of the window on the wall clock
    spans: list = field(default_factory=list)       # the port's spans (counters.Span), cut to the window
    intervals: list = field(default_factory=list)   # (start_ns, end_ns) of every device operation traced

    @property
    def reads(self) -> int:
        return sum(j.reads for j in self.jobs)


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def metric_reader(name: str):
    """The `read(run)` function of metrics/<name>.py."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (trace off) or per-layer metrics
    (trace on): those that list the cell, or list no cells."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


def forbidden_modules(names) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def quantile(values: list, q: float) -> float:
    """The q-quantile of all values, linear between order statistics
    (numpy's default): the 95th percentile of every job, not of chunks."""
    v = sorted(values)
    if len(v) == 1:
        return float(v[0])
    h = (len(v) - 1) * q
    lo = int(h)
    hi = min(lo + 1, len(v) - 1)
    return float(v[lo] + (h - lo) * (v[hi] - v[lo]))


def closed_loop(run_job, regions: list, seconds: float) -> tuple[list, float]:
    """One client: job i on region i mod K, the next sent when the last
    returns, until the first job to finish after `seconds`. Returns the
    jobs and the window's measured length."""
    jobs = []
    w0 = time.perf_counter()
    while True:
        r = len(jobs) % len(regions)
        wall, outs = run_job(regions[r])
        jobs.append(Job(r, wall, regions[r].n_reads, outs))
        if time.perf_counter() - w0 >= seconds:
            return jobs, time.perf_counter() - w0


def median(values: list) -> float:
    return float(statistics.median(values))


def window_rate(jobs: list, window_s: float) -> float:
    """All the window's reads over all its seconds."""
    return sum(j.reads for j in jobs) / window_s


def process_start_time() -> float:
    """The wall-clock time this process started, from /proc."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
    return btime + start_ticks / os.sysconf("SC_CLK_TCK")


# ---- samplers ------------------------------------------------------------

def _proc_table() -> tuple[dict, dict]:
    """Children of each pid, and each pid's VmRSS in bytes (a copy of
    graphtyper_tpu_torch/tools/soak_population.py's sampler)."""
    children: dict[int, list[int]] = {}
    rss: dict[int, int] = {}
    for pid_s in os.listdir("/proc"):
        if not pid_s.isdigit():
            continue
        try:
            with open(f"/proc/{pid_s}/status") as f:
                ppid, kb = 0, 0
                for line in f:
                    if line.startswith("PPid:"):
                        ppid = int(line.split()[1])
                    elif line.startswith("VmRSS:"):
                        kb = int(line.split()[1])
            children.setdefault(ppid, []).append(int(pid_s))
            rss[int(pid_s)] = kb * 1024
        except (OSError, ValueError):
            continue
    return children, rss


def tree_rss(pid: int) -> tuple[int, int]:
    """VmRSS of `pid`, and summed over it and all its descendants, bytes."""
    children, rss = _proc_table()
    total, stack = rss.get(pid, 0), list(children.get(pid, []))
    while stack:
        p = stack.pop()
        total += rss.get(p, 0)
        stack.extend(children.get(p, []))
    return rss.get(pid, 0), total


def cpu_ticks(pid: int) -> tuple[list, int]:
    """The host's CPU time by kind (user, nice, system, idle, iowait, irq,
    softirq, steal; clock ticks, /proc/stat) and the CPU time of `pid` and
    its descendants (ticks, /proc/<pid>/stat): read at both ends of the
    window, they tell a run slowed by other work on the host from one slowed
    by its own."""
    with open("/proc/stat") as f:
        host = [int(x) for x in f.readline().split()[1:9]]
    children, _ = _proc_table()
    own, stack = 0, [pid]
    while stack:
        p = stack.pop()
        try:
            with open(f"/proc/{p}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            own += int(fields[11]) + int(fields[12])
        except (OSError, ValueError, IndexError):
            pass
        stack.extend(children.get(p, []))
    return host, own


def cpu_report(before: tuple, after: tuple, seconds: float) -> str:
    """One line on the host's cores over the window: those this run's
    processes used, and, where the host's counters move (a sandbox may
    hold them still), those busy in all and stolen by the hypervisor."""
    tick = os.sysconf("SC_CLK_TCK")
    cores = lambda t: t / tick / seconds
    line = f"CPU over the window: this run's processes {cores(after[1] - before[1]):.2f} cores"
    host = [b - a for a, b in zip(before[0], after[0])]
    if sum(host) == 0:
        return line + "; the host's counters did not move"
    busy = sum(host) - host[3] - host[4]
    return line + f" of {cores(busy):.2f} busy on the host ({os.cpu_count()}), stolen {cores(host[7]):.2f}"


class Sampler:
    """Once a second: the tree RSS of this process, the part of it held by
    its descendants (the region workers), and the device memory in use by
    every process (total less free, by cudaMemGetInfo)."""

    def __init__(self, device=None, period_s: float = 1.0):
        self.period_s = period_s
        self.device = device
        self.peak_rss = 0
        self.peak_self_rss = 0
        self.peak_children_rss = 0
        self.peak_device = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, name="bench-sampler", daemon=True)

    def sample(self) -> None:
        import torch

        mine, tree = tree_rss(os.getpid())
        self.peak_rss = max(self.peak_rss, tree)
        self.peak_self_rss = max(self.peak_self_rss, mine)
        self.peak_children_rss = max(self.peak_children_rss, tree - mine)
        if self.device is not None:
            free, total = torch.cuda.mem_get_info(self.device)
            self.peak_device = max(self.peak_device, total - free)

    def _loop(self) -> None:
        while not self._stop.wait(self.period_s):
            self.sample()

    def __enter__(self) -> "Sampler":
        self.sample()
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        self.sample()


class NvmlUtilization:
    """GPU utilization of the whole card (every process) from NVML through
    `nvidia-smi -lms`: the share of each sample period in which a kernel
    ran, in whole percent."""

    def __init__(self, period_ms: int = 100):
        self.period_ms = period_ms
        self.samples: list[tuple[float, float]] = []
        self._proc = None
        self._thread = None

    def _read(self) -> None:
        for line in self._proc.stdout:
            line = line.strip()
            if line.isdigit():
                self.samples.append((time.perf_counter(), float(line)))

    def __enter__(self) -> "NvmlUtilization":
        self._proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=utilization.gpu", "--format=csv,noheader,nounits", "-i", "0",
             f"-lms={self.period_ms}"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self._thread = threading.Thread(target=self._read, name="bench-nvml", daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._proc.terminate()
        try:
            self._proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait()
        self._thread.join(timeout=10)


# ---- kernel calls (in-process cells) ------------------------------------

def apply_tier_bytes(rows: int, A: int, n_sites: int, n_samples: int) -> int:
    """Least bytes of one `apply_tier` call: its [14, rows] int32 rows read
    once (56 B a row), each int64 entry of its output written once. The
    output holds, per (site, sample), the A(A+1)/2 likelihood triangle, A
    allele depths and 3 depths, and per site 2 sums and 8 per-allele sums
    (the layout of site_scoring.split_totals)."""
    S = n_sites * n_samples
    T = A * (A + 1) // 2
    return rows * 56 + 8 * (S * (T + A + 3) + n_sites * (2 + 8 * A))


def segment_counters_bytes(rows: int, n_events: int) -> int:
    """Least bytes of one `segment_counters` call: its [6, rows] int64 rows
    read once (48 B a row), the [n_events, 8] int64 counters written once."""
    return rows * 48 + n_events * 8 * 8


class KernelCalls:
    """Each `apply_tier` and `segment_counters` call of this process (as
    tools/bench_scoring.capture_flushes wraps `flush_rows`), with its
    bytes from its shapes, inside a profiler range of its own,
    `benchmark.<name>#<i>`, which the profiler maps onto the device as the
    span of the operations launched inside it (`kernel_calls`)."""

    def __init__(self):
        from graphtyper_tpu_torch.ops import discovery_pileup, site_scoring

        self._mods = (site_scoring, discovery_pileup)
        self._real = (site_scoring.apply_tier, discovery_pileup.segment_counters)
        self._lock = threading.Lock()
        self.calls: dict[str, tuple[str, int]] = {}    # range -> (name, bytes)

    def _timed(self, name: str, fn, nbytes: int, *args):
        from torch.profiler import record_function

        with self._lock:
            label = f"{RANGE_PREFIX}{name}#{len(self.calls)}"
            self.calls[label] = (name, nbytes)
        with record_function(label):
            return fn(*args)

    def __enter__(self) -> "KernelCalls":
        site_scoring, discovery_pileup = self._mods
        apply_tier, segment_counters = self._real

        def timed_apply_tier(obs_mat, A, n_sites, n_samples):
            return self._timed("apply_tier", apply_tier, apply_tier_bytes(obs_mat.shape[1], A, n_sites, n_samples),
                               obs_mat, A, n_sites, n_samples)

        def timed_segment_counters(mat, n_events):
            return self._timed("segment_counters", segment_counters, segment_counters_bytes(mat.shape[1], n_events),
                               mat, n_events)

        site_scoring.apply_tier = timed_apply_tier
        discovery_pileup.segment_counters = timed_segment_counters
        return self

    def __exit__(self, *exc) -> None:
        site_scoring, discovery_pileup = self._mods
        site_scoring.apply_tier, discovery_pileup.segment_counters = self._real


#: the device operations each wrapped call launches, by a part of their
#: names: the launcher's memset and its kernels (csrc/site_scoring.cu,
#: csrc/discovery_pileup.cu)
CALL_OPS = {"apply_tier": ("Memset", "::scoring_rows_kernel", "::scoring_triangle_kernel"),
            "segment_counters": ("Memset", "::discovery_pileup_kernel")}


def kernel_calls(events, calls: dict) -> list[KernelCall]:
    """The calls of `calls` (range -> (name, bytes)) whose range the
    profile holds on the device, each with the summed device time of its
    own operations (its memset and kernels), not of the host's gaps
    between them. The profiler gives each range a device span, from the
    first operation launched inside it to the end of the last. A call's
    operations are those inside its span whose names it launches (others
    are other threads' work on the shared stream); a call whose span
    overlaps another call's is left out, bytes and time, since which of
    the two launched what inside it cannot be told."""
    spans, ops = [], []
    for e in events:
        if e.device_type().name != "CUDA":
            continue
        s = e.start_ns()
        (spans if e.name() in calls else ops).append((s, s + e.duration_ns(), e.name()))
    spans.sort()
    ops.sort()
    starts = [o[0] for o in ops]
    out, reach = [], 0    # reach: the latest end of the spans before
    for k, (s, end, label) in enumerate(spans):
        overlaps = reach > s or (k + 1 < len(spans) and spans[k + 1][0] < end)
        reach = max(reach, end)
        if overlaps:
            continue
        name, nbytes = calls[label]
        ns = 0
        for o_s, o_e, o_name in ops[bisect.bisect_left(starts, s):]:
            if o_s >= end:
                break
            if o_e <= end and any(part in o_name for part in CALL_OPS[name]):
                ns += o_e - o_s
        if ns:
            out.append(KernelCall(name, nbytes, ns / 1e9))
    return out


def roofline_percent(calls: list, name: str) -> float | None:
    """Least time of all `name` calls at HBM bandwidth over the device time
    of their operations, in percent; None when there was no call."""
    mine = [c for c in calls if c.name == name]
    if not mine:
        return None
    return 100.0 * sum(c.bytes for c in mine) / HBM_BYTES_PER_S / sum(c.seconds for c in mine)


# ---- device trace ----------------------------------------------------------

def union_seconds(intervals: list) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_intervals(prof, events) -> tuple[list, list]:
    """(start_ns, end_ns) of each device operation among the `events` of a
    torch.profiler profile, on the wall clock (time.time_ns), and (name,
    seconds) of each.
    The profiler's clock is tied to the wall clock by a marker recorded at
    a known wall time: the first `benchmark_clock` CPU event."""
    mark = next((e for e in events if e.name() == "benchmark_clock"), None)
    offset = getattr(prof, "benchmark_clock_ns", 0) - (mark.start_ns() if mark is not None else 0)
    out, named = [], []
    for e in events:
        if e.device_type().name == "CUDA" and not e.name().startswith(RANGE_PREFIX):
            s = e.start_ns() + offset
            out.append((s, s + e.duration_ns()))
            named.append((e.name(), e.duration_ns() / 1e9))
    return out, named


def start_profiler(cuda: bool = True):
    """A running torch.profiler on CPU and CUDA activity in every thread of
    the process, with its clock marker recorded."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=acts, experimental_config=_ExperimentalConfig(profile_all_threads=True))
    prof.start()
    prof.benchmark_clock_ns = time.time_ns()
    with record_function("benchmark_clock"):
        pass
    return prof


def worker_trace_init(out_dir: str, cuda: bool = True) -> None:
    """Initializer of a traced region worker: a profiler for the worker's
    life, whose device operations are written to `out_dir` when the
    worker exits."""
    from multiprocessing import util

    prof = start_profiler(cuda)

    def dump() -> None:
        prof.stop()
        intervals, named = device_intervals(prof, prof.profiler.kineto_results.events())
        with open(os.path.join(out_dir, f"{os.getpid()}.json"), "w") as f:
            json.dump({"intervals": intervals, "named": named}, f)

    util.Finalize(None, dump, exitpriority=100)


def read_worker_traces(out_dir: str) -> tuple[list, list]:
    intervals, named = [], []
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".json"):
            with open(os.path.join(out_dir, name)) as f:
                d = json.load(f)
            intervals += [tuple(x) for x in d["intervals"]]
            named += [tuple(x) for x in d["named"]]
    return intervals, named


def breakdown(named: list, intervals: list, window: tuple, top: int = 10, spans: list | None = None) -> dict:
    """The device operations that took most time in the window, and the
    longest idle gaps between them; given the port's spans, each gap named
    for what the host was doing (benchmark/spans.py)."""
    if spans:
        from benchmark import spans as span_readings

        return span_readings.breakdown(named, intervals, window, spans, top)
    lo, hi = window
    tot: dict[str, float] = {}
    for (name, sec), (s, e) in zip(named, intervals):
        if s >= lo and e <= hi:
            tot[name] = tot.get(name, 0.0) + sec
    ops = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
    inside = sorted((s, e) for s, e in intervals if s >= lo and e <= hi)
    gaps, last = [], lo
    for s, e in inside:
        if s > last:
            gaps.append(("idle between device operations", (s - last) / 1e9))
        last = max(last, e)
    if hi > last:
        gaps.append(("idle after the last device operation", (hi - last) / 1e9))
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": [[n, v] for n, v in gaps[:top]]}


def print_err(*a) -> None:
    print(*a, file=sys.stderr, flush=True)
