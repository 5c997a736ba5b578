"""The two scoring kernels, csrc/site_scoring.cu (`apply_tier`) and
csrc/discovery_pileup.cu (`segment_counters`), against an earlier build of
the same two sources, in turns on the card, at the shapes of
`chip_smoke.py`'s "scoring" and "pileup" lines and at the scoring flushes
that `genotype` makes.

    python -m graphtyper_tpu_torch.tools.bench_scoring --earlier DIR [--cohorts slice,pool] [--out FILE]

DIR holds the earlier `site_scoring.cu` and `discovery_pileup.cu` with the
C interface of the first hand-written kernels: the caller zeroes the
output (and, for the scoring kernel, the [S, A] scratch u) with
`torch.zeros` and calls `gt_site_scoring(obs, N, A, n_sites, n_samples,
out, u, stream)` or `gt_discovery_pileup(mat, N, n_events, out, stream)`.
The tool builds them with nvcc into a temporary directory and calls them
through a copy of that wrapper (`Earlier`). It also builds
tools/scoring_paths.cu, the current site_scoring.cu with the launch path
named by the caller (`Paths`): where the port's build takes the
persistent grid with a shared copy of the site-level block (`shared`, its
entries in a block's shared memory), the device time a call of the same
flush on the persistent grid without the copy (`global_device_us`) and one
row a lane without it (`lane_device_us`); where it takes one row a lane,
that path's device time with the warp's sums (`grouped_device_us`) and
without them (`direct_device_us`), one of which is the port's choice.

Shapes: tools/bench_flush's four flush sizes and ObsBatcher.maybe_flush's
2,000,000 rows at A 2 x 512 sites, A 4 x 128 sites and A 64 x 64 sites,
50 samples
(`flush_matrix` of tests/test_torch_scoring_batches.py, the rows
chip_smoke.py times); the largest at A 2 also sorted by (site, sample)
and with every row in one segment; the pileup at chip_smoke.py's three
shapes, the largest also sorted by event and in one event; and every
scoring flush of `genotype` on each of COHORTS (simulated, 30x), run with
the CLI's options at the cohort's --threads but its region units in this
process, `flush_rows` wrapped (`capture_flushes`): "slice", chip_smoke.py's
200 kb cohort of 4 samples at --threads 4 (a pool a sample), and "pool",
96 samples over 40 kb at --threads 1 (one pool of 96 samples, as a
768-sample cohort at --threads 8 makes). Each shape is timed earlier,
current, current, earlier (CUDA-event means of back-to-back calls;
`turns`), and the outputs of all builds and paths must be equal. Each
build's device time a call (`device_us`, `earlier_device_us`) is read
from a CUDA graph of back-to-back calls, which leaves out the host's cost
of a call (`graph_us`); torch.profiler counts its device operations a call.

Prints one JSON line a shape, each captured flush one, then one line a
cohort: the histogram of its flushes' rows, their tiers, and the sum and
median of their times. Needs
a card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from graphtyper_tpu_torch import counters, kernels
from graphtyper_tpu_torch.tools.bench_sw import time_ms
from graphtyper_tpu_torch.tools.common import ROOT

#: HBM bytes per second of one H100 SXM (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
#: tools/bench_flush's flush sizes, and ObsBatcher.maybe_flush's 2,000,000 rows
ROWS = (65_536, 262_144, 1_048_576, 2_000_000, 4_194_304)
TIERS = ((2, 512), (4, 128), (64, 64))  # (A, sites)
SAMPLES = 50
PILEUP = ((20_000, 2_500), (1_048_576, 131_072), (4_194_304, 524_288))  # (rows, events)
SIM = dict(coverage=30.0, read_length=151, error_rate=0.01, seed=1, out_format="bam")
#: name: (SimConfig's region_length and n_samples, --threads)
COHORTS = {"slice": (dict(region_length=200_000, n_samples=4), 4),  # chip_smoke.py's 200 kb cohort
           "pool": (dict(region_length=40_000, n_samples=96), 1)}
CAPTURED_REPS = 100  # calls a turn at each captured flush
ROW_BINS = (0, 256, 1024, 2048, 4096, 8192, 16384, 65536, 131_072, 262_144, 1_048_576)


def batches():
    """tests/test_torch_scoring_batches.py (numpy only), the rows that the
    tests and chip_smoke.py use."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_scoring_batches

    return test_torch_scoring_batches


def capture_flushes(sim, cfg, out_dir: str, device: str = "cuda", threads: int = 4) -> list[tuple]:
    """The scoring flushes of `genotype` on the simulated cohort: the CLI's
    options at --threads `threads` (the call pools that many threads split
    into), with the region units run in this process, not in region
    workers, and `flush_rows` wrapped. Returns (host [14, N] int32 matrix,
    A, n_sites, n_samples) for each flush."""
    from graphtyper_tpu_torch import cli
    from graphtyper_tpu_torch.config import DEFAULT_OPTIONS, set_options
    from graphtyper_tpu_torch.ops import site_scoring
    from graphtyper_tpu_torch.pipeline.genotype import genotype_regions

    captured = []
    real = site_scoring.flush_rows

    def flush_rows(mat, A, n_sites, n_samples, device, mesh=None):
        captured.append((torch.from_numpy(mat.numpy().copy()), A, n_sites, n_samples))
        return real(mat, A, n_sites, n_samples, device, mesh)

    region = f"{cfg.chrom}:1-{cfg.region_length}"
    args = cli.parse_args(["genotype", sim.fasta, "--region", region, "-O", out_dir, "--threads", str(threads),
                           "--device", device, *(a for s in sim.sams for a in ("--sam", s))])
    set_options(cli._options_from_args(args))
    site_scoring.flush_rows = flush_rows
    try:
        genotype_regions(sim.fasta, list(sim.sams), region, out_dir, torch.device(device), processes=1)
    finally:
        site_scoring.flush_rows = real
        set_options(DEFAULT_OPTIONS)
    return captured


def rows_histogram(captured) -> dict:
    """Captured flushes by rows, in ROW_BINS, and by tier."""
    rows = np.array([m.shape[1] for m, *_ in captured])
    edges = [*ROW_BINS, np.inf]
    hist = {f"[{lo}, {hi})": int(((rows >= lo) & (rows < hi)).sum()) for lo, hi in zip(edges, edges[1:])}
    tiers = {}
    for _, A, *_ in captured:
        tiers[f"A{A}"] = tiers.get(f"A{A}", 0) + 1
    return dict(flushes=len(captured), rows=int(rows.sum()), median_rows=float(np.median(rows)),
                rows_histogram={k: v for k, v in hist.items() if v}, tiers=tiers,
                sites=sorted({int(n) for _, _, n, _ in captured}))


def graph_us(fn, calls: int = 20, replays: int = 5) -> float:
    """Device time of one call of fn in microseconds: `calls` calls
    captured in one CUDA graph, replayed `replays` times between two CUDA
    events. The host's cost of a call (allocation, ctypes, launch) does not
    count; the gaps between the graph's nodes do."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    us = start.elapsed_time(stop) * 1e3 / (calls * replays)
    del graph
    torch.cuda.empty_cache()
    return us


def device_ops(fn, calls: int = 10, tries: int = 5) -> tuple[float | None, float | None, list[str]]:
    """The device operations of one warm call of fn (kernels, memsets,
    copies), by torch.profiler: (operations a call, their device time a
    call in microseconds, their names). Each of `tries` profiles records
    `calls` calls; torch.profiler on the H100 now and then drops a call's
    events, or a whole profile's, so the profile with the most events
    counts, and (None, None, []) says that none recorded any."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(events) > len(best):
            best = events
    if not best:
        return None, None, []
    return (len(best) / calls, sum(e.time_range.elapsed_us() for e in best) / calls,
            sorted({e.name for e in best}))


class Earlier:
    """The earlier sources, built into `build_dir`, behind a copy of their
    wrappers: the outputs zeroed with torch.zeros, then one call."""

    def __init__(self, src_dir: str, build_dir: str):
        path = kernels.build_shared("gt_earlier_scoring", [Path(src_dir) / "site_scoring.cu",
                                                           Path(src_dir) / "discovery_pileup.cu"],
                                    [kernels.find_nvcc()], list(kernels.NVCC_FLAGS), Path(build_dir))
        lib = ctypes.CDLL(str(path))
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.gt_site_scoring_size.restype = i64
        lib.gt_site_scoring_size.argtypes = [i32, i64, i64]
        lib.gt_site_scoring.restype = i32
        lib.gt_site_scoring.argtypes = [vp, i64, i32, i64, i64, vp, vp, vp]
        lib.gt_discovery_pileup.restype = i32
        lib.gt_discovery_pileup.argtypes = [vp, i64, i64, vp, vp]
        self.lib = lib

    def apply_tier(self, obs_mat, A, n_sites, n_samples):
        from graphtyper_tpu_torch.ops.site_scoring import ALLELE_TIERS, OBS_FIELDS

        dev = obs_mat.device
        kernels.check_cuda("apply_tier", dev, (("obs_mat", obs_mat, torch.int32, 2),))
        if obs_mat.shape[0] != len(OBS_FIELDS) or A not in ALLELE_TIERS:
            raise ValueError("apply_tier: bad shape or tier")
        with torch.cuda.device(dev):
            out = torch.zeros(self.lib.gt_site_scoring_size(A, n_sites, n_samples), dtype=torch.int64, device=dev)
            u = torch.zeros(n_sites * n_samples * A, dtype=torch.int64, device=dev)
            rc = self.lib.gt_site_scoring(obs_mat.data_ptr(), obs_mat.shape[1], A, n_sites, n_samples,
                                          out.data_ptr(), u.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"earlier site_scoring launch failed: {rc}")
        counters.add("apply_tier_earlier")
        return out

    def segment_counters(self, mat, n_events):
        dev = mat.device
        kernels.check_cuda("segment_counters", dev, (("mat", mat, torch.int64, 2),))
        with torch.cuda.device(dev):
            out = torch.zeros((n_events, 8), dtype=torch.int64, device=dev)
            rc = self.lib.gt_discovery_pileup(mat.data_ptr(), mat.shape[1], n_events, out.data_ptr(),
                                              torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"earlier discovery_pileup launch failed: {rc}")
        counters.add("segment_counters_earlier")
        return out


class Paths:
    """tools/scoring_paths.cu built into `build_dir`: `apply_tier` on a
    launch path that the caller names."""

    def __init__(self, build_dir: str):
        src = Path(__file__).resolve().parent / "scoring_paths.cu"
        path = kernels.build_shared("gt_scoring_paths", [src], [kernels.find_nvcc()],
                                    [*kernels.NVCC_FLAGS, "-I", str(kernels.CSRC)], Path(build_dir),
                                    depends=(kernels.CSRC / "site_scoring.cu",))
        lib = ctypes.CDLL(str(path))
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.gt_site_scoring_path.restype = i32
        lib.gt_site_scoring_path.argtypes = [vp, i64, i32, i64, i64, vp, i32, i64, i32, vp]
        self.lib = lib

    def apply_tier(self, obs_mat, A, n_sites, n_samples, persistent: bool, n_shared: int, group: bool):
        ports = kernels.load()
        dev = obs_mat.device
        n_out = ports.gt_site_scoring_size(A, n_sites, n_samples)
        with torch.cuda.device(dev):
            buf = torch.empty(ports.gt_site_scoring_buffer(A, n_sites, n_samples), dtype=torch.int64, device=dev)
            rc = self.lib.gt_site_scoring_path(obs_mat.data_ptr(), obs_mat.shape[1], A, n_sites, n_samples,
                                               buf.data_ptr(), int(persistent), n_shared, int(group),
                                               kernels.stream_of(dev))
        if rc != 0:
            raise RuntimeError(f"site_scoring path launch failed: {rc}")
        return buf[:n_out]


def turns(earlier, current, reps=None) -> dict:
    """CUDA-event ms of earlier, current, current, earlier; the mean of each."""
    e1 = time_ms(earlier, reps)[0]
    c1 = time_ms(current, reps)[0]
    c2 = time_ms(current, reps)[0]
    e2 = time_ms(earlier, reps)[0]
    return dict(earlier_ms=(e1 + e2) / 2, ms=(c1 + c2) / 2, turns=[e1, c1, c2, e2])


def _equal(name, *outs):
    for o in outs[1:]:
        if not torch.equal(o, outs[0]):
            raise AssertionError(f"{name}: the builds disagree")


def scoring_line(name, mat, A, n_sites, n_samples, earlier, paths, reps=None) -> dict:
    from graphtyper_tpu_torch.ops.site_scoring import apply_tier

    args = (A, n_sites, n_samples)
    cur = apply_tier(mat, *args)
    outs = [cur, earlier.apply_tier(mat, *args)]
    line = dict(kernel="apply_tier", shape=name, rows=mat.shape[1], A=A, sites=n_sites, samples=n_samples,
                shared=kernels.load().gt_site_scoring_shared(mat.shape[1], *args))
    line.update(turns(lambda: earlier.apply_tier(mat, *args), lambda: apply_tier(mat, *args), reps))
    if line["shared"]:
        for key, persistent in (("global_device_us", True), ("lane_device_us", False)):
            outs.append(paths.apply_tier(mat, *args, persistent, 0, True))
            line[key] = graph_us(lambda: paths.apply_tier(mat, *args, persistent, 0, True))
    else:  # one row a lane: with the warp's sums and without, whichever the port takes
        for key, group in (("grouped_device_us", True), ("direct_device_us", False)):
            outs.append(paths.apply_tier(mat, *args, False, 0, group))
            line[key] = graph_us(lambda: paths.apply_tier(mat, *args, False, 0, group))
    _equal(name, *outs)
    line.update(device_ops=device_ops(lambda: apply_tier(mat, *args))[0],
                earlier_device_ops=device_ops(lambda: earlier.apply_tier(mat, *args))[0],
                device_us=graph_us(lambda: apply_tier(mat, *args)),
                earlier_device_us=graph_us(lambda: earlier.apply_tier(mat, *args)),
                bound_ms=(mat.numel() * 4 + cur.numel() * 8) / HBM_BYTES_PER_S * 1e3)
    return line


def pileup_line(name, mat, n_events, earlier) -> dict:
    from graphtyper_tpu_torch.ops.discovery_pileup import segment_counters

    _equal(name, segment_counters(mat, n_events), earlier.segment_counters(mat, n_events))
    line = dict(kernel="segment_counters", shape=name, rows=mat.shape[1], events=n_events)
    line.update(turns(lambda: earlier.segment_counters(mat, n_events), lambda: segment_counters(mat, n_events)))
    line.update(device_ops=device_ops(lambda: segment_counters(mat, n_events))[0],
                earlier_device_ops=device_ops(lambda: earlier.segment_counters(mat, n_events))[0],
                device_us=graph_us(lambda: segment_counters(mat, n_events)),
                earlier_device_us=graph_us(lambda: earlier.segment_counters(mat, n_events)),
                bound_ms=(48 * mat.shape[1] + 64 * n_events) / HBM_BYTES_PER_S * 1e3)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--earlier", required=True, help="directory of the earlier site_scoring.cu and discovery_pileup.cu")
    ap.add_argument("--cohorts", default=",".join(COHORTS), help="COHORTS whose flushes are captured and timed")
    ap.add_argument("--out", help="also write the lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_scoring: needs a CUDA card", file=sys.stderr)
        return 2
    from graphtyper_tpu_torch.simulate import SimConfig, simulate_cohort

    b = batches()
    dev = torch.device("cuda")
    lines = []

    def emit(line):
        lines.append(line)
        print(json.dumps(line), flush=True)

    with tempfile.TemporaryDirectory(prefix="bench_scoring_") as tmp:
        earlier = Earlier(args.earlier, os.path.join(tmp, "earlier"))
        paths = Paths(os.path.join(tmp, "paths"))
        for A, n_sites in TIERS:
            for rows in ROWS:
                mat = torch.from_numpy(b.flush_matrix(rows, A, n_sites, SAMPLES, seed=rows)).to(dev)
                emit(scoring_line(f"A{A}_{rows}", mat, A, n_sites, SAMPLES, earlier, paths))
        A, n_sites = TIERS[0]
        big = b.flush_matrix(ROWS[-1], A, n_sites, SAMPLES, seed=ROWS[-1])
        for order in ("sorted", "one_segment"):
            mat = torch.from_numpy(b.scoring_order(big, order, (n_sites, SAMPLES))).to(dev)
            emit(scoring_line(f"A{A}_{ROWS[-1]}_{order}", mat, A, n_sites, SAMPLES, earlier, paths))
        for rows, n_events in PILEUP:
            mat = torch.from_numpy(b.pileup_rows(rows, rows, n_events, n_overflow=0)).to(dev)
            emit(pileup_line(f"{rows}_rows", mat, n_events, earlier))
        rows, n_events = PILEUP[-1]
        big = b.pileup_rows(rows, rows, n_events, n_overflow=0)
        for order in ("sorted", "one_event"):
            mat = torch.from_numpy(b.pileup_order(big, order, n_events)).to(dev)
            emit(pileup_line(f"{rows}_rows_{order}", mat, n_events, earlier))

        for name in args.cohorts.split(","):
            sim_args, threads = COHORTS[name]
            cfg = SimConfig(**SIM, **sim_args)
            sim = simulate_cohort(os.path.join(tmp, name), cfg)
            captured = capture_flushes(sim, cfg, os.path.join(tmp, f"{name}_out"), threads=threads)
            per_flush = []
            for i, (host, A, n_sites, n_samples) in enumerate(captured):
                per_flush.append(scoring_line(f"{name}_{i}", host.to(dev), A, n_sites, n_samples, earlier, paths,
                                              CAPTURED_REPS))
                emit(per_flush[-1])
            summary = dict(kernel="apply_tier", shape=name, cohort=f"{cfg.region_length // 1000} kb,"
                           f" {cfg.n_samples} samples, {cfg.coverage}x, seed {cfg.seed}, --threads {threads}",
                           **rows_histogram(captured))
            for key in ("ms", "earlier_ms", "device_us", "earlier_device_us", "global_device_us",
                        "lane_device_us", "grouped_device_us", "direct_device_us"):
                vals = [x[key] for x in per_flush if x.get(key) is not None]
                if vals:
                    summary[f"sum_{key}"] = sum(vals)
                    summary[f"median_{key}"] = statistics.median(vals)
            summary["device_ops"] = sorted({x["device_ops"] for x in per_flush if x["device_ops"] is not None})
            summary["with_shared_copy"] = sum(x["shared"] > 0 for x in per_flush)
            summary["slower_device_us"] = [x["shape"] for x in per_flush if x["device_us"] > x["earlier_device_us"]]
            emit(summary)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
