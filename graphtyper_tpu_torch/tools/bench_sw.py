"""Microbench and parity check of the port's SW kernels (the counterpart of
tools/bench_sw.py).

    python -m graphtyper_tpu_torch.tools.bench_sw [--row|--rot] [--device cpu] [--pairs B]
    python -m graphtyper_tpu_torch.tools.bench_sw --ptxas

`--rot` (the default) runs `sw_align_rot` (csrc/sw_rot.cu), `--row` runs
`sw_align_pallas` (csrc/sw_row.cu). The batch is the JAX tool's: B = 4096
pairs (or `--pairs`), M = 152, N = 256, numpy seed 0, half the queries noisy
copies of database windows, ragged lengths. The kernel's result must equal
the host DP of the C++ engine (ops/sw.py align_batch_host) exactly; then
CUDA events time many launches after a warm-up and the tool prints Gcell/s
(Σ qlen × N DP cells over the time of one launch).

`--ptxas` compiles csrc/*.cu once more with the library's flags and
`-Xptxas -v` and prints the registers and spill bytes of every kernel
instance (sw_rot_kernel<R> for R = 1-8, sw_row_kernel<C>); it needs nvcc,
not a GPU.

With `--device cpu` the plain PyTorch version runs on the CPU and only
parity is checked: a CPU run gives no device time. Without a GPU, and
without `--device cpu`, the tool raises. The last line is one JSON object
with the result and this process's launch counts.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

from graphtyper_tpu_torch import counters, kernels
from graphtyper_tpu_torch.device import resolve_device
from graphtyper_tpu_torch.ops.sw import align_batch_host
from graphtyper_tpu_torch.ops.sw_pallas import sw_align_pallas
from graphtyper_tpu_torch.ops.sw_rot import sw_align_rot

M, N = 152, 256
#: how long the timed loop runs, at least
TIMED_MS = 200.0


def make_batch(B: int = 4096, seed: int = 0):
    """tools/bench_sw.py:52-65 at B pairs."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (B, M)).astype(np.uint8)
    d = rng.integers(0, 4, (B, N)).astype(np.uint8)
    # half the queries are noisy copies of database windows (realistic hits)
    for i in range(0, B, 2):
        off = rng.integers(0, N - M)
        q[i] = d[i, off : off + M]
        for _ in range(4):
            q[i, rng.integers(0, M)] = rng.integers(0, 4)
    qlens = np.full(B, M, np.int32)
    qlens[rng.integers(0, B, B // 8)] = rng.integers(32, M, B // 8)
    dlens = np.full(B, N, np.int32)
    dlens[rng.integers(0, B, B // 8)] = rng.integers(M, N, B // 8)
    return q, qlens, d, dlens


def time_ms(fn, reps: int | None = None) -> tuple[float, int]:
    """Mean CUDA-event time of one call over `reps` back-to-back calls after
    a warm-up (by default as many as fill about TIMED_MS); (ms, reps)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if reps is None:
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        reps = max(5, min(2000, math.ceil(TIMED_MS / max(start.elapsed_time(stop), 1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, reps


def ptxas_report() -> dict[str, dict[str, int]]:
    """{kernel instance: {"registers": n, "spill_bytes": stores + loads}}
    from nvcc -Xptxas -v on each CUDA source (objects discarded)."""
    report, name = {}, None
    with tempfile.TemporaryDirectory(prefix="ptxas_") as tmp:
        for src in kernels.CUDA_SOURCES:
            proc = subprocess.run([kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                                   "-o", f"{tmp}/{src}.o", str(kernels.CSRC / src)],
                                  capture_output=True, text=True, check=True)
            for line in (proc.stdout + proc.stderr).splitlines():
                entry = re.search(r"Compiling entry function '(\w+)'", line)
                if entry:
                    m = re.search(r"(sw_[a-z]+_kernel)IL[ij](\d+)E", entry.group(1))
                    name = f"{m.group(1)}<{m.group(2)}>" if m else entry.group(1)
                elif name and "spill stores" in line:
                    report.setdefault(name, {})["spill_bytes"] = sum(
                        int(x) for x in re.findall(r"(\d+) bytes spill", line))
                elif name and re.search(r"Used \d+ registers", line):
                    report.setdefault(name, {})["registers"] = int(
                        re.search(r"Used (\d+) registers", line).group(1))
                    name = None
    return dict(sorted(report.items(), key=_natural))


def _natural(item):
    """Sort key of a report entry: sw_row_kernel<2> before sw_row_kernel<16>."""
    return [int(x) if x.isdigit() else x for x in re.split(r"(\d+)", item[0])]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m graphtyper_tpu_torch.tools.bench_sw",
                                 description=__doc__.splitlines()[0])
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--row", action="store_true", help="the row-scan kernel (csrc/sw_row.cu)")
    which.add_argument("--rot", action="store_true", help="the rotated kernel (csrc/sw_rot.cu), the default")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain version, parity only)")
    ap.add_argument("--pairs", type=int, default=4096, help="batch size B (default 4096)")
    ap.add_argument("--ptxas", action="store_true", help="registers and spills of every kernel (nvcc)")
    args = ap.parse_args(argv)
    if args.ptxas:
        report = ptxas_report()
        for k, v in report.items():
            print(f"{k}: {v.get('registers')} registers, {v.get('spill_bytes')} spill bytes", flush=True)
        print(json.dumps({"ptxas": report}))
        return 0
    dev = resolve_device(args.device)
    kern, name = (sw_align_pallas, "sw_row") if args.row else (sw_align_rot, "sw_rot")

    q, qlens, d, dlens = make_batch(args.pairs)
    t = [torch.from_numpy(a).to(dev) for a in (q, qlens, d, dlens)]
    got = [x.cpu().numpy().astype(np.int64) for x in kern(*t)]
    host = align_batch_host(q, qlens, d, dlens)
    for g, w, what in zip(got, (host.score, host.database_begin, host.database_end),
                          ("score", "database_begin", "database_end")):
        if not np.array_equal(g, w):
            bad = int(np.count_nonzero(g != w))
            raise AssertionError(f"{name}: {what} differs from the host DP on {bad} of {args.pairs} pairs")
    label = f"{name} on {dev.type}" + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else "")
    print(f"parity OK on {args.pairs} alignments ({args.pairs} x {M} x {N}): {label}", flush=True)

    cells = int(qlens.astype(np.int64).sum()) * N  # valid DP cells per launch
    result = dict(kernel=name, device=dev.type, pairs=args.pairs, M=M, N=N, cells=cells, parity=True)
    if dev.type == "cuda":
        ms, reps = time_ms(lambda: kern(*t))
        result.update(ms=ms, reps=reps, gcells=cells / ms / 1e6)
        print(f"{cells / ms / 1e6:.3f} Gcell/s ({ms:.4f} ms per batch of {args.pairs}, CUDA events over"
              f" {reps} launches)", flush=True)
    else:
        print("cpu: parity only, no device time", flush=True)
    result["launches"] = counters.totals()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
