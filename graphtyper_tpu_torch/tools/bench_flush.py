"""One production scoring flush on a device (the counterpart of
tools/bench_flush.py): the port's `ops/site_scoring.flush_rows`, the
function every `ObsBatcher` flush calls, on a CUDA device against the same
function on the CPU device.

A scoring flush ships one tier's observation rows as a [14, rows] int32
matrix in one copy, applies them with `apply_tier` and copies the summed
state vector back (`ObsBatcher._flush_tier_launch`, `_flush_tier_collect`).
On a CUDA device the matrix lies in pinned memory, as `ObsBatcher` writes
it, and is copied without blocking the host; `apply_tier` is
csrc/site_scoring.cu, a memset and all rows in one launch (and a second
pass above A 4); on the CPU device it is `apply_tier_plain`, in chunks of
`_chunk_rows(A)` rows. This tool times that flush at the JAX tool's
cohort-scale shapes (65,536 to 4,194,304 rows, A = 2, 512 sites, --samples
samples) from the JAX tool's synthetic rows (`synth_rows`, the same numpy
draws).

The JAX tool's "host" leg was its numpy twin `_apply_rows_numpy`; the port
has no batched numpy apply, so the counterpart is the same flush on the
CPU device (`host_ms`, host clock). The device leg (`--device`, cuda by
default) is timed with CUDA events: the first flush (`device_ms_first`,
kernel caches cold), the median of 3 steady flushes (`device_ms_steady`:
the pinned copy to the card, the apply, the copy back), the pinned copy
alone (`h2d_ms`) beside the same bytes from pageable memory
(`h2d_pageable_ms`), and the apply alone on resident rows
(`device_compute_ms`). The card's totals must equal the CPU's exactly; a
difference fails the tool. On the card each line also counts the CUDA
kernels of one flush (`cuda_kernels_per_flush`, torch.profiler) and the
launches of one flush by the scoring and pileup kernels' counters
(`launches`), and gives the flush's byte bound: the rows read once and the
state vector written once over 3.35 TB/s (`bound_ms`), and the copy's bytes
over the rate of a 256 MB pinned copy measured in the same run
(`h2d_bound_ms`). `chunks` is the applies a flush makes: 1 on the card,
the plain version's chunks on the CPU.

Reference analog of the work: haplotype.cpp:462-585 explain_to_score per
read, summed over the cohort (src/typer/caller.cpp:313-437 thread loop).

    python -m graphtyper_tpu_torch.tools.bench_flush [--samples 50]
        [--rows 65536,262144,1048576,4194304] [--device cuda|cpu]

Prints one JSON line per shape with the JAX tool's keys ("rows", "A",
"sites", "samples", "host_ms", "device_ms_steady", "device_ms_first",
"h2d_mb", "device_compute_ms", "chunks", "winner",
"speedup_device_over_host") and the port's own ("device", "h2d_ms",
"h2d_pageable_ms", "bound_ms", "h2d_bound_ms", "cuda_kernels_per_flush",
"launches").
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

#: HBM bytes per second of one H100 SXM (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
ROWS = (65_536, 262_144, 1_048_576, 4_194_304)


def synth_rows(n: int, A: int, n_sites: int, n_samples: int, seed: int = 0):
    """Realistic observation-row columns (production distributions: most
    reads explain one allele, eps 4-8, ~half proper pairs); the numpy draws
    of tools/bench_flush.py synth_rows."""
    from graphtyper_tpu_torch.ops.site_scoring import COV_MULTI_ALT, COV_MULTI_REF, OBS_FIELDS

    rng = np.random.default_rng(seed)
    cols = {}
    cols["site"] = rng.integers(0, n_sites, n).astype(np.int64)
    cols["sample"] = rng.integers(0, n_samples, n).astype(np.int64)
    cols["eps"] = rng.integers(4, 9, n).astype(np.int64)
    cols["apply_score"] = (rng.random(n) < 0.98).astype(np.int64)
    which = rng.integers(0, A, n)
    lo = (1 << which.astype(np.uint64)) & 0xFFFFFFFF
    multi = rng.random(n) < 0.06
    lo = np.where(multi, lo | np.uint64(1), lo)
    cols["bits_lo"] = lo.astype(np.int64)
    cols["bits_hi"] = np.zeros(n, dtype=np.int64)
    cov = which.astype(np.int64)
    cov = np.where(multi, np.where(which > 0, COV_MULTI_ALT, COV_MULTI_REF), cov)
    cols["cov"] = cov
    cols["clipped_scaled"] = rng.integers(0, 30, n).astype(np.int64)
    cols["clipped_flag"] = (rng.random(n) < 0.08).astype(np.int64)
    cols["mapq_sq"] = (rng.integers(20, 61, n) ** 2).astype(np.int64)
    cols["mm_scaled"] = rng.integers(0, 40, n).astype(np.int64)
    cols["sdiff"] = rng.integers(0, 60, n).astype(np.int64)
    cols["strand"] = rng.integers(0, 4, n).astype(np.int64)
    cols["proper"] = (rng.random(n) < 0.5).astype(np.int64)
    return {k: cols[k] for k in OBS_FIELDS}


def flush(mat: torch.Tensor, A: int, n_sites: int, n_samples: int, device: torch.device) -> dict:
    """One flush as `ObsBatcher` makes it (`_flush_tier_launch`, then
    `_flush_tier_collect`): `site_scoring.flush_rows` on `device`, then the
    summed vector back to the host in one copy, as numpy totals."""
    from graphtyper_tpu_torch.ops.site_scoring import flush_rows, split_totals, totals_to_numpy

    vec = flush_rows(mat, A, n_sites, n_samples, device)
    return totals_to_numpy(split_totals(vec.cpu(), A, n_sites, n_samples))


def _cuda_ms(fn, device: torch.device) -> float:
    """Milliseconds of `fn()` between two CUDA events on `device`'s stream."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _kernels_in(fn) -> int:
    """CUDA kernels that one call of `fn` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA)


def h2d_peak_bytes_per_s(device: torch.device, nbytes: int = 1 << 28) -> float:
    """Host-to-device copy rate of a 256 MB pinned buffer, best of 3: the
    least time the flush's copy could take is its bytes over this rate."""
    src = torch.empty(nbytes, dtype=torch.uint8).pin_memory()
    dst = torch.empty(nbytes, dtype=torch.uint8, device=device)
    dst.copy_(src, non_blocking=True)
    ms = min(_cuda_ms(lambda: dst.copy_(src, non_blocking=True), device) for _ in range(3))
    return nbytes / (ms / 1e3)


def bench_shape(rows: int, n_samples: int, device: torch.device, A: int = 2, n_sites: int = 512) -> dict:
    from graphtyper_tpu_torch import counters
    from graphtyper_tpu_torch.ops.site_scoring import _chunk_rows, flush_rows, obs_matrix

    mat = torch.from_numpy(obs_matrix(synth_rows(rows, A, n_sites, n_samples), rows))
    h2d_bytes = mat.numel() * mat.element_size()
    chunks = 1 if device.type == "cuda" else -(-rows // _chunk_rows(A))
    cpu = torch.device("cpu")

    host_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        want = flush(mat, A, n_sites, n_samples, cpu)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    host = statistics.median(host_ms)

    line = {"rows": rows, "A": A, "sites": n_sites, "samples": n_samples, "host_ms": host,
            "device": str(device), "h2d_mb": h2d_bytes / 1e6, "chunks": chunks}
    if device.type == "cpu":
        # the device leg is the host leg: no device time to report
        line.update(device_ms_first=None, device_ms_steady=None, device_compute_ms=None,
                    h2d_ms=None, h2d_pageable_ms=None, bound_ms=None, h2d_bound_ms=None,
                    cuda_kernels_per_flush=None, launches=None, winner=None, speedup_device_over_host=None)
        return line

    # the production flush: the rows in pinned memory, as ObsBatcher
    # writes them
    pinned = mat.pin_memory()
    got = {}

    def dev_flush():
        got.update(flush(pinned, A, n_sites, n_samples, device))

    first = _cuda_ms(dev_flush, device)
    counters.reset()
    dev_flush()
    launches = {k: counters.COUNTS[k] for k in ("apply_tier", "segment_counters")}
    steady = statistics.median(_cuda_ms(dev_flush, device) for _ in range(3))
    for k, v in want.items():
        if not np.array_equal(got[k], v):
            raise SystemExit(f"bench_flush: {k} on {device} differs from the CPU at {rows} rows")

    h2d = statistics.median(_cuda_ms(lambda: pinned.to(device, non_blocking=True), device)
                            for _ in range(3))
    h2d_pageable = statistics.median(_cuda_ms(lambda: mat.to(device), device) for _ in range(3))
    resident = mat.to(device)

    def compute():
        flush_rows(resident, A, n_sites, n_samples, device)

    compute()
    compute_ms = statistics.median(_cuda_ms(compute, device) for _ in range(3))
    S = n_sites * n_samples
    out_bytes = 8 * (S * (A * (A + 1) // 2) + S * A + 3 * S + 2 * n_sites + 8 * n_sites * A)
    line.update(
        device_ms_first=first, device_ms_steady=steady, device_compute_ms=compute_ms, h2d_ms=h2d,
        h2d_pageable_ms=h2d_pageable, bound_ms=(h2d_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3,
        h2d_bound_ms=h2d_bytes / h2d_peak_bytes_per_s(device) * 1e3,
        cuda_kernels_per_flush=_kernels_in(dev_flush), launches=launches,
        winner="device" if steady < host else "host",
        speedup_device_over_host=host / steady,
    )
    return line


def main(argv: list[str] | None = None) -> int:
    from graphtyper_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--samples", type=int, default=50)
    ap.add_argument("--rows", default=",".join(str(r) for r in ROWS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(device)}", file=sys.stderr)
    for rows in (int(r) for r in args.rows.split(",")):
        print(json.dumps(bench_shape(rows, args.samples, device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
