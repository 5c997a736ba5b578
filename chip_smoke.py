"""Smoke run of the torch port on one NVIDIA GPU: python3 chip_smoke.py

Phases, one line each, none of them caught:
  1. card     nvidia-smi name and power limit, torch's CUDA version
  2. kernels  build the CUDA kernels from graphtyper_tpu_torch/csrc
  3. kernel   sw_align_rot (CUDA kernel) against sw_align_plain on the card,
              exactly, at 4096 pairs x 192 x 512, at the main path's batch
              of 6 pairs, and on the tie, length-edge and empty batches;
              CUDA-event times of both
  4. slice    `genotype` through the port's CLI on the card, then the same
              CLI with --device cpu (the plain PyTorch versions) on the same
              input in a subprocess: equal md5 of the uncompressed VCFs.
              Two cohorts: 200 kb, 30x, 4 samples, error rate 0.01 (one CLI
              region loop of four 50 kb units over 4 region workers), and
              50 kb, 10x, 4 samples, error rate 0.02, whose VCF changes when
              the SW results are discarded, so a wrong kernel result shows
The tests hold the port's CPU path to the JAX package byte for byte
(tests/test_torch_slice.py, tests/test_torch_sw.py).
Then one JSON line per kernel, and the last line
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero without a GPU, and outside a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import gzip
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

SLICES = (  # (name, simulated cohort)
    ("200kb", dict(region_length=200_000, coverage=30.0, n_samples=4, read_length=151,
                   error_rate=0.01, seed=1, out_format="bam")),
    ("sw", dict(region_length=50_000, coverage=10.0, n_samples=4, read_length=151,
                error_rate=0.02, seed=2, out_format="bam")),
)
THREADS = 4
KERNEL_SHAPE = (4096, 192, 512)  # pairs, query width (151 bp reads padded), window width
SMALL_BATCH = 6  # pairs in a typical realignment batch of the main path


def _md5(paths):
    """md5 of the concatenated uncompressed VCFs, in path order."""
    h = hashlib.md5()
    for p in sorted(paths):
        with gzip.open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _kernel_batches(np):
    """(name, (Q, qlens, D, dlens)) batches; inputs made with numpy from seeds."""
    rng = np.random.default_rng(2024)
    B, M, N = KERNEL_SHAPE
    qlens = np.full(B, 151, np.int32)
    qlens[::16] = rng.integers(100, 151, len(qlens[::16]))  # some trimmed reads
    dlens = rng.integers(494, N + 1, B).astype(np.int32)
    Q = np.full((B, M), 5, np.uint8)
    D = np.full((B, N), 5, np.uint8)
    for b in range(B):
        D[b, : dlens[b]] = rng.integers(0, 4, dlens[b])
        D[b, rng.integers(0, dlens[b], 3)] = 4  # N codes in the window
        if b % 4:  # planted hit with substitutions and an indel-sized shift
            st = int(rng.integers(0, dlens[b] - qlens[b] - 8))
            hit = D[b, st : st + qlens[b] + 8].copy()
            cut = int(rng.integers(20, 120))
            hit = np.concatenate([hit[:cut], hit[cut + (b % 8) :]])[: qlens[b]]
            Q[b, : qlens[b]] = hit
            Q[b, rng.integers(0, qlens[b], 3)] = rng.integers(0, 5, 3)
        else:
            Q[b, : qlens[b]] = rng.integers(0, 4, qlens[b])
    batches = [("main", (Q, qlens, D, dlens))]

    # tests/ops/test_sw_rot.py: adversarial ties and gaps
    rng = np.random.default_rng(99)
    B2, Mx, Nx = 32, 20, 48
    Q2 = rng.integers(0, 2, (B2, Mx)).astype(np.uint8)
    D2 = rng.integers(0, 2, (B2, Nx)).astype(np.uint8)
    Q2[0] = 0
    D2[0] = 0
    Q2[1, :10] = D2[1, 5:15]
    Q2[1, 10:] = 3
    Q2[2] = D2[2, :Mx][::-1]
    D2[3, :24] = rng.integers(0, 4, 24)
    Q2[3, :10] = D2[3, :10]
    Q2[3, 10:20] = D2[3, 16:26]
    batches.append(("ties", (Q2, np.full(B2, Mx, np.int32), D2, np.full(B2, Nx, np.int32))))

    # tests/ops/test_sw_rot.py: length edges and IUPAC codes
    rng = np.random.default_rng(7)
    Q3 = rng.integers(0, 4, (8, 16)).astype(np.uint8)
    D3 = rng.integers(0, 4, (8, 32)).astype(np.uint8)
    Q3[4, 2:9] = 4
    D3[6, ::3] = 4
    Q3[7] = D3[7, 10:26]
    batches.append(("edges", (Q3, np.array([16, 1, 6, 16, 16, 3, 16, 16], np.int32), D3,
                              np.array([32, 32, 32, 8, 32, 3, 32, 32], np.int32))))

    # qlen = 0 / dlen = 0 sentinels
    Q4 = rng.integers(0, 4, (6, 12)).astype(np.uint8)
    D4 = rng.integers(0, 4, (6, 30)).astype(np.uint8)
    batches.append(("empty", (Q4, np.array([0, 12, 0, 5, 12, 1], np.int32), D4,
                              np.array([30, 0, 0, 0, 30, 1], np.int32))))
    return batches


def _time_ms(torch, fn, reps):
    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_phase(torch, np, dev):
    from graphtyper_tpu_torch.ops.sw_rot import sw_align_plain, sw_align_rot

    batches = _kernel_batches(np)
    Q, ql, D, dl = batches[0][1]
    # the main path's realignment batches hold 1-40 pairs
    batches.insert(1, ("few", tuple(a[:SMALL_BATCH] for a in (Q, ql, D, dl))))
    max_err = 0
    tensors = {}
    for name, arrays in batches:
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]
        got = [x.cpu().numpy().astype(np.int64) for x in sw_align_rot(*t)]
        want = [x.cpu().numpy().astype(np.int64) for x in sw_align_plain(*t)]
        for g, w in zip(got, want):
            max_err = max(max_err, int(np.abs(g - w).max()))
        tensors[name] = t
    if max_err != 0:
        raise AssertionError(f"sw_align_rot disagrees with sw_align_plain: max |diff| {max_err}")
    main_t, few = tensors["main"], tensors["few"]
    cells = int(ql.astype(np.int64).sum()) * D.shape[1]
    ms = _time_ms(torch, lambda: sw_align_rot(*main_t), 5)
    plain_ms = _time_ms(torch, lambda: sw_align_plain(*main_t), 3)
    few_ms = _time_ms(torch, lambda: sw_align_rot(*few), 5)
    few_plain_ms = _time_ms(torch, lambda: sw_align_plain(*few), 3)
    B, M, N = KERNEL_SHAPE
    print(f"kernel: sw_align_rot == sw_align_plain on {B}x{M}x{N}, {SMALL_BATCH} pairs and"
          " ties/edges/empty;"
          f" kernel {ms:.3f} ms ({cells / ms / 1e6:.3f} Gcell/s), plain {plain_ms:.3f} ms"
          f" ({cells / plain_ms / 1e6:.3f} Gcell/s), cells = sum(qlen) x N = {cells};"
          f" {SMALL_BATCH} pairs: kernel {few_ms:.3f} ms, plain {few_plain_ms:.3f} ms", flush=True)
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms)


def _genotype_argv(sim, cfg, out, device):
    argv = ["genotype", sim.fasta, "--region", f"{cfg.chrom}:1-{cfg.region_length}", "-O", out,
            "--threads", str(THREADS), "--device", device]
    for s in sim.sams:
        argv += ["--sam", s]
    return argv


def slice_phase(work, name, sim_kw):
    """One cohort through the port's CLI on the card, then through the same
    CLI on the CPU in a subprocess; returns the card run's counters."""
    from graphtyper_tpu_torch import cli, counters
    from graphtyper_tpu_torch.pipeline.genotype import shutdown_region_pool
    from graphtyper_tpu_torch.simulate import SimConfig, simulate_cohort

    cfg = SimConfig(**sim_kw)
    sim = simulate_cohort(os.path.join(work, name, "sim"), cfg)

    printed = io.StringIO()  # the CLI prints one output path per region unit
    counters.reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        rc = cli.main(_genotype_argv(sim, cfg, os.path.join(work, name, "cuda"), "cuda"))
    wall = time.perf_counter() - t0
    seen = counters.totals()
    shutdown_region_pool()
    if rc != 0:
        raise RuntimeError(f"port genotype on cuda exited {rc}")
    if seen.get("sw_rot", 0) <= 0 or seen.get("scoring_rows", 0) <= 0 or seen.get("sw_plain", 0):
        raise AssertionError(f"main path did not run on the kernels: {seen}")
    outs = printed.getvalue().split()
    n_records = 0
    for p in outs:
        with gzip.open(p, "rt") as f:
            n_records += sum(1 for line in f if not line.startswith("#"))

    # the plain PyTorch versions on the CPU, nothing on the card
    argv = _genotype_argv(sim, cfg, os.path.join(work, name, "cpu"), "cpu")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "graphtyper_tpu_torch.cli", *argv], cwd=HERE,
                          capture_output=True, text=True, env=env, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"port genotype on cpu exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    ref_outs = proc.stdout.split()
    md5, ref_md5 = _md5(outs), _md5(ref_outs)
    if len(outs) != len(ref_outs) or md5 != ref_md5 or n_records == 0:
        raise AssertionError(
            f"{name}: the card's VCF differs from the CPU device's: {len(outs)} files md5 {md5} "
            f"vs {len(ref_outs)} files md5 {ref_md5}, {n_records} records"
        )
    print(f"slice {name}: genotype {cfg.chrom}:1-{cfg.region_length}, {sim.n_reads} reads of"
          f" {cfg.n_samples} samples (error rate {cfg.error_rate}, seed {cfg.seed}) on cuda in"
          f" {wall:.3f} s = {sim.n_reads / wall:.1f} reads/s ({len(outs)} region units,"
          f" --threads {THREADS}); counters {json.dumps(seen, sort_keys=True)}; {n_records} VCF"
          f" records, md5 {md5} == --device cpu", flush=True)
    return seen


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "graphtyper_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"card: torch {torch.__version__}, torch.version.cuda {torch.version.cuda}", flush=True)

    from graphtyper_tpu_torch import kernels

    t0 = time.perf_counter()
    lib = kernels.library_path()
    kernels.load()
    built = time.perf_counter() - t0
    print(f"kernels: built {os.path.relpath(lib, HERE)} in {built:.3f} s", flush=True)

    dev = torch.device("cuda")
    timing = kernel_phase(torch, np, dev)
    launches = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        for name, sim_kw in SLICES:
            launches += slice_phase(work, name, sim_kw)["sw_rot"]
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    print(json.dumps({"kernels": [{
        "name": "sw_align_rot", "route": "cuda", "source": "graphtyper_tpu_torch/csrc/sw_rot.cu",
        "replaces": "graphtyper_tpu/ops/sw_rot.py:282", "launches": launches,
        "max_abs_err": timing["max_abs_err"], "ms": timing["ms"], "plain_ms": timing["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
