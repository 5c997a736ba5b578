"""The two scoring kernels of the port on the CPU: csrc/site_scoring.cu
(the counterpart of the JAX package's jitted `_apply_tier_impl`) and
csrc/discovery_pileup.cu (of `_jitted_agg_cached`), with their plain
versions and their dispatch. Every output is an integer: each comparison
is exact.

- `apply_tier_plain` against the JAX `_apply_tier_impl`, jitted on the CPU,
  on tests/test_torch_scoring_batches.py's adversarial rows, at every
  allele tier and three seeds.
- The kernel's own formulation, emulated in numpy (per-row scatters into
  u and into the triangle W, then the triangle pass with the kernel's
  inversion of t into (x, y); no [N, T] Gram product), against the same
  JAX op: the kernel never forms the Gram product, so this is the CPU's
  check of its arithmetic.
- The kernel bodies themselves (each .cu before the end of its anonymous
  namespace) compiled with g++ against a stub CUDA runtime and run thread
  by thread over a grid of 3 blocks of 64 threads (so every thread strides
  over several rows), against the plain versions.
- `segment_counters_plain` against the JAX `_jitted_agg_cached` and
  `aggregate_rows` on rows with empty events, negative mapq and dist and
  the overflow segment.
- Dispatch: a CPU tensor bumps only the `_plain` counter, a whole flush is
  one `apply_tier`, a non-CPU tensor goes to the kernel or raises, and
  kernels.CUDA_SOURCES names both sources. The launch counters, which call
  pools bump from several threads at once, lose no update.
The kernels themselves are held to their plain versions on the card
(tests/test_torch_ops_cuda.py, chip_smoke.py's "scoring" phase)."""

import pathlib
import re
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphtyper_tpu.ops import discovery_pileup as ref_pileup
from graphtyper_tpu.ops import site_scoring as ref_scoring
from graphtyper_tpu_torch import counters, kernels
from graphtyper_tpu_torch.ops import discovery_pileup, site_scoring
from graphtyper_tpu_torch.ops.site_scoring import ALLELE_TIERS, COV_MULTI_ALT, COV_MULTI_REF, OBS_FIELDS
from test_torch_scoring_batches import SCORING_SHAPE, pileup_rows, scoring_rows
from test_torch_sw_row_emulated import gxx  # noqa: F401 (fixture)

CSRC = pathlib.Path(__file__).resolve().parent.parent / "graphtyper_tpu_torch" / "csrc"
BODY_END = "}  // namespace\n"
SEEDS = (0, 1, 2)
F = {k: i for i, k in enumerate(OBS_FIELDS)}


def _jax_vector(mat, A, n_sites, n_samples):
    vec = ref_scoring._jitted_apply_tier()(jnp.asarray(mat), A=A, n_sites=n_sites, n_samples=n_samples)
    return np.asarray(vec).astype(np.int64)


def _plain_vector(mat, A, n_sites, n_samples):
    return site_scoring.apply_tier_plain(torch.from_numpy(mat), A, n_sites, n_samples).numpy()


def _sizes(A, n_sites, n_samples):
    S, T, SA = n_sites * n_samples, A * (A + 1) // 2, n_sites * A
    return S, T, [S * T, S * A, S, S, S, n_sites, n_sites, SA, SA, SA, SA, 4 * SA]


def emulate_scoring(mat, A, n_sites, n_samples):
    """csrc/site_scoring.cu's two passes in numpy: pass 1 a row at a time
    (u[seg, x] += e - 1 for each set bit, W[seg, t(x, y)] += 2 - e for each
    set pair x <= y, and the coverage, site and per-allele terms); pass 2
    log_delta[seg, t] = W + u[seg, x] + u[seg, y] with (x, y) from t as the
    kernel finds them."""
    m = mat.astype(np.int64)
    S, T, sizes = _sizes(A, n_sites, n_samples)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    ld, gt_cov, amb, amb_alt, alt_pp, clip, smq, pa_clip, pa_mapq, pa_mm, pa_sd, pa_strand = starts[:12]
    out = np.zeros(starts[-1], dtype=np.int64)
    u = np.zeros(S * A, dtype=np.int64)
    mask = (1 << A) - 1
    for r in range(m.shape[1]):
        site, cov = m[F["site"], r], m[F["cov"], r]
        seg = site * n_samples + m[F["sample"], r]
        bits = (int(m[F["bits_lo"], r]) & 0xFFFFFFFF) | (int(m[F["bits_hi"], r]) & 0xFFFFFFFF) << 32
        bits = bits & mask if m[F["apply_score"], r] > 0 else 0
        e = m[F["eps"], r]
        ys = np.array([b for b in range(A) if bits >> b & 1], dtype=np.int64)
        if len(ys):
            u[seg * A + ys] += e - 1
            xx, yy = np.meshgrid(ys, ys, indexing="ij")
            keep = xx <= yy
            out[ld + seg * T + yy[keep] * (yy[keep] + 1) // 2 + xx[keep]] += 2 - e
        if 0 <= cov < A:
            out[gt_cov + seg * A + cov] += 1
        out[amb + seg] += cov in (COV_MULTI_REF, COV_MULTI_ALT)
        out[amb_alt + seg] += cov == COV_MULTI_ALT
        out[alt_pp + seg] += (cov == COV_MULTI_ALT or cov > 0) and m[F["proper"], r] > 0
        out[clip + site] += m[F["clipped_flag"], r]
        out[smq + site] += m[F["mapq_sq"], r]
        if cov >= 0:
            aseg = site * A + cov
            for base, k in ((pa_clip, "clipped_scaled"), (pa_mapq, "mapq_sq"), (pa_mm, "mm_scaled"),
                            (pa_sd, "sdiff")):
                out[base + aseg] += m[F[k], r]
            out[pa_strand + aseg * 4 + m[F["strand"], r]] += 1
    xs, ys = [], []
    for t in range(T):
        y = 0
        while (y + 1) * (y + 2) // 2 <= t:
            y += 1
        xs.append(t - y * (y + 1) // 2)
        ys.append(y)
    urows = u.reshape(S, A)
    out[ld : ld + S * T] += (urows[:, xs] + urows[:, ys]).reshape(-1)
    return out


# ---- apply_tier_plain and the kernel's formulation against the JAX op ------


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("A", ALLELE_TIERS)
def test_apply_tier_plain_matches_jax_on_adversarial_rows(A, seed):
    mat = scoring_rows(A, seed)
    want = _jax_vector(mat, A, *SCORING_SHAPE)
    got = _plain_vector(mat, A, *SCORING_SHAPE)
    np.testing.assert_array_equal(got, want)
    S, T, sizes = _sizes(A, *SCORING_SHAPE)
    assert len(got) == sum(sizes) and got[: S * T].any() and got[-4 * SCORING_SHAPE[0] * A :].any()


@pytest.mark.parametrize("seed", SEEDS[:2])
@pytest.mark.parametrize("A", ALLELE_TIERS)
def test_kernel_formulation_matches_jax(A, seed):
    mat = scoring_rows(A, seed)
    np.testing.assert_array_equal(emulate_scoring(mat, A, *SCORING_SHAPE), _jax_vector(mat, A, *SCORING_SHAPE))


def test_plain_chunks_sum_to_one_pass():
    """apply_tier_plain's chunks of _chunk_rows(A) rows sum to the vector
    of all rows at once (A = 64: 4096-row chunks)."""
    A = 64
    mat = np.concatenate([scoring_rows(A, s) for s in range(4)], axis=1)
    assert mat.shape[1] > site_scoring._chunk_rows(A)
    np.testing.assert_array_equal(_plain_vector(mat, A, *SCORING_SHAPE),
                                  site_scoring._apply_chunk_plain(torch.from_numpy(mat), A, *SCORING_SHAPE).numpy())


# ---- segment_counters_plain against the JAX op --------------------------


@pytest.mark.parametrize("seed,n,n_events", [(0, 5000, 300), (1, 300, 1000), (2, 1, 1), (3, 20000, 7)])
def test_segment_counters_plain_matches_jax(seed, n, n_events):
    mat = pileup_rows(seed, n, n_events)
    got = discovery_pileup.segment_counters_plain(torch.from_numpy(mat), n_events).numpy()
    want = np.asarray(ref_pileup._jitted_agg_cached()(mat.astype(np.int32), n_events))[:n_events]
    np.testing.assert_array_equal(got, want)
    assert (got[:, 6:] >= 0).all()
    if n_events > 1:
        assert (got[::7, :] == 0).all()  # the empty events


@pytest.mark.parametrize("seed", SEEDS)
def test_aggregate_rows_matches_jax_with_negatives(seed):
    """The port's aggregate_rows (plain on the CPU) against the JAX
    package's device form (padded to its overflow segment) on rows with
    negative mapq and dist."""
    n_events = 500
    mat = pileup_rows(seed, 4000, n_events, n_overflow=0)
    readpos = np.where(np.arange(mat.shape[1]) % 3, mat[5] % 151, -1)
    args = (mat[0].astype(np.int32), mat[1].astype(np.int32), mat[2].astype(np.int32),
            mat[3].astype(np.uint8), mat[4].astype(np.int32), mat[5].astype(np.int32), readpos, n_events)
    got = discovery_pileup.aggregate_rows(*args, device="cpu")
    np.testing.assert_array_equal(got, ref_pileup.aggregate_rows(*args, device=True))


# ---- the kernel bodies, compiled for the CPU -----------------------------

STUB = r"""
#pragma once
#include <algorithm>
#include <cstdint>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
struct dim_ { unsigned x; };
inline dim_ threadIdx, blockIdx, blockDim{1}, gridDim{1};
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
// the threads run one after another, so an atomic is a plain update
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v)
{
  const unsigned long long old = *p;
  *p = old + v;
  return old;
}
inline long long atomicMax(long long* p, long long v)
{
  const long long old = *p;
  *p = std::max(old, v);
  return old;
}
inline int __ffsll(long long v) { return __builtin_ffsll(v); }
template <class F> void run_grid(int blocks, int threads, F f)
{
  blockDim.x = threads;
  gridDim.x = blocks;
  for (unsigned b = 0; b < (unsigned)blocks; ++b)
    for (unsigned t = 0; t < (unsigned)threads; ++t)
    {
      blockIdx.x = b;
      threadIdx.x = t;
      f();
    }
}
"""

HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include "cuda_runtime.h"
#include "scoring_body.cuh"
namespace pileup {
#include "pileup_body.cuh"
}

constexpr int GUARD = 64;  // entries past the output, which no add may reach

template <class T> std::vector<T> load(const char* path, size_t n)
{
  std::vector<T> v(n);
  FILE* f = fopen(path, "rb");
  if (!f || fread(v.data(), sizeof(T), n, f) != n)
    exit(2);
  fclose(f);
  return v;
}

int main(int argc, char** argv)
{
  const long long N = atoll(argv[4]);
  std::vector<int64_t> out;
  if (!strcmp(argv[1], "scoring"))
  {
    const int A = atoi(argv[5]);
    const long long n_sites = atoll(argv[6]), n_samples = atoll(argv[7]);
    const auto obs = load<int32_t>(argv[2], 14 * N);
    const Layout l = layout(A, n_sites, n_samples);
    out.assign(l.size + GUARD, 0);
    std::vector<int64_t> u(l.S * A, 0);
    run_grid(3, 64, [&] { scoring_rows_kernel(obs.data(), N, n_samples, l, out.data(), u.data()); });
    run_grid(3, 64, [&] { scoring_triangle_kernel(l, out.data(), u.data()); });
  }
  else
  {
    const long long n_events = atoll(argv[5]);
    const auto mat = load<int64_t>(argv[2], 6 * N);
    out.assign(8 * n_events + GUARD, 0);
    run_grid(3, 64, [&] { pileup::discovery_pileup_kernel(mat.data(), N, n_events, out.data()); });
  }
  FILE* f = fopen(argv[3], "wb");
  fwrite(out.data(), sizeof(int64_t), out.size(), f);
  fclose(f);
  return 0;
}
"""


def _body(name):
    """The source up to the end of its anonymous namespace, without its
    #include lines (the stub and the harness include what it needs)."""
    src = (CSRC / name).read_text()
    src = src[: src.index(BODY_END) + len(BODY_END)]
    return "".join(line for line in src.splitlines(True) if not line.startswith("#include"))


@pytest.fixture(scope="module")
def emulated(gxx, tmp_path_factory):
    d = tmp_path_factory.mktemp("scoring_kernels")
    (d / "cuda_runtime.h").write_text(STUB)
    (d / "scoring_body.cuh").write_text(_body("site_scoring.cu"))
    (d / "pileup_body.cuh").write_text(_body("discovery_pileup.cu"))
    (d / "harness.cpp").write_text(HARNESS)
    exe = d / "emulated"
    subprocess.run(["g++", "-std=c++17", "-O1", "-Wno-unknown-pragmas", "-I", str(d), "-o", str(exe),
                    str(d / "harness.cpp")], check=True, capture_output=True, text=True)
    return d, exe


GUARD = 64  # the harness's zeroed entries past the output


def _run(emulated, kind, mat, *params):
    d, exe = emulated
    src, dst = d / f"in_{kind}.bin", d / f"out_{kind}.bin"
    src.write_bytes(np.ascontiguousarray(mat).tobytes())
    subprocess.run([str(exe), kind, str(src), str(dst), str(mat.shape[1]), *map(str, params)], check=True)
    out = np.frombuffer(dst.read_bytes(), dtype=np.int64)
    assert not out[-GUARD:].any(), "an add landed past the output"
    return out[:-GUARD]


@pytest.mark.parametrize("A", ALLELE_TIERS)
def test_emulated_scoring_kernel_matches_plain(emulated, A):
    mat = scoring_rows(A, 5)
    got = _run(emulated, "scoring", mat, A, *SCORING_SHAPE)
    np.testing.assert_array_equal(got, _plain_vector(mat, A, *SCORING_SHAPE))


@pytest.mark.parametrize("seed,n,n_events", [(0, 5000, 300), (4, 700, 2000)])
def test_emulated_pileup_kernel_matches_plain(emulated, seed, n, n_events):
    mat = pileup_rows(seed, n, n_events)
    got = _run(emulated, "pileup", mat, n_events).reshape(n_events, 8)
    np.testing.assert_array_equal(got, discovery_pileup.segment_counters_plain(torch.from_numpy(mat), n_events).numpy())


# ---- dispatch ---------------------------------------------------------------


def test_cpu_tensors_run_only_the_plain_versions():
    counters.reset()
    A = 8
    mat = torch.from_numpy(np.concatenate([scoring_rows(A, s) for s in range(5)], axis=1))
    vec = site_scoring.flush_rows(mat, A, *SCORING_SHAPE, torch.device("cpu"))
    discovery_pileup.segment_counters(torch.from_numpy(pileup_rows(0, 100, 10)), 10)
    assert dict(counters.COUNTS) == {"apply_tier_plain": 1, "segment_counters_plain": 1}
    np.testing.assert_array_equal(vec.numpy(), _jax_vector(mat.numpy(), A, *SCORING_SHAPE))


def test_non_cpu_tensors_go_to_the_kernels_or_raise(monkeypatch, tmp_path):
    """A non-CPU tensor launches the kernel or raises: with no nvcc the
    build fails and no plain version runs. Meta tensors stand in for CUDA
    ones."""
    monkeypatch.setattr(kernels, "_LIB", None)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "kernel_build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "empty_bin"))
    counters.reset()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        site_scoring.apply_tier(torch.zeros((14, 64), dtype=torch.int32, device="meta"), 2, 4, 2)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        site_scoring.flush_rows(torch.zeros((14, 64), dtype=torch.int32, device="meta"), 2, 4, 2,
                                torch.device("meta"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        discovery_pileup.segment_counters(torch.zeros((6, 64), dtype=torch.int64, device="meta"), 8)
    assert not counters.COUNTS


def test_kernel_sources_are_built_and_bound():
    """Both sources are in the build list, and each C function that
    kernels.load binds is defined in one of them."""
    assert {"site_scoring.cu", "discovery_pileup.cu"} <= set(kernels.CUDA_SOURCES)
    defined = set()
    for name in kernels.CUDA_SOURCES:
        defined |= set(re.findall(r'extern "C" \w+ (gt_\w+)\(', (CSRC / name).read_text()))
    bound = set(re.findall(r"lib\.(gt_\w+)\.argtypes", pathlib.Path(kernels.__file__).read_text()))
    assert {"gt_site_scoring", "gt_site_scoring_size", "gt_discovery_pileup"} <= bound <= defined


def test_counters_lose_no_update_across_threads():
    """Call pools bump the launch counters from several threads at once (a
    `+=` on a Counter loses updates there): in each of 150 rounds, 16
    threads adding to one key 200 times each under a 1 us switch interval
    leave 16 x 200."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(150):
            counters.reset()
            start = threading.Barrier(16)

            def bump():
                start.wait(timeout=30)
                for _ in range(200):
                    counters.add("stress")

            threads = [threading.Thread(target=bump) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            assert counters.totals() == {"stress": 16 * 200}
    finally:
        sys.setswitchinterval(old)
        counters.reset()
