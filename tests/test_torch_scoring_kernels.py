"""The two scoring kernels of the port on the CPU: csrc/site_scoring.cu
(the counterpart of the JAX package's jitted `_apply_tier_impl`) and
csrc/discovery_pileup.cu (of `_jitted_agg_cached`), with their plain
versions and their dispatch. Every output is an integer: each comparison
is exact.

- `apply_tier_plain` against the JAX `_apply_tier_impl`, jitted on the CPU,
  on tests/test_torch_scoring_batches.py's adversarial rows, at every
  allele tier and three seeds.
- The kernel's own formulation, emulated in numpy (the A 2 and A 4
  triangles added whole a row; above A 4 per-row scatters into u and into
  the triangle W, then the triangle pass with the kernel's inversion of t
  into (x, y); no [N, T] Gram product), against the same JAX op: the
  kernel never forms the Gram product, so this is the CPU's check of its
  arithmetic.
- The kernel bodies themselves (each .cu before the end of its anonymous
  namespace) compiled with g++ against a lockstep stub of the CUDA runtime
  (a block's threads are fibers that meet at every warp-wide call), the
  scoring body over a grid of 3 blocks of 64 threads (so every warp
  strides over several steps of rows), against the plain versions: at
  every tier, on four row orders (tests/test_torch_scoring_batches.py's
  random, sorted, reversed and one-segment or one-event), with the
  site-level block all, a third and none in shared memory with the
  warp's sums and none without them, on many sites, and on sums past 32
  bits; and three flipped pre-reduction rules (a leader that skips a
  peer, a 64-bit sum cut to 32 bits, the pileup's maxima summed), each of
  which must fail its batch.
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
from test_torch_scoring_batches import (ORDERS, SCORING_SHAPE, flush_matrix, pileup_order, pileup_rows,
                                        scoring_order, scoring_rows)
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


FOLD_TIERS = (2, 4)  # the tiers whose triangle pass 1 adds whole


def emulate_scoring(mat, A, n_sites, n_samples):
    """csrc/site_scoring.cu's formulation in numpy, a row at a time. At A 2
    and 4 each row adds its whole triangle ((e - 1)(B_x + B_y) + (2 - e) B_x
    B_y on t(x, y), e B_x on the diagonal); above A 4 it adds e - 1 to
    u[seg, x] for each set bit and 2 - e to W[seg, t(x, y)] for each set
    pair x <= y, and pass 2 adds u[seg, x] + u[seg, y] with (x, y) from t as
    the kernel finds them. Then the coverage, site and per-allele terms."""
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
        if A in FOLD_TIERS:
            b = [bits >> x & 1 for x in range(A)]
            out[ld + seg * T : ld + (seg + 1) * T] += [(e - 1) * (b[x] + b[y]) + (2 - e) * (b[x] & b[y])
                                                     for y in range(A) for x in range(y + 1)]
        else:
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
    if A in FOLD_TIERS:
        assert not u.any()
        return out
    xs, ys = [], []
    for t in range(T):
        y = int((np.sqrt(np.float32(8 * t + 1)) - np.float32(1)) * np.float32(0.5))
        y += (y + 1) * (y + 2) // 2 <= t
        y -= y * (y + 1) // 2 > t
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

# What the kernel bodies need of the CUDA runtime, in lockstep: a block's
# threads are fibers on one OS thread (their own stacks, switched by
# _setjmp/_longjmp), run round-robin by a scheduler that lets each go to its
# next point of contact. Every shuffle, vote and match of a warp is one:
# a lane posts its value 64 bits wide and waits until all 32 lanes of its
# warp have posted theirs for that call, then reads them. __syncthreads
# waits for every thread of the block. A lane that takes another path at a
# warp-wide call leaves its warp waiting: the scheduler finds no thread to
# run and the harness exits 5. Blocks run one after another, so the
# dynamic shared memory is one buffer, and an atomic, which no switch can
# interrupt, is a plain update.
STUB = r"""
#pragma once
#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdlib>
#include <functional>
#include <ucontext.h>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(...)
#define __restrict__
struct dim_ { unsigned x; };
inline dim_ threadIdx, blockIdx, blockDim{32}, gridDim{1};
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;

struct Fiber
{
  jmp_buf jb;
  ucontext_t ctx;
  std::vector<char> stack;
  bool started = false, done = false, ready = true;
};
constexpr int MAX_THREADS = 1024;
inline Fiber g_fiber[MAX_THREADS];
inline jmp_buf g_sched;
inline int g_cur, g_block_waiting, g_warp_waiting[MAX_THREADS / 32];
inline std::function<void()> g_body;
// two rows a warp, used in turn: a lane posts into the row of this call
// while the others may still read the row of the call before
inline unsigned long long g_slot[MAX_THREADS / 32][2][32];
inline unsigned g_phase[MAX_THREADS];

inline void switch_out()  // back to the scheduler, until this fiber is resumed
{
  if (!_setjmp(g_fiber[g_cur].jb))
    _longjmp(g_sched, 1);
}
inline void fiber_main()
{
  g_body();
  g_fiber[g_cur].done = true;
  _longjmp(g_sched, 1);
}
inline void __syncthreads()
{
  g_fiber[g_cur].ready = false;
  if (++g_block_waiting == (int)blockDim.x)
  {
    g_block_waiting = 0;
    for (unsigned i = 0; i < blockDim.x; ++i)
      g_fiber[i].ready = true;
  }
  switch_out();
}
// every lane's value for this warp-wide call, 64 bits wide
inline const unsigned long long* post(unsigned long long v)
{
  const int t = g_cur, w = t / 32;
  unsigned long long* row = g_slot[w][g_phase[t] ^= 1];
  row[t % 32] = v;
  g_fiber[t].ready = false;
  if (++g_warp_waiting[w] == 32)
  {
    g_warp_waiting[w] = 0;
    for (int i = 0; i < 32; ++i)
      g_fiber[w * 32 + i].ready = true;
  }
  switch_out();
  return row;
}
template <class T> inline T __shfl_sync(unsigned, T v, int src)
{
  static_assert(sizeof(T) <= 8);
  return (T)post((unsigned long long)v)[src & 31];
}
inline unsigned __ballot_sync(unsigned, bool pred)
{
  const unsigned long long* row = post(pred ? 1 : 0);
  unsigned m = 0;
  for (int i = 0; i < 32; ++i)
    m |= unsigned(row[i] != 0) << i;
  return m;
}
inline bool __any_sync(unsigned mask, bool pred) { return __ballot_sync(mask, pred) != 0; }
inline unsigned __match_any_sync(unsigned, unsigned long long key)
{
  const unsigned long long* row = post(key);
  unsigned m = 0;
  for (int i = 0; i < 32; ++i)
    m |= unsigned(row[i] == key) << i;
  return m;
}
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __ffs(int v) { return __builtin_ffs(v); }
inline int __ffsll(long long v) { return __builtin_ffsll(v); }
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
// run f() on every thread of `blocks` blocks of `threads` threads (a
// multiple of 32), one block at a time
template <class F> void run_grid(int blocks, int threads, F f)
{
  blockDim.x = threads;
  gridDim.x = blocks;
  g_body = f;
  for (int b = 0; b < blocks; ++b)
  {
    blockIdx.x = b;
    g_block_waiting = 0;
    for (int t = 0; t < threads; ++t)
    {
      Fiber& fb = g_fiber[t];
      fb.started = fb.done = false;
      fb.ready = true;
      fb.stack.resize(1 << 16);
      g_phase[t] = 0;
      g_warp_waiting[t / 32] = 0;
    }
    for (int live = threads; live > 0;)
    {
      bool ran = false;
      for (int t = 0; t < threads; ++t)
      {
        Fiber& fb = g_fiber[t];
        if (fb.done || !fb.ready)
          continue;
        ran = true;
        g_cur = t;
        threadIdx.x = t;
        if (!_setjmp(g_sched))
        {
          if (fb.started)
            _longjmp(fb.jb, 1);
          fb.started = true;
          getcontext(&fb.ctx);
          fb.ctx.uc_stack.ss_sp = fb.stack.data();
          fb.ctx.uc_stack.ss_size = fb.stack.size();
          fb.ctx.uc_link = nullptr;
          makecontext(&fb.ctx, fiber_main, 0);
          ucontext_t here;
          swapcontext(&here, &fb.ctx);
        }
        live -= fb.done;
      }
      if (!ran)
        std::exit(5);  // every live thread waits: a warp parted at a warp-wide call
    }
  }
}
"""

# Each variant's output is written in turn: the scoring body at (entries
# of the site-level block in shared memory, rows a lane) on a grid of 3
# blocks of 2 warps, so every warp strides over several steps of rows; the
# pileup body once, a thread a row.
HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include "cuda_runtime.h"
#include "scoring_body.cuh"
namespace { unsigned long long ss_site[1 << 16]; }
namespace pileup {
#include "pileup_body.cuh"
}

constexpr int GUARD = 64;  // entries past the output, which no add may reach
constexpr int BLOCKS = 3, THREADS = 64;

template <class T> std::vector<T> load(const char* path, size_t n)
{
  std::vector<T> v(n);
  FILE* f = fopen(path, "rb");
  if (!f || fread(v.data(), sizeof(T), n, f) != n)
    exit(2);
  fclose(f);
  return v;
}

template <int FA, bool SMEM, bool AGG>
void scoring(const int32_t* obs, long long N, long long n_samples, const Layout& l, int64_t n_shared,
             int64_t* out, int64_t* u)
{
  run_grid(BLOCKS, THREADS, [&] { scoring_rows_kernel<FA, SMEM, AGG>(obs, N, n_samples, l, n_shared, out, u); });
}

// pass 1 at tier A's FA with the launcher's three instances: a shared copy
// (with the warp's sums), none with them, and none without (group false)
void scoring(int64_t n_shared, bool group, const int32_t* obs, long long N, long long n_samples,
             const Layout& l, int64_t* out, int64_t* u)
{
  with_fold(static_cast<int>(l.A), [&](auto fa) {
    constexpr int FA = decltype(fa)::value;
    if (n_shared > 0)
      scoring<FA, true, true>(obs, N, n_samples, l, n_shared, out, u);
    else if (group)
      scoring<FA, false, true>(obs, N, n_samples, l, n_shared, out, u);
    else
      scoring<FA, false, false>(obs, N, n_samples, l, n_shared, out, u);
    return 0;
  });
}

// argv: kind in out N, then A n_sites n_samples and the variants, a letter
// each (scoring; with the warp's sums, f keeps the whole site-level block
// in shared memory, p its first third, n none; d none and no warp sums),
// or n_events (pileup: one thread a row, on as many blocks as that takes)
int main(int argc, char** argv)
{
  const long long N = atoll(argv[4]);
  FILE* f = fopen(argv[3], "wb");
  if (!strcmp(argv[1], "scoring"))
  {
    const int A = atoi(argv[5]);
    const long long n_sites = atoll(argv[6]), n_samples = atoll(argv[7]);
    const auto obs = load<int32_t>(argv[2], 14 * N);
    const Layout l = layout(A, n_sites, n_samples);
    if ((size_t)(l.size - l.clip_reads) > sizeof(ss_site) / 8)
      return 3;
    const int64_t entries = l.size - l.clip_reads;
    for (int i = 8; i < argc; ++i)
    {
      const char share = argv[i][0];
      const int64_t n_shared = share == 'f' ? entries : share == 'p' ? std::max<int64_t>(1, entries / 3) : 0;
      const bool group = share != 'd';
      std::vector<int64_t> out(l.size + GUARD, 0), u(l.S * A + GUARD, 0);
      scoring(n_shared, group, obs.data(), N, n_samples, l, out.data(), u.data());
      if (!folds(A))
        run_grid(BLOCKS, THREADS, [&] { scoring_triangle_kernel(l, out.data(), u.data()); });
      for (int g = 0; g < GUARD; ++g)
        if (u[l.S * A + g] || (folds(A) && u[g]))
          return 4;  // an add past u, or into u at a folded tier
      fwrite(out.data(), sizeof(int64_t), out.size(), f);
    }
  }
  else
  {
    const long long n_events = atoll(argv[5]);
    const auto mat = load<int64_t>(argv[2], 6 * N);
    std::vector<int64_t> out(8 * n_events + GUARD, 0);
    run_grid((N + THREADS - 1) / THREADS, THREADS,
             [&] { pileup::discovery_pileup_kernel(mat.data(), N, n_events, out.data()); });
    fwrite(out.data(), sizeof(int64_t), out.size(), f);
  }
  fclose(f);
  return 0;
}
"""


def _body(name, flip=None):
    """The source up to the end of its anonymous namespace, without its
    #include lines (the stub and the harness include what it needs), with
    `flip` = (old, new) replaced once."""
    src = (CSRC / name).read_text()
    src = src[: src.index(BODY_END) + len(BODY_END)]
    if flip is not None:
        assert src.count(flip[0]) == 1, flip[0]
        src = src.replace(*flip)
    return "".join(line for line in src.splitlines(True) if not line.startswith("#include"))


def _build(d, flip=None):
    """The harness in directory d, with `flip` applied to the source whose
    name it names: (file name, old, new)."""
    d.mkdir(parents=True, exist_ok=True)
    (d / "cuda_runtime.h").write_text(STUB)
    for name, header in (("site_scoring.cu", "scoring_body.cuh"), ("discovery_pileup.cu", "pileup_body.cuh")):
        (d / header).write_text(_body(name, flip[1:] if flip and flip[0] == name else None))
    (d / "harness.cpp").write_text(HARNESS)
    exe = d / "emulated"
    # _FORTIFY_SOURCE would check each _longjmp for a jump up its own stack
    subprocess.run(["g++", "-std=c++17", "-O2", "-U_FORTIFY_SOURCE", "-Wno-unknown-pragmas", "-I", str(d),
                    "-o", str(exe), str(d / "harness.cpp")], check=True, capture_output=True, text=True)
    return d, exe


@pytest.fixture(scope="module")
def emulated(gxx, tmp_path_factory):
    return _build(tmp_path_factory.mktemp("scoring_kernels"))


GUARD = 64  # the harness's zeroed entries past the output
RUN_TIMEOUT_S = 600


def _run(emulated, kind, mat, params, variants):
    """The emulated body's output for each of `variants`, in order."""
    d, exe = emulated
    src, dst = d / f"in_{kind}.bin", d / f"out_{kind}.bin"
    src.write_bytes(np.ascontiguousarray(mat).tobytes())
    subprocess.run([str(exe), kind, str(src), str(dst), str(mat.shape[1]), *map(str, params), *variants],
                   check=True, timeout=RUN_TIMEOUT_S)
    outs = np.frombuffer(dst.read_bytes(), dtype=np.int64).reshape(len(variants), -1)
    for out in outs:
        assert not out[-GUARD:].any(), "an add landed past the output"
    return outs[:, :-GUARD]


#: with the warp's sums, the site-level block in shared memory: all of it
#: (f), its first third (p: the card's prefix where the block does not fit)
#: and none (n); and none without the warp's sums (d: a flush under
#: GROUP_MIN_ROWS rows)
SCORING_VARIANTS = ("f", "p", "n", "d")
GROUPING_VARIANTS = ("f", "p", "n")


def _check_scoring(emulated, mat, A, shape=SCORING_SHAPE):
    want = _plain_vector(mat, A, *shape)
    for variant, got in zip(SCORING_VARIANTS, _run(emulated, "scoring", mat, (A, *shape), SCORING_VARIANTS)):
        np.testing.assert_array_equal(got, want, err_msg=f"site-level block in shared memory: {variant}")


def _check_pileup(emulated, mat, n_events):
    want = discovery_pileup.segment_counters_plain(torch.from_numpy(mat), n_events).numpy()
    np.testing.assert_array_equal(_run(emulated, "pileup", mat, (n_events,), [""])[0].reshape(n_events, 8), want)




@pytest.mark.parametrize("A", ALLELE_TIERS)
def test_emulated_scoring_kernel_matches_plain(emulated, A):
    _check_scoring(emulated, scoring_rows(A, 5), A)


@pytest.mark.parametrize("A", ALLELE_TIERS)
@pytest.mark.parametrize("order", ORDERS[1:])
def test_emulated_scoring_kernel_row_orders(emulated, order, A):
    """Runs of one segment (sorted, reversed) and one segment for all rows,
    where the warp's groups are large."""
    _check_scoring(emulated, scoring_order(scoring_rows(A, 6, n_random=400), order), A)


@pytest.mark.parametrize("A", (2, 64))
def test_emulated_scoring_kernel_many_sites(emulated, A):
    """More sites than the adversarial shape: flush_matrix's rows over 97
    sites x 5 samples (the site-level block at A 64 is 97 x 514 entries,
    390 KB: the card keeps it in global memory, the emulation runs both)."""
    shape = (97, 5)
    mat = flush_matrix(1024, A, *shape, seed=A)
    if A == 64:
        mat = mat[:, :512]  # the bit loops run once a set bit or pair a warp step
    _check_scoring(emulated, np.ascontiguousarray(mat), A, shape)


@pytest.mark.parametrize("seed,n,n_events", [(0, 5000, 300), (4, 700, 2000)])
def test_emulated_pileup_kernel_matches_plain(emulated, seed, n, n_events):
    _check_pileup(emulated, pileup_rows(seed, n, n_events), n_events)


@pytest.mark.parametrize("order", ("random", "sorted", "reversed", "one_event"))
def test_emulated_pileup_kernel_row_orders(emulated, order):
    """The four orders, at N a multiple of the block and not; one_event
    puts every row, the overflow rows too, on event n_events // 2."""
    n_events = 200
    mat = pileup_rows(8, 3008, n_events)
    _check_pileup(emulated, pileup_order(mat, order, n_events), n_events)
    _check_pileup(emulated, pileup_order(np.ascontiguousarray(mat[:, :-5]), order, n_events), n_events)


def large_scalars(A):
    """One segment of rows whose clip, mismatch and score-diff columns sit
    at the ends of int32, so that the sums of a group pass 32 bits."""
    mat = scoring_order(scoring_rows(A, 9, n_random=200), "one_segment")
    real = mat[F["cov"]] != site_scoring.COV_PAD
    for k, v in (("clipped_scaled", 2**31 - 1), ("mm_scaled", -(2**31)), ("sdiff", 2**31 - 1)):
        mat[F[k], real] = v
    return mat


FLIPS = {  # (file, the rule, its flip, the batch that must show it)
    "leader_skips_a_peer": ("site_scoring.cu", "unsigned above = peers & ~((2u << lane) - 1);",
                            "unsigned above = peers & ~((4u << lane) - 1);",
                            lambda: ("scoring", scoring_order(scoring_rows(2, 6, n_random=200), "sorted"), 2)),
    "sum_cut_to_32_bits": ("site_scoring.cu", "__shfl_sync(FULL, static_cast<long long>(v[k])",
                           "__shfl_sync(FULL, static_cast<int>(v[k])", lambda: ("scoring", large_scalars(2), 2)),
    "pileup_maxima_summed": ("discovery_pileup.cu", "v[k] = k < N_SUMS ?", "v[k] = k <= N_SUMS ?",
                             lambda: ("pileup", pileup_order(pileup_rows(8, 800, 50), "sorted", 50), 50)),
}


def test_emulated_scoring_kernel_on_large_scalars(emulated):
    """Group sums past 32 bits are exact (the batch of the 32-bit flip)."""
    for A in (2, 64):
        _check_scoring(emulated, large_scalars(A), A)


@pytest.mark.parametrize("flip", sorted(FLIPS))
def test_emulated_flipped_rule_fails(emulated, tmp_path, flip):
    """Each flip of a pre-reduction rule, in a temporary copy, must change
    the output of its batch in every variant that sums in the warp; the
    body as it is gets the batch right."""
    name, old, new, batch = FLIPS[flip]
    kind, mat, param = batch()
    flipped = _build(tmp_path / "flipped", (name, old, new))
    if kind == "scoring":
        _check_scoring(emulated, mat, param)
        want = _plain_vector(mat, param, *SCORING_SHAPE)
        outs = _run(flipped, kind, mat, (param, *SCORING_SHAPE), GROUPING_VARIANTS)
    else:
        _check_pileup(emulated, mat, param)
        want = discovery_pileup.segment_counters_plain(torch.from_numpy(mat), param).numpy().reshape(-1)
        outs = _run(flipped, kind, mat, (param,), [""])
    assert all((out != want).any() for out in outs), f"the flip {flip} went unseen"


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
