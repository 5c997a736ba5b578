"""The verdict kernel's body (csrc/device_align.cu, the code before the end
of its anonymous namespace) compiled for the CPU with g++ against a stub
CUDA runtime and run block by block (three blocks of 64 threads striding
over the rows, each thread a std::thread), held exactly to
`verdicts_plain` on the synthetic adversarial batches and on the
arena-edge batch at nk = 2, 4 and 8.
The kernel's searches, run on their own, equal the true lower_bound of
their range (numpy's searchsorted) and the JAX package's
`_lower_bound_u64`. Three rules are flipped in a temporary copy, and each
flip must show:
  * the `mid < hi` guard of the lower_bound. Past convergence it only moves
    an index that is already past the table's end further out, which the
    clamps then map to the same entry, so no verdict row can see it; the
    check holds the kernel's searches to the JAX package's on the batch's
    keys and chain ends, where the flip must change an index;
  * the -1 of an empty payload slot, which must change the verdict rows;
  * the upper end of the tail's arena clamp, which must change the meta
    column of a row whose tail runs past the arena's end.
The count of loads from the tables that tools/bench_align.py
`verdict_gathers` gives chip_smoke.py's "gather" line equals the body's own
count of its `__ldg`s on the same rows.
The kernel itself is held on the card (tests/test_torch_ops_cuda.py)."""

import pathlib
import subprocess
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphtyper_tpu.ops import device_align as ref_device_align
from graphtyper_tpu_torch.ops import device_align
from graphtyper_tpu_torch.ops.device_align import DeviceAligner, verdicts_plain
from graphtyper_tpu_torch.tools.bench_align import verdict_gathers
from test_torch_device_align_batches import arena_edge_index, arena_edge_rows, synthetic_index, synthetic_rows
from test_torch_sw_row_emulated import gxx  # noqa: F401 (fixture)

SOURCE = pathlib.Path(__file__).resolve().parent.parent / "graphtyper_tpu_torch" / "csrc" / "device_align.cu"
BODY_END = "}  // namespace\n"
ARENA_PAD = 64  # bytes of code 5 the harness puts after the packed arena

# what the kernel bodies need of the CUDA runtime: blocks of blockDim.x
# threads run one after another; __syncthreads is a barrier of the block,
# and each warp's shuffles and ballots meet at a barrier of the warp
STUB = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cstdint>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(...)
#define __restrict__
using std::max;
using std::min;
struct dim_ { unsigned x; };
inline thread_local dim_ threadIdx, blockIdx;
inline dim_ blockDim{32}, gridDim{1};
struct uint4 { unsigned x, y, z, w; };
struct int4 { int x, y, z, w; };
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) { return {x, y, z, w}; }
inline std::atomic<long long> g_loads{0};  // __ldg calls, every thread's
template <class T> inline T __ldg(const T* p)
{
  ++g_loads;
  return *p;
}
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned s)
{
  s &= 31;
  return s ? (lo >> s) | (hi << (32 - s)) : lo;
}
constexpr int MAX_WARPS = 32;
inline std::barrier<>* g_block_bar;
inline std::barrier<>* g_warp_bar[MAX_WARPS];
inline unsigned g_slot[MAX_WARPS][32];
inline void __syncthreads() { g_block_bar->arrive_and_wait(); }
inline unsigned exchange(unsigned v, int src)
{
  const int w = threadIdx.x / 32;
  g_slot[w][threadIdx.x % 32] = v;
  g_warp_bar[w]->arrive_and_wait();
  const unsigned r = g_slot[w][src];
  g_warp_bar[w]->arrive_and_wait();
  return r;
}
template <class T> inline T __shfl_sync(unsigned, T v, int src) { return (T)exchange((unsigned)v, src & 31); }
inline unsigned __ballot_sync(unsigned, bool pred)
{
  const int w = threadIdx.x / 32;
  g_slot[w][threadIdx.x % 32] = pred ? 1 : 0;
  g_warp_bar[w]->arrive_and_wait();
  unsigned m = 0;
  for (int i = 0; i < 32; ++i)
    m |= unsigned(g_slot[w][i] != 0) << i;
  g_warp_bar[w]->arrive_and_wait();
  return m;
}
// run f() on every thread of `blocks` blocks of `threads` threads (a
// multiple of 32), one block at a time
template <class F> void run_grid(int blocks, int threads, F f)
{
  blockDim.x = threads;
  gridDim.x = blocks;
  for (int b = 0; b < blocks; ++b)
  {
    std::barrier<> block_bar(threads);
    g_block_bar = &block_bar;
    std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
    for (int w = 0; w < threads / 32; ++w)
    {
      warp_bars.emplace_back(new std::barrier<>(32));
      g_warp_bar[w] = warp_bars.back().get();
    }
    std::vector<std::thread> pool;
    for (int i = 0; i < threads; ++i)
      pool.emplace_back([&f, b, i] {
        threadIdx.x = i;
        blockIdx.x = b;
        f();
      });
    for (auto& t : pool)
      t.join();
  }
}
"""

HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "cuda_runtime.h"
#include "body.inc"
}  // namespace

template <class T> std::vector<T> rd(FILE* f, size_t n, size_t extra = 0)
{
  std::vector<T> v(n + extra, T(5));
  if (n && std::fread(v.data(), sizeof(T), n, f) != n)
    std::exit(1);
  return v;
}

int main(int, char** argv)
{
  FILE* f = std::fopen(argv[1], "rb");
  int h[10];  // S, nk, n_keys, n_labels, n_ref, n_arena, arena bytes, key_steps, ref_steps, mode
  if (std::fread(h, 4, 10, f) != 10)
    return 1;
  const int S = h[0], nk = h[1];
  auto key_rec = rd<uint4>(f, h[2]);
  auto lab_rec = rd<int4>(f, h[3]);
  auto bucket = rd<int32_t>(f, (1 << BUCKET_BITS) + 1);
  auto ref_rec = rd<int4>(f, h[4]);
  auto arena = rd<uint8_t>(f, h[6], 64);
  const Tables t{key_rec.data(), lab_rec.data(), bucket.data(), ref_rec.data(), arena.data(),
                 h[2], h[3], h[4], h[5], h[7], h[8]};
  std::vector<int32_t> out;
  if (h[9] == 0)  // the kernel over S rows: 3 blocks of 2 warps stride over them
  {
    auto hi = rd<uint32_t>(f, (size_t)S * nk), lo = rd<uint32_t>(f, (size_t)S * nk);
    auto valid = rd<uint8_t>(f, (size_t)S * nk);
    auto tails = rd<uint8_t>(f, (size_t)S * TAIL_PAD);
    auto lens = rd<int32_t>(f, S);
    out.resize((size_t)S * OUT_COLS);
    run_grid(3, 64, [&] {
      device_align_kernel(hi.data(), lo.data(), valid.data(), tails.data(), lens.data(), t,
                          out.data(), S, nk);
    });
    const long long loads = g_loads;  // appended as two int32 words, low first
    out.push_back((int32_t)(uint32_t)loads);
    out.push_back((int32_t)(uint32_t)(loads >> 32));
  }
  else  // its two searches on S queries: the key's in its bucket, and chain_end + 1's
  {
    auto qh = rd<uint32_t>(f, S), ql = rd<uint32_t>(f, S), qe = rd<uint32_t>(f, S);
    out.resize(2 * (size_t)S);
    for (int i = 0; i < S; ++i)
    {
      uint64_t q[KG] = {(uint64_t)qh[i] << 32 | ql[i]};
      int lb[KG];
      key_searches(t, q, 1, lb);
      out[2 * i] = lb[0];
      out[2 * i + 1] = ref_search(t, qe[i]);
    }
  }
  std::fclose(f);
  f = std::fopen(argv[2], "wb");
  std::fwrite(out.data(), 4, out.size(), f);
  std::fclose(f);
  return 0;
}
"""

RULES = {
    "mid_lt_hi_guard": ("less && mid < hi ? mid + 1 : lo", "less ? mid + 1 : lo"),
    "empty_slot": ("slot[j] = -1;", "slot[j] = 0;"),
    "arena_clamp": ("clampi((int32_t)(base + (uint32_t)i), 0, t.n_arena - 1)",
                    f"clampi((int32_t)(base + (uint32_t)i), 0, t.n_arena + {ARENA_PAD - 1})"),
}


def build_body(directory: pathlib.Path, source: pathlib.Path, harness: str, name: str,
               rule: tuple[str, str] | None = None) -> pathlib.Path:
    """Compile `source` up to the end of its anonymous namespace with
    `harness` against the stub runtime; `rule` = (old, new) is replaced in
    the body first and must occur once."""
    body = source.read_text().split(BODY_END)[0].replace("#include <cuda_runtime.h>", "")
    if rule is not None:
        old, new = rule
        assert body.count(old) == 1, old
        body = body.replace(old, new)
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "cuda_runtime.h").write_text(STUB)
    (directory / "body.inc").write_text(body)
    (directory / "harness.cpp").write_text(harness)
    exe = directory / name
    subprocess.run(["g++", "-std=c++20", "-O1", "-fno-strict-aliasing", "-pthread", "-I",
                    str(directory), str(directory / "harness.cpp"), "-o", str(exe)],
                   check=True, timeout=300)
    return exe


def _run(exe: pathlib.Path, arrays, n_out: int) -> np.ndarray:
    src, dst = exe.parent / "in.bin", exe.parent / "out.bin"
    with open(src, "wb") as f:
        for a in arrays:
            np.ascontiguousarray(a).tofile(f)
    subprocess.run([str(exe), str(src), str(dst)], check=True, timeout=300)
    out = np.fromfile(dst, np.int32)
    assert out.size == n_out
    return out


def _aligner(idx):
    return DeviceAligner(types.SimpleNamespace(**idx), "cpu")


@pytest.fixture(scope="module")
def index():
    idx = synthetic_index(0)
    return idx, _aligner(idx)


@pytest.fixture(scope="module")
def edge_index():
    idx = arena_edge_index(0)
    return idx, _aligner(idx)


def _header(dal, S, nk, mode):
    return np.array([S, nk, dal.n_keys, dal.n_labels, dal.n_ref, dal.n_arena, dal.packed[-1].shape[0],
                     dal.key_steps, dal.ref_steps, mode], np.int32)


def _packed(dal):
    return [t.numpy() for t in dal.packed]


def _emulate_verdicts_and_loads(exe, dal, rows):
    """The body's verdict rows and the number of its __ldg calls."""
    hi, lo, valid, tails, lens = rows
    S, nk = hi.shape
    out = _run(exe, [_header(dal, S, nk, 0), *_packed(dal), hi, lo, valid, tails, lens],
               S * device_align.OUT_COLS + 2)
    loads = int(out[-2].astype(np.uint32)) | int(out[-1].astype(np.uint32)) << 32
    return out[:-2].reshape(S, device_align.OUT_COLS), loads


def _emulate_verdicts(exe, dal, rows):
    return _emulate_verdicts_and_loads(exe, dal, rows)[0]


def _plain(dal, rows):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in rows]
    return verdicts_plain(*t, *dal.tables, key_steps=dal.key_steps, ref_steps=dal.ref_steps).numpy()


@pytest.fixture(scope="module")
def emulated(gxx, tmp_path_factory):
    return build_body(tmp_path_factory.mktemp("device_align"), SOURCE, HARNESS, "device_align_emulated")


@pytest.mark.parametrize("nk", [2, 4, 8])
def test_emulated_kernel_matches_plain(emulated, index, nk):
    idx, dal = index
    rows = synthetic_rows(idx, nk, seed=nk)
    got = _emulate_verdicts(emulated, dal, rows)
    np.testing.assert_array_equal(got, _plain(dal, rows))
    assert (got[:, 0] & 1).sum() > 0  # some rows are clean


@pytest.mark.parametrize("nk", [2, 4, 8])
def test_emulated_kernel_matches_plain_at_the_arena_edges(emulated, edge_index, nk):
    idx, dal = edge_index
    rows = arena_edge_rows(idx, nk, seed=nk)
    np.testing.assert_array_equal(_emulate_verdicts(emulated, dal, rows), _plain(dal, rows))


@pytest.mark.parametrize("nk", [2, 4, 8])
@pytest.mark.parametrize("batch", ["adversarial", "arena_edge"])
def test_verdict_gathers_counts_the_kernels_loads(emulated, index, edge_index, batch, nk):
    """verdict_gathers, the count behind the "gather" line's time at the
    ceiling, is the body's own number of table loads, also for rows whose
    tails read byte by byte past either end of the arena."""
    idx, dal = index if batch == "adversarial" else edge_index
    rows = (synthetic_rows if batch == "adversarial" else arena_edge_rows)(idx, nk, seed=nk)
    got, loads = _emulate_verdicts_and_loads(emulated, dal, rows)
    assert loads == verdict_gathers(dal, rows, got, len(rows[-1]))


def _search_queries(idx, dal):
    """The batch's kmer keys and the chain ends + 1 of its labels (uint32),
    paired up to one length."""
    hi, lo, *_ = synthetic_rows(idx, 4, seed=4)
    qh, ql = hi.reshape(-1), lo.reshape(-1)
    ends = (dal.tables[4].numpy().astype(np.uint64) + 1).astype(np.uint32)
    qe = np.resize(ends, qh.shape[0])
    return qh, ql, qe


def _emulate_searches(exe, dal, qh, ql, qe):
    return _run(exe, [_header(dal, len(qh), 4, 1), *_packed(dal), qh, ql, qe], 2 * len(qh))


def _reference_search(dal, qh, ql, qe):
    """graphtyper_tpu/ops/device_align.py _lower_bound_u64, as its verdicts
    call it."""
    kh, kl, bucket, ref_order = (jnp.asarray(dal.tables[i].numpy()) for i in (0, 1, 6, 7))
    b = jnp.asarray(qh >> np.uint32(32 - device_align.BUCKET_BITS)).astype(jnp.int32)
    pos = ref_device_align._lower_bound_u64(jnp.asarray(qh), jnp.asarray(ql), kh, kl, dal.key_steps,
                                            bounds=(bucket[b], bucket[b + 1]))
    r = ref_device_align._lower_bound_u64(jnp.zeros(qe.shape, jnp.uint32), jnp.asarray(qe),
                                          jnp.zeros_like(ref_order), ref_order, dal.ref_steps)
    return np.stack([np.asarray(pos), np.asarray(r)], axis=1).reshape(-1)


def _true_lower_bounds(dal, qh, ql, qe):
    """The first index in each search's range whose key is not below the
    query, else the range's end: numpy's searchsorted."""
    keys = (dal.tables[0].numpy().astype(np.uint64) << np.uint64(32)) | dal.tables[1].numpy()
    bucket = dal.tables[6].numpy().astype(np.int64)
    q = (qh.astype(np.uint64) << np.uint64(32)) | ql
    b = (qh >> np.uint32(32 - device_align.BUCKET_BITS)).astype(np.int64)
    pos = [lo + np.searchsorted(keys[lo:hi], x) for x, lo, hi in zip(q, bucket[b], bucket[b + 1])]
    r = np.searchsorted(dal.tables[7].numpy(), qe)
    return np.stack([np.array(pos), r], axis=1).reshape(-1)


def test_emulated_searches_are_the_true_lower_bounds(emulated, index):
    """The fixed-step searches have converged when their steps run out: the
    kernel's index is the true lower_bound and the JAX package's, for keys
    past their bucket, the key 0 of padded rows and empty buckets too."""
    idx, dal = index
    qh, ql, qe = _search_queries(idx, dal)
    qh = np.concatenate([qh, [0, 0xFFFFFFFF, 0x12345678]]).astype(np.uint32)
    ql = np.concatenate([ql, [0, 0xFFFFFFFF, 0]]).astype(np.uint32)
    qe = np.concatenate([qe, [0, 0xFFFFFFFF, 1]]).astype(np.uint32)
    bucket = dal.tables[6].numpy()
    b = qh >> np.uint32(32 - device_align.BUCKET_BITS)
    assert (bucket[b] == bucket[b + 1]).any()  # some queries fall in empty buckets
    got = _emulate_searches(emulated, dal, qh, ql, qe)
    np.testing.assert_array_equal(got, _true_lower_bounds(dal, qh, ql, qe))
    np.testing.assert_array_equal(got, _reference_search(dal, qh, ql, qe))


def test_flipped_guard_changes_a_search(gxx, index, tmp_path):
    idx, dal = index
    exe = build_body(tmp_path, SOURCE, HARNESS, "flipped", RULES["mid_lt_hi_guard"])
    qh, ql, qe = _search_queries(idx, dal)
    assert (_emulate_searches(exe, dal, qh, ql, qe) != _reference_search(dal, qh, ql, qe)).any()


def test_flipped_empty_slot_changes_the_verdicts(gxx, index, tmp_path):
    idx, dal = index
    exe = build_body(tmp_path, SOURCE, HARNESS, "flipped", RULES["empty_slot"])
    rows = synthetic_rows(idx, 4, seed=4)
    assert (_emulate_verdicts(exe, dal, rows) != _plain(dal, rows)).any()


def test_flipped_arena_clamp_changes_meta_at_the_arena_end(gxx, edge_index, tmp_path):
    idx, dal = edge_index
    exe = build_body(tmp_path, SOURCE, HARNESS, "flipped", RULES["arena_clamp"])
    rows = arena_edge_rows(idx, 4, seed=4)
    want = _plain(dal, rows)
    changed = _emulate_verdicts(exe, dal, rows)[:, 0] != want[:, 0]
    # the rows that end at the reference's last base (odd rows) read past
    # the arena's end; the flip shows on their meta column only
    assert changed[1::2].any() and not changed[0::2].any()
