// Device-resident alignment verdicts: one thread per read-orientation row.
//
// Replaces graphtyper_tpu/ops/device_align.py _verdicts_impl (:107, the
// jitted XLA op the JAX package launches once per pool and call iteration,
// or once per streaming batch). Same function, bit for bit in all 9 output
// columns of every row, clean or not: meta = clean | min(mm, 7) << 1 |
// min(nv, 6) << 4, the chain's start and end as uint32 bit patterns, and the
// first 6 crossed variant labels var_id + (kmer << 24), -1 when empty.
//
// Per row, in the order of _verdicts_impl:
//   1. each kmer the read has: a lower_bound of its key inside its prefix
//      bucket (:142-145), the found test, its label span (:146-151);
//   2. up to 6 of its labels: one span (:154-166), the chain link to the
//      kmer before (:172-173), the variant payload in flat order
//      kmer * 6 + slot (:216-226);
//   3. the right tail: an upper_bound of chain_end over the reference node
//      starts (:183-196), then the tail's mismatches against the node's
//      arena bases and its tag codes (:198-213).
// Kmers past the read's own count (nk_r) reach no output, except kmer 0
// whose first label gives the start even when nk_r = 0, so the loop runs
// over max(nk_r, 1) kmers and needs no per-kmer arrays: any nk is taken.
// Every binary search runs the JAX package's fixed number of halvings with
// its `mid < hi` guard and `min(mid, n - 1)` clamp, so the index is the
// same on every input. Every gather clamps its index as jnp.clip does. The
// int32 sums that can wrap in the JAX code (lv + (kmer << 24), the tail's
// arena index, off_in_node + tail_len) are done in uint32 and cast, since
// signed overflow is undefined in C++. The wrapper refuses empty tables
// (the JAX gathers raise on them).
//
// What bounds it. Per row the kernel reads 9 nk + 36 bytes of its own (at
// nk = 4, 72 bytes) and writes 36; the tables (index keys, labels, buckets,
// reference nodes and arena) are read where the searches lead, and at the
// sizes of one pool (a few MB) they sit in the 50 MB L2. At 2^19 rows the
// bytes give about 0.017 ms at 3.35 TB/s; the integer work of the searches,
// the label checks and the 32-base tail is of the same order on 132 SMs x
// 64 int32 lanes (chip_smoke.py counts both and prints the larger). In
// practice each row is a chain of dependent gathers (about key_steps + 2
// per kmer, ref_steps for the tail), so the design keeps many rows in
// flight: one thread per row, 256 threads a block, a grid-stride loop, all
// state in registers, tables read through the read-only path (__ldg), and
// the tail's 32 read bases fetched as two 16-byte loads.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int K = 32;
constexpr int LABEL_CAP = 6;
constexpr int VAR_SLOTS = 6;
constexpr int TAIL_PAD = 32;
constexpr int OUT_COLS = 9;
constexpr uint32_t SPECIAL_START = 0xD0000000u;
constexpr int VAR_ID_BITS = 24;
constexpr int BUCKET_BITS = 14;
constexpr int DA_THREADS = 256;

struct Tables
{
  const uint32_t* __restrict__ keys_hi;    // [n_keys] sorted index keys, high halves
  const uint32_t* __restrict__ keys_lo;    // [n_keys]
  const int32_t* __restrict__ offsets;     // [n_keys + 1] label spans
  const uint32_t* __restrict__ lab_start;  // [n_labels]
  const uint32_t* __restrict__ lab_end;    // [n_labels]
  const int32_t* __restrict__ lab_var;     // [n_labels], -1: no variant
  const int32_t* __restrict__ bucket;      // [2^BUCKET_BITS + 1] prefix buckets of the keys
  const uint32_t* __restrict__ ref_order;  // [n_ref] reference node starts, sorted
  const int32_t* __restrict__ ref_len;     // [n_ref] node lengths
  const int32_t* __restrict__ ref_start;   // [n_ref] node offsets in the arena
  const uint8_t* __restrict__ ref_arena;   // [n_arena] node bases
  int n_keys, n_labels, n_ref, n_arena, key_steps, ref_steps;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// graphtyper_tpu/ops/device_align.py:81 _lower_bound_u64: exactly `steps`
// halvings of [lo, hi) for the first i with keys[i] >= (qh, ql). A null
// `kh` stands for a table of zero high halves (the reference search).
__device__ __forceinline__ int lower_bound_u64(uint32_t qh, uint32_t ql, const uint32_t* kh,
                                               const uint32_t* kl, int n, int steps, int lo, int hi)
{
  for (int s = 0; s < steps; ++s)
  {
    const int mid = (lo + hi) >> 1;
    const int midc = min(mid, n - 1);
    const uint32_t mh = kh != nullptr ? __ldg(kh + midc) : 0u;
    const uint32_t ml = __ldg(kl + midc);
    const bool less = mh < qh || (mh == qh && ml < ql);
    const int next_lo = less && mid < hi ? mid + 1 : lo;
    hi = less ? hi : min(hi, mid);
    lo = next_lo;
  }
  return lo;
}

__device__ __forceinline__ void verdict_row(const uint32_t* __restrict__ hi,
                                            const uint32_t* __restrict__ lo,
                                            const uint8_t* __restrict__ valid,
                                            const uint8_t* __restrict__ tails,
                                            const int32_t* __restrict__ lens, const Tables& t,
                                            int32_t* __restrict__ out, int row, int nk)
{
  const int len = lens[row];
  const int nk_r = min(len >= K ? 1 + (len - K) / (K - 1) : 0, nk);
  const int last = max(nk_r - 1, 0);

  bool all_ok = true, chain_ok = true, small_ids = true;
  uint32_t start = 0, chain_end = 0, prev_le0 = 0;
  int nv = 0;
  int32_t slot[VAR_SLOTS];
#pragma unroll
  for (int j = 0; j < VAR_SLOTS; ++j)
    slot[j] = -1;

  for (int k = 0; k <= last; ++k)
  {
    const bool in_read = k < nk_r;
    const int64_t o = (int64_t)row * nk + k;
    const uint32_t qh = hi[o], ql = lo[o];
    const int b = (int)(qh >> (32 - BUCKET_BITS));
    const int pos = lower_bound_u64(qh, ql, t.keys_hi, t.keys_lo, t.n_keys, t.key_steps,
                                    __ldg(t.bucket + b), __ldg(t.bucket + b + 1));
    const int posc = min(pos, t.n_keys - 1);
    const bool found = pos < t.n_keys && __ldg(t.keys_hi + posc) == qh && __ldg(t.keys_lo + posc) == ql;
    const int a = __ldg(t.offsets + posc);
    const int size = found ? __ldg(t.offsets + min(posc + 1, t.n_keys)) - a : 0;

    // the first label gives the kmer's span; labels past `size` are off
    const int l0 = clampi(a, 0, t.n_labels - 1);
    const uint32_t ls0 = __ldg(t.lab_start + l0), le0 = __ldg(t.lab_end + l0);
    bool same_span = true;
    for (int s = 0; s < min(size, LABEL_CAP); ++s)
    {
      const int li = clampi(a + s, 0, t.n_labels - 1);
      if (s > 0 && (__ldg(t.lab_start + li) != ls0 || __ldg(t.lab_end + li) != le0))
        same_span = false;
      if (!in_read)
        continue;
      const int32_t lv = __ldg(t.lab_var + li);
      if (lv < 0)
        continue;
      if (lv >= (1 << VAR_ID_BITS))
        small_ids = false;
      const int32_t v = (int32_t)((uint32_t)lv + ((uint32_t)k << VAR_ID_BITS));
#pragma unroll
      for (int j = 0; j < VAR_SLOTS; ++j)
        if (j == nv)
          slot[j] = v;
      ++nv;
    }

    const bool kmer_ok = valid[o] != 0 && found && size >= 1 && size <= LABEL_CAP && same_span;
    if (in_read && !kmer_ok)
      all_ok = false;
    if (k == 0)
      start = ls0;
    else if (in_read && prev_le0 != ls0)
      chain_ok = false;
    prev_le0 = le0;
    if (k == last)
      chain_end = le0;
  }

  // right-tail extension inside one reference node
  const int tail_len = max(len - 1 - 31 * nk_r, 0);
  const bool has_tail = tail_len > 0;
  int mm = 0;
  bool tail_ok = true;
  if (has_tail)
  {
    // upper_bound(chain_end) == lower_bound(chain_end + 1), in uint32
    const int r = lower_bound_u64(0u, chain_end + 1u, nullptr, t.ref_order, t.n_ref, t.ref_steps,
                                  0, t.n_ref) - 1;
    const int rc = clampi(r, 0, t.n_ref - 1);
    const uint32_t node_order = __ldg(t.ref_order + rc);
    const int32_t node_len = __ldg(t.ref_len + rc);
    const int32_t off = (int32_t)(chain_end - node_order);
    const bool in_node = r >= 0 && chain_end >= node_order && off < node_len;
    const bool tail_fits = (int32_t)((uint32_t)off + (uint32_t)tail_len) < node_len;
    const uint32_t base = (uint32_t)__ldg(t.ref_start + rc) + (uint32_t)off + 1u;

    const uint4* tq = reinterpret_cast<const uint4*>(tails + (int64_t)row * TAIL_PAD);
    const uint4 t0 = tq[0], t1 = tq[1];
    const uint32_t words[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
    bool no_tag = true;
#pragma unroll
    for (int i = 0; i < TAIL_PAD; ++i)
    {
      if (i < tail_len)
      {
        const int idx = clampi((int32_t)(base + (uint32_t)i), 0, t.n_arena - 1);
        const uint32_t rb = __ldg(t.ref_arena + idx);
        const uint32_t qb = (words[i / 4] >> (8 * (i % 4))) & 0xffu;
        if (qb != rb && qb < 4 && rb < 4)
          ++mm;
        if (rb == 6)
          no_tag = false;
      }
    }
    const int budget = min(2 + (tail_len + 1) / 11, 7);
    tail_ok = in_node && tail_fits && no_tag && mm <= budget && mm <= 2;
  }

  // a Hamming-1 fork at a crossed site can tie only when mm >= 1
  const bool safety = mm == 0 || nv == 0;
  const bool two_kmer_ok = nk_r >= 3 || mm <= 1;
  const bool verdict = all_ok && nk_r >= 2 && chain_ok && chain_end < SPECIAL_START && tail_ok
                       && nv <= VAR_SLOTS && small_ids && safety && two_kmer_ok;
  const uint32_t end = has_tail ? chain_end + (uint32_t)tail_len : chain_end;

  int32_t* dst = out + (int64_t)row * OUT_COLS;
  dst[0] = (verdict ? 1 : 0) | (min(mm, 7) << 1) | (min(nv, VAR_SLOTS) << 4);
  dst[1] = (int32_t)start;
  dst[2] = (int32_t)end;
#pragma unroll
  for (int j = 0; j < VAR_SLOTS; ++j)
    dst[3 + j] = slot[j];
}

__global__ void __launch_bounds__(DA_THREADS)
device_align_kernel(const uint32_t* __restrict__ hi,     // [S][nk] exact kmer keys, high halves
                    const uint32_t* __restrict__ lo,     // [S][nk]
                    const uint8_t* __restrict__ valid,   // [S][nk]
                    const uint8_t* __restrict__ tails,   // [S][TAIL_PAD] read codes, pad 15
                    const int32_t* __restrict__ lens,    // [S]
                    Tables t,
                    int32_t* __restrict__ out,           // [S][OUT_COLS]
                    int S, int nk)
{
  for (int row = blockIdx.x * blockDim.x + threadIdx.x; row < S; row += gridDim.x * blockDim.x)
    verdict_row(hi, lo, valid, tails, lens, t, out, row, nk);
}

}  // namespace

// Plain C entry point, bound with ctypes (graphtyper_tpu_torch/kernels.py).
// Row inputs hi, lo, valid [S][nk], tails [S][32] (16-byte aligned), lens [S];
// the tables as graphtyper_tpu_torch/ops/device_align.py DeviceAligner holds
// them, each non-empty; out [S][9] int32; S * nk < 2^30. Launches on `stream`, allocates
// nothing, does not synchronise; returns cudaGetLastError() of the launch.
extern "C" int gt_device_align(const uint32_t* hi, const uint32_t* lo, const uint8_t* valid,
                               const uint8_t* tails, const int32_t* lens,
                               const uint32_t* keys_hi, const uint32_t* keys_lo,
                               const int32_t* offsets, const uint32_t* lab_start,
                               const uint32_t* lab_end, const int32_t* lab_var,
                               const int32_t* bucket, const uint32_t* ref_order,
                               const int32_t* ref_len, const int32_t* ref_start,
                               const uint8_t* ref_arena, int32_t* out, int S, int nk, int n_keys,
                               int n_labels, int n_ref, int n_arena, int key_steps, int ref_steps,
                               void* stream)
{
  if (S <= 0)
    return 0;
  if (nk <= 0 || (int64_t)S * nk >= (1ll << 30) || n_keys <= 0 || n_labels <= 0 || n_ref <= 0
      || n_arena <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tables t{keys_hi, keys_lo, offsets, lab_start, lab_end, lab_var, bucket, ref_order,
                 ref_len, ref_start, ref_arena, n_keys, n_labels, n_ref, n_arena, key_steps,
                 ref_steps};
  const int blocks = min((S + DA_THREADS - 1) / DA_THREADS, 1 << 16);
  device_align_kernel<<<blocks, DA_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
    hi, lo, valid, tails, lens, t, out, S, nk);
  return static_cast<int>(cudaGetLastError());
}
