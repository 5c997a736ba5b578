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
// over max(nk_r, 1) kmers: any nk is taken. Every gather clamps its index as
// jnp.clip does. The int32 sums that can wrap in the JAX code
// (lv + (kmer << 24), the tail's arena index, off_in_node + tail_len) are
// done in uint32 and cast, since signed overflow is undefined in C++. The
// wrapper refuses empty tables (the JAX gathers raise on them).
//
// The searches. Each runs the JAX package's fixed number of halvings with
// its `mid < hi` guard and `min(mid, n - 1)` clamp (step() below). lo <= hi
// holds throughout, a step with lo < hi halves the range around the true
// lower_bound, and once lo == hi no step moves either end (the guard keeps
// lo, min(hi, mid) keeps hi). key_steps = ceil_log2(largest bucket span +
// 1) and ref_steps = ceil_log2(n_ref + 1) (ops/device_align.py
// DeviceAligner), so every search has converged when its steps run out and
// returns the true lower_bound of its range: the first i in [lo, hi) with
// key[i] >= q, else hi. That holds for padded rows (key 0) and for empty
// buckets (lo == hi from the start); tests/test_torch_device_align_emulated.py
// holds the kernel's searches to numpy's searchsorted on those ranges.
//
// What bounds it. Per row the kernel reads 9 nk + 36 bytes of its own (at
// nk = 4, 72 bytes) and writes 36; the tables are read where the searches
// lead, and at the sizes of one pool (a few MB) they sit in the 50 MB L2.
// At 2^19 rows the bytes give about 0.02 ms at 3.35 TB/s (chip_smoke.py
// counts the bytes and the integer work and prints the larger). In
// practice each row is a chain of dependent gathers, each a sector of its
// own in the L2, so the kernel is bound by the L2's rate of random sector
// reads (chip_smoke.py's "gather" line measures it; verdict_gathers in
// tools/bench_align.py counts this design's loads) and by the chain's
// latency. The design cuts both:
//   * the tables are staged in the layout the kernel reads (DeviceAligner):
//     one 16-byte record a key (key lo, key hi, first label, end of its
//     labels), so a halving reads the 8-byte key in one load and the found
//     test with the label span is one more; one 16-byte record a label
//     (start, end, variant); one 16-byte record a reference node (start,
//     length, arena offset); the arena padded to a multiple of 16 bytes;
//   * the kmers' searches step together, KG at a time, so KG independent
//     loads are in flight a thread, and their first labels load together;
//     KG = 2 keeps every thread's state in 64 registers without spills, so
//     four blocks of 256 threads fit an SM;
//   * the tail's arena bases are read as at most three aligned 16-byte
//     loads when the whole tail lies inside the arena; a tail that reaches
//     past either end reads byte by byte through the clamp;
//   * the tail's 32 read bases are two 16-byte loads;
//   * a kmer's labels past its first (repeats, crossed variants) are rare
//     and load one at a time.
// Measured against the bucket directory and the top levels of the
// reference search in shared memory, filled once a block: on the card the
// fill cost more than the loads it saves (PERF.md), since those loads
// hit the L1 anyway.

#include <algorithm>
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
constexpr int KG = 2;  // kmers whose searches step together
constexpr int DA_THREADS = 256;

struct Tables
{
  const uint4* __restrict__ key_rec;      // [n_keys] key lo, key hi, offsets[i], offsets[i + 1]
  const int4* __restrict__ lab_rec;       // [n_labels] start, end, variant (-1: none), 0
  const int32_t* __restrict__ bucket;     // [2^BUCKET_BITS + 1] prefix buckets of the keys
  const int4* __restrict__ ref_rec;       // [n_ref] node start (sorted), length, arena offset, 0
  const uint8_t* __restrict__ ref_arena;  // [n_arena] node bases, allocated to a multiple of 16
  int n_keys, n_labels, n_ref, n_arena, key_steps, ref_steps;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// one halving of graphtyper_tpu/ops/device_align.py:81 _lower_bound_u64,
// given whether the key at mid is below the query
__device__ __forceinline__ void step(bool less, int mid, int& lo, int& hi)
{
  const int next_lo = less && mid < hi ? mid + 1 : lo;
  hi = less ? hi : min(hi, mid);
  lo = next_lo;
}

__device__ __forceinline__ uint64_t key_at(const Tables& t, int i)
{
  return __ldg(reinterpret_cast<const unsigned long long*>(t.key_rec + i));
}

// the bucketed lower_bound of the first n (up to KG) keys of q, stepped
// together so that their loads are in flight at once; lb[g] gets key g's
__device__ __forceinline__ void key_searches(const Tables& t, const uint64_t* q, int n, int* lb)
{
  int shi[KG];
#pragma unroll
  for (int g = 0; g < KG; ++g)
  {
    const int b = (int)(q[g] >> (64 - BUCKET_BITS));
    lb[g] = g < n ? __ldg(t.bucket + b) : 0;
    shi[g] = g < n ? __ldg(t.bucket + b + 1) : 0;
  }
  for (int s = 0; s < t.key_steps; ++s)
  {
    uint64_t key[KG];
#pragma unroll
    for (int g = 0; g < KG; ++g)
      if (g < n)
        key[g] = key_at(t, min((lb[g] + shi[g]) >> 1, t.n_keys - 1));
#pragma unroll
    for (int g = 0; g < KG; ++g)
      if (g < n)
        step(key[g] < q[g], (lb[g] + shi[g]) >> 1, lb[g], shi[g]);
  }
}

// lower_bound of qe over the node starts
__device__ __forceinline__ int ref_search(const Tables& t, uint32_t qe)
{
  int lo = 0, hi = t.n_ref;
  for (int s = 0; s < t.ref_steps; ++s)
  {
    const int mid = (lo + hi) >> 1;
    step((uint32_t)__ldg(&t.ref_rec[min(mid, t.n_ref - 1)].x) < qe, mid, lo, hi);
  }
  return lo;
}

// a crossed variant label of kmer k, in the payload's flat order
__device__ __forceinline__ void add_var(int32_t lv, int k, int32_t* slot, int& nv, bool& small_ids)
{
  if (lv < 0)
    return;
  if (lv >= (1 << VAR_ID_BITS))
    small_ids = false;
  const int32_t v = (int32_t)((uint32_t)lv + ((uint32_t)k << VAR_ID_BITS));
#pragma unroll
  for (int j = 0; j < VAR_SLOTS; ++j)
    if (j == nv)
      slot[j] = v;
  ++nv;
}

__device__ __forceinline__ uint32_t byte_of(const uint32_t* w, int i)
{
  return (w[i / 4] >> (8 * (i % 4))) & 0xffu;
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

  for (int k0 = 0; k0 <= last; k0 += KG)
  {
    // the group's keys, then their searches stepped together
    uint64_t q[KG];
    int lb[KG];
    bool key_valid[KG];
#pragma unroll
    for (int g = 0; g < KG; ++g)
    {
      q[g] = 0;
      key_valid[g] = false;
      if (k0 + g <= last)
      {
        const int64_t o = (int64_t)row * nk + k0 + g;
        q[g] = (uint64_t)hi[o] << 32 | lo[o];
        key_valid[g] = valid[o] != 0;
      }
    }
    key_searches(t, q, last - k0 + 1, lb);

    // each kmer's found test and label span, then its first label
    int a[KG], size[KG];
#pragma unroll
    for (int g = 0; g < KG; ++g)
    {
      a[g] = size[g] = 0;
      if (k0 + g <= last)
      {
        const uint4 rec = __ldg(t.key_rec + min(lb[g], t.n_keys - 1));
        const bool found = lb[g] < t.n_keys && ((uint64_t)rec.y << 32 | rec.x) == q[g];
        a[g] = (int)rec.z;
        size[g] = found ? (int)(rec.w - rec.z) : 0;
      }
    }
    uint32_t ls0[KG], le0[KG];
    int32_t lv0[KG];
#pragma unroll
    for (int g = 0; g < KG; ++g)
      if (k0 + g <= last)
      {
        const int4 lab = __ldg(t.lab_rec + clampi(a[g], 0, t.n_labels - 1));
        ls0[g] = (uint32_t)lab.x;
        le0[g] = (uint32_t)lab.y;
        lv0[g] = lab.z;
      }

#pragma unroll
    for (int g = 0; g < KG; ++g)
    {
      const int k = k0 + g;
      if (k > last)
        continue;
      const bool in_read = k < nk_r;
      const int n_lab = min(size[g], LABEL_CAP);
      if (in_read && n_lab >= 1)
        add_var(lv0[g], k, slot, nv, small_ids);
      // labels past the first: a kmer on a repeat or over variants
      bool same_span = true;
      for (int s = 1; s < n_lab; ++s)
      {
        const int4 lab = __ldg(t.lab_rec + clampi(a[g] + s, 0, t.n_labels - 1));
        if ((uint32_t)lab.x != ls0[g] || (uint32_t)lab.y != le0[g])
          same_span = false;
        if (in_read)
          add_var(lab.z, k, slot, nv, small_ids);
      }

      const bool kmer_ok = key_valid[g] && size[g] >= 1 && size[g] <= LABEL_CAP && same_span;
      if (in_read && !kmer_ok)
        all_ok = false;
      if (k == 0)
        start = ls0[g];
      else if (in_read && prev_le0 != ls0[g])
        chain_ok = false;
      prev_le0 = le0[g];
      if (k == last)
        chain_end = le0[g];
    }
  }

  // right-tail extension inside one reference node
  const int tail_len = max(len - 1 - 31 * nk_r, 0);
  const bool has_tail = tail_len > 0;
  int mm = 0;
  bool tail_ok = true;
  if (has_tail)
  {
    // upper_bound(chain_end) == lower_bound(chain_end + 1), in uint32
    const int r = ref_search(t, chain_end + 1u) - 1;
    const int4 node = __ldg(t.ref_rec + clampi(r, 0, t.n_ref - 1));
    const uint32_t node_order = (uint32_t)node.x;
    const int32_t node_len = node.y;
    const int32_t off = (int32_t)(chain_end - node_order);
    const bool in_node = r >= 0 && chain_end >= node_order && off < node_len;
    const bool tail_fits = (int32_t)((uint32_t)off + (uint32_t)tail_len) < node_len;
    const uint32_t base = (uint32_t)node.z + (uint32_t)off + 1u;

    const uint4* tq = reinterpret_cast<const uint4*>(tails + (int64_t)row * TAIL_PAD);
    const uint4 tail0 = tq[0], tail1 = tq[1];
    const uint32_t qw[8] = {tail0.x, tail0.y, tail0.z, tail0.w, tail1.x, tail1.y, tail1.z, tail1.w};
    uint32_t rw[8];  // the reference bases under the tail, 4 a word
    const int32_t first = (int32_t)base;
    if (first >= 0 && (int64_t)first + tail_len <= t.n_arena)
    {
      // inside the arena: the aligned 16-byte chunks that hold the tail
      const int skip = first & 15;
      const uint4* chunk = reinterpret_cast<const uint4*>(t.ref_arena + (first - skip));
      const uint4 c0 = __ldg(chunk);
      const uint4 c1 = skip + tail_len > 16 ? __ldg(chunk + 1) : make_uint4(0, 0, 0, 0);
      const uint4 c2 = skip + tail_len > 32 ? __ldg(chunk + 2) : make_uint4(0, 0, 0, 0);
      const uint32_t cw[12] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w,
                               c2.x, c2.y, c2.z, c2.w};
      // shift the 48-byte window down by `skip` bytes: whole words by
      // selects, then the rest by a funnel shift, all in registers
      const int sw = skip / 4, sb = 8 * (skip % 4);
#pragma unroll
      for (int i = 0; i < 8; ++i)
      {
        const uint32_t w0 = sw == 0 ? cw[i] : sw == 1 ? cw[i + 1] : sw == 2 ? cw[i + 2] : cw[i + 3];
        const uint32_t w1 = sw == 0 ? cw[i + 1] : sw == 1 ? cw[i + 2] : sw == 2 ? cw[i + 3] : cw[i + 4];
        rw[i] = __funnelshift_r(w0, w1, sb);
      }
    }
    else
    {
      // past either end of the arena: byte by byte through the clamp
#pragma unroll
      for (int i = 0; i < 8; ++i)
        rw[i] = 0;
#pragma unroll
      for (int i = 0; i < TAIL_PAD; ++i)
        if (i < tail_len)
        {
          const int idx = clampi((int32_t)(base + (uint32_t)i), 0, t.n_arena - 1);
          rw[i / 4] |= (uint32_t)__ldg(t.ref_arena + idx) << (8 * (i % 4));
        }
    }
    bool no_tag = true;
#pragma unroll
    for (int i = 0; i < TAIL_PAD; ++i)
    {
      if (i < tail_len)
      {
        const uint32_t rb = byte_of(rw, i), qb = byte_of(qw, i);
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

__global__ void __launch_bounds__(DA_THREADS, 4)
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
// the tables as graphtyper_tpu_torch/ops/device_align.py DeviceAligner
// stages them for the kernel (`packed`), each non-empty, key_rec, lab_rec,
// ref_rec and ref_arena 16-byte aligned and ref_arena allocated to a
// multiple of 16 bytes; out [S][9] int32; S * nk < 2^30. Launches on
// `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError() of the launch.
extern "C" int gt_device_align(const uint32_t* hi, const uint32_t* lo, const uint8_t* valid,
                               const uint8_t* tails, const int32_t* lens, const void* key_rec,
                               const void* lab_rec, const int32_t* bucket, const void* ref_rec,
                               const uint8_t* ref_arena, int32_t* out, int S, int nk, int n_keys,
                               int n_labels, int n_ref, int n_arena, int key_steps, int ref_steps,
                               void* stream)
{
  if (S <= 0)
    return 0;
  if (nk <= 0 || (int64_t)S * nk >= (1ll << 30) || n_keys <= 0 || n_labels <= 0 || n_ref <= 0
      || n_arena <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tables t{static_cast<const uint4*>(key_rec), static_cast<const int4*>(lab_rec), bucket,
                 static_cast<const int4*>(ref_rec), ref_arena, n_keys, n_labels, n_ref, n_arena,
                 key_steps, ref_steps};
  const int blocks = std::min((S + DA_THREADS - 1) / DA_THREADS, 1 << 16);
  device_align_kernel<<<blocks, DA_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
    hi, lo, valid, tails, lens, t, out, S, nk);
  return static_cast<int>(cudaGetLastError());
}
