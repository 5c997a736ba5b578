// Discovery first-pass aggregation: per-event counters of the rows that a
// cohort's first pass extracts.
//
// Replaces graphtyper_tpu/ops/discovery_pileup.py _jitted_agg_cached
// (:85-116, the jitted XLA op behind aggregate_rows that every discovery
// iteration calls). Same [n_events, 8] int64 matrix bit for bit as the
// plain version (segment_counters_plain): columns 0-5 are segment sums of
// dhq, dlq and bits 0-3 of `bits` (hq, lq, proper, first, rev, clip), and
// columns 6-7 segment maxima of mapq and dist. The maxima start from the
// zeroed output, so an empty segment and a negative value read 0, as the
// JAX op's maximum(segment_max, 0) gives. Rows with ev == n_events (the
// overflow segment the JAX op's padding uses) are dropped, and so is any
// other ev outside [0, n_events), as jax.ops.segment_sum drops it. Sums
// are 64-bit adds in two's complement and maxima 64-bit maxima: integer
// operations whose result does not depend on their order.
//
// What bounds it. A row is read once, 48 bytes (6 int64), and the output
// written once, 64 bytes an event: 0.0003 ms at 20,000 rows, 0.0701 ms at
// 4,194,304 rows over 3.35 TB/s. Above that stand the fixed cost of a call
// and up to 8 64-bit atomics a row in the L2, on the same address where
// rows share an event. A call is one memset of the output and one launch,
// 2 device operations. A thread takes one row, a warp 32 consecutive rows,
// their columns read coalesced. The rows of a warp that share an event
// sum their counters and take their maxima first (__match_any_sync on ev,
// a tree of 64-bit shuffles in the group), and the group's lowest lane
// makes the atomics, skipping the adds of zeros and the maxima of values
// <= 0, which cannot change a counter that starts at 0. The counters of
// 524,288 events (32 MB) do not fit shared memory, so the warp is the only
// level of pre-reduction. Rows of distinct events (uniform random ev over
// many events) form groups of one, where the kernel is bound by the
// atomics. A persistent grid with 2 rows a lane (16-byte loads) measured
// slower on the card than one row a lane at every shape timed, so the
// grid is one thread a row (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int DP_THREADS = 512;
constexpr unsigned DP_FULL = 0xffffffffu;
constexpr int N_COLS = 8;
constexpr int N_SUMS = 6;  // columns 0-5 are sums, 6-7 maxima

__device__ __forceinline__ void add(int64_t* p, int64_t v)
{
  if (v != 0)
    atomicAdd(reinterpret_cast<unsigned long long*>(p), static_cast<unsigned long long>(v));
}

__device__ __forceinline__ void max0(int64_t* p, int64_t v)
{
  if (v > 0)
    atomicMax(reinterpret_cast<long long*>(p), static_cast<long long>(v));
}

// The sums (v[0, N_SUMS)) and maxima (the rest) of v over the lanes of
// `peers` end in the group's lowest lane, which gets true; every lane of
// the warp calls it together. The tree of site_scoring.cu's group_sum.
__device__ __forceinline__ bool group_reduce(unsigned peers, int64_t (&v)[N_COLS])
{
  const unsigned lane = threadIdx.x & 31;
  unsigned rank = __popc(peers & ((1u << lane) - 1));
  const bool leader = rank == 0;
  unsigned above = peers & ~((2u << lane) - 1);
  while (__any_sync(DP_FULL, above != 0))
  {
    const int src = __ffs(above) - 1;
#pragma unroll
    for (int k = 0; k < N_COLS; ++k)
    {
      const long long t = __shfl_sync(DP_FULL, static_cast<long long>(v[k]), src < 0 ? (int)lane : src);
      if (src >= 0)
        v[k] = k < N_SUMS ? static_cast<int64_t>(static_cast<uint64_t>(v[k]) + static_cast<uint64_t>(t))
                          : (v[k] > t ? v[k] : t);
    }
    above &= __ballot_sync(DP_FULL, (rank & 1) == 0);
    rank >>= 1;
  }
  return leader;
}

// One row a lane, 32 consecutive rows a warp; lanes past N take ev -1,
// which adds nothing, so every warp-wide call has all 32 lanes.
__global__ void __launch_bounds__(DP_THREADS)
discovery_pileup_kernel(const int64_t* __restrict__ mat,  // [6][N]: ev, dhq, dlq, bits, mapq, dist
                        int64_t N, int64_t n_events,
                        int64_t* __restrict__ out)        // [n_events][8], zeroed
{
  const unsigned long long lone = ~static_cast<unsigned long long>(threadIdx.x & 31);
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t ev = r < N ? mat[r] : -1;
  const bool ok = ev >= 0 && ev < n_events;
  int64_t v[N_COLS] = {};
  if (ok)
  {
    const int64_t bits = mat[3 * N + r];
    v[0] = mat[1 * N + r];
    v[1] = mat[2 * N + r];
    v[2] = bits & 1;
    v[3] = (bits >> 1) & 1;
    v[4] = (bits >> 2) & 1;
    v[5] = (bits >> 3) & 1;
    v[6] = mat[4 * N + r];
    v[7] = mat[5 * N + r];
  }
  if (group_reduce(__match_any_sync(DP_FULL, ok ? static_cast<unsigned long long>(ev) : lone), v) && ok)
  {
    int64_t* o = out + ev * N_COLS;
    for (int k = 0; k < N_SUMS; ++k)
      add(o + k, v[k]);
    max0(o + 6, v[6]);
    max0(o + 7, v[7]);
  }
}

}  // namespace

// `out` ([n_events][8] int64, any contents) ends with the counters; one
// memset and one launch on `stream`.
extern "C" int gt_discovery_pileup(const int64_t* mat, int64_t N, int64_t n_events, int64_t* out,
                                   void* stream)
{
  if (N < 0 || n_events < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_events == 0)
    return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, n_events * N_COLS * sizeof(int64_t), s);
  if (err != cudaSuccess || N == 0)
    return static_cast<int>(err);
  discovery_pileup_kernel<<<static_cast<unsigned>((N + DP_THREADS - 1) / DP_THREADS), DP_THREADS, 0, s>>>(
    mat, N, n_events, out);
  return static_cast<int>(cudaGetLastError());
}
