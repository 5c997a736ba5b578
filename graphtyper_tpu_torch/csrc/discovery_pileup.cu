// Discovery first-pass aggregation: per-event counters of the rows that a
// cohort's first pass extracts, one thread a row.
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
// other ev outside [0, n_events), as jax.ops.segment_sum drops it.
// Sums are 64-bit atomicAdds and maxima 64-bit atomicMaxes: integer
// operations whose result does not depend on their order.
//
// What bounds it. A row is read once, 48 bytes (6 int64), and the output
// written once, 64 bytes an event; the work is 8 atomics a row at most.
// The design reads each column coalesced (thread r reads column f at f N +
// r) and skips the adds of zeros and the maxima of values <= 0, which
// cannot change a counter that starts at 0. Rows of one event meet in the
// L2's atomic units; a per-block pre-reduction is a later change.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int DP_THREADS = 256;
constexpr int DP_MAX_BLOCKS = 1 << 16;
constexpr int N_COLS = 8;

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

__global__ void __launch_bounds__(DP_THREADS)
discovery_pileup_kernel(const int64_t* __restrict__ mat,  // [6][N]: ev, dhq, dlq, bits, mapq, dist
                        int64_t N, int64_t n_events,
                        int64_t* __restrict__ out)        // [n_events][8], zeroed
{
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < N; r += stride)
  {
    const int64_t ev = mat[r];
    if (ev < 0 || ev >= n_events)
      continue;
    const int64_t bits = mat[3 * N + r];
    int64_t* o = out + ev * N_COLS;
    add(o + 0, mat[1 * N + r]);
    add(o + 1, mat[2 * N + r]);
    add(o + 2, bits & 1);
    add(o + 3, (bits >> 1) & 1);
    add(o + 4, (bits >> 2) & 1);
    add(o + 5, (bits >> 3) & 1);
    max0(o + 6, mat[4 * N + r]);
    max0(o + 7, mat[5 * N + r]);
  }
}

}  // namespace

// `out` ([n_events][8] int64) must be zeroed; the launch goes on `stream`.
extern "C" int gt_discovery_pileup(const int64_t* mat, int64_t N, int64_t n_events, int64_t* out,
                                   void* stream)
{
  if (N < 0 || n_events < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || n_events == 0)
    return 0;
  const int blocks
    = static_cast<int>(std::min<int64_t>((N + DP_THREADS - 1) / DP_THREADS, DP_MAX_BLOCKS));
  discovery_pileup_kernel<<<blocks, DP_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
    mat, N, n_events, out);
  return static_cast<int>(cudaGetLastError());
}
