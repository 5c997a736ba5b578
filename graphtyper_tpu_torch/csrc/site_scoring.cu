// Observation scoring: one scoring flush's [14, N] row matrix into the flat
// int64 state-delta vector, in two passes.
//
// Replaces graphtyper_tpu/ops/site_scoring.py _apply_tier_impl (:141-234,
// the jitted XLA op behind every call iteration's scoring flush, and the
// body of _jitted_apply_tier_sharded at :279-311). Same vector bit for bit,
// in the order of split_totals (ops/site_scoring.py): log_delta [S, T],
// gt_cov [S, A], amb, amb_alt, alt_pp [S], clip_reads, site_mapq_sq
// [n_sites], pa_clip, pa_mapq, pa_mm, pa_sdiff [n_sites, A], pa_strand
// [n_sites, A, 4], with S = n_sites * n_samples and T = A (A + 1) / 2.
//
// The JAX op forms the PL triangle as a Gram product: with B the [N, A]
// explain bitmap of the applied rows and e their eps, log_delta[s, t(x, y)]
// = u[s, x] + u[s, y] + W[s, x, y], where u sums (e - 1) B and W sums
// (2 - e) B_x B_y over the rows of segment s. This kernel never builds the
// [N, T] product. Pass 1 (one thread a row) adds e - 1 to u[seg, x] for
// each set bit x below A and 2 - e to W[seg, t(x, y)] for each set pair
// x <= y, the diagonal included, with t(x, y) = y (y + 1) / 2 + x, the
// order of _triangle_xy; W lives in the output's log_delta block itself.
// The same thread adds its coverage, ambiguity, site and per-allele terms.
// Pass 2 (one thread an (seg, t)) adds u[seg, x] + u[seg, y]. Every add of
// pass 1 is a 64-bit integer atomicAdd (the two's complement of a negative
// delta on unsigned long long), so the sums are exact in any order and the
// vector equals the plain version's (apply_tier_plain) exactly.
//
// Rows arrive as int32 columns; the explain bitmap is bits_lo | bits_hi <<
// 32 of their uint32 bit patterns, masked to the A bits below A, and zero
// when apply_score <= 0. Padding rows (cov COV_PAD, eps 0, bits 0, zero
// scalars) add nothing. The per-allele terms take rows with cov >= 0 at
// aseg = site * A + cov, as the plain version computes it (not clamped).
// An index outside its block (a site, sample or aseg that no valid row
// has) is dropped, as jax.ops.segment_sum drops it, so that no add lands
// outside the output; the plain version raises there instead. Indices are
// int64: seg * T passes 2^31 at A = 64 on cohort shapes.
//
// What bounds it. The flush reads 56 bytes a row (14 int32) once and
// writes the vector once, 8 bytes an entry; at bench_flush's shapes that
// is 0.0016 to 0.0706 ms at 3.35 TB/s, and the integer work (a few adds a
// row, popcount-squared pair adds for multi-allele rows) is far less. The
// design reads each row's columns coalesced (thread r reads column f at f
// N + r) and keeps everything but the atomics in registers; the atomics
// land in the L2, where rows of one (site, sample) meet. It is the simple
// form: two launches a flush and no per-block pre-reduction, which a later
// change may add where rows of one segment crowd one block.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SS_THREADS = 256;
constexpr int SS_MAX_BLOCKS = 1 << 16;
constexpr int COV_MULTI_ALT = -1;
constexpr int COV_MULTI_REF = -2;
constexpr int N_FIELDS = 14;
// the row's columns, in OBS_FIELDS order
enum Field { F_SITE, F_SAMPLE, F_EPS, F_APPLY, F_LO, F_HI, F_COV, F_CLIP_SCALED, F_CLIP_FLAG,
             F_MAPQ_SQ, F_MM, F_SDIFF, F_STRAND, F_PROPER };

// where each block of the flat vector starts
struct Layout
{
  int64_t S, T, n_sites, A;
  int64_t log_delta, gt_cov, amb, amb_alt, alt_pp, clip_reads, site_mapq_sq, pa_clip, pa_mapq,
    pa_mm, pa_sdiff, pa_strand, size;
};

Layout layout(int A, int64_t n_sites, int64_t n_samples)
{
  Layout l{};
  l.S = n_sites * n_samples;
  l.T = (int64_t)A * (A + 1) / 2;
  l.n_sites = n_sites;
  l.A = A;
  const int64_t SA = n_sites * A;
  l.log_delta = 0;
  l.gt_cov = l.log_delta + l.S * l.T;
  l.amb = l.gt_cov + l.S * A;
  l.amb_alt = l.amb + l.S;
  l.alt_pp = l.amb_alt + l.S;
  l.clip_reads = l.alt_pp + l.S;
  l.site_mapq_sq = l.clip_reads + n_sites;
  l.pa_clip = l.site_mapq_sq + n_sites;
  l.pa_mapq = l.pa_clip + SA;
  l.pa_mm = l.pa_mapq + SA;
  l.pa_sdiff = l.pa_mm + SA;
  l.pa_strand = l.pa_sdiff + SA;
  l.size = l.pa_strand + 4 * SA;
  return l;
}

__device__ __forceinline__ void add(int64_t* p, int64_t v)
{
  if (v != 0)
    atomicAdd(reinterpret_cast<unsigned long long*>(p), static_cast<unsigned long long>(v));
}

__device__ __forceinline__ int lowest_bit(uint64_t m)
{
  return __ffsll(static_cast<long long>(m)) - 1;
}

__global__ void __launch_bounds__(SS_THREADS)
scoring_rows_kernel(const int32_t* __restrict__ obs,  // [14][N] int32, OBS_FIELDS order
                    int64_t N, int64_t n_samples, Layout l,
                    int64_t* __restrict__ out,        // the flat vector, zeroed
                    int64_t* __restrict__ u)          // [S][A] scratch, zeroed
{
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < N; r += stride)
  {
    int32_t f[N_FIELDS];
#pragma unroll
    for (int k = 0; k < N_FIELDS; ++k)
      f[k] = obs[k * N + r];
    const int64_t site = f[F_SITE];
    const int64_t seg = site * n_samples + f[F_SAMPLE];
    const bool site_ok = site >= 0 && site < l.n_sites;
    const bool seg_ok = seg >= 0 && seg < l.S;
    const int cov = f[F_COV];

    // -- PL triangle: u[seg, x] and W[seg, t(x, y)] ----------------------------
    uint64_t bits = static_cast<uint32_t>(f[F_LO])
                    | static_cast<uint64_t>(static_cast<uint32_t>(f[F_HI])) << 32;
    if (l.A < 64)
      bits &= (1ull << l.A) - 1;
    if (f[F_APPLY] <= 0 || !seg_ok)
      bits = 0;
    const int64_t e = f[F_EPS];
    int64_t* urow = u + seg * l.A;
    int64_t* wrow = out + l.log_delta + seg * l.T;
    for (uint64_t my = bits; my; my &= my - 1)
    {
      const int y = lowest_bit(my);
      add(urow + y, e - 1);
      const int64_t ty = (int64_t)y * (y + 1) / 2;
      for (uint64_t mx = bits & ((2ull << y) - 1); mx; mx &= mx - 1)  // x <= y
        add(wrow + ty + lowest_bit(mx), 2 - e);
    }

    // -- coverage_to_gts ----------------------------------------------------------
    if (seg_ok)
    {
      if (cov >= 0 && cov < l.A)
        add(out + l.gt_cov + seg * l.A + cov, 1);
      if (cov == COV_MULTI_REF || cov == COV_MULTI_ALT)
        add(out + l.amb + seg, 1);
      if (cov == COV_MULTI_ALT)
        add(out + l.amb_alt + seg, 1);
      if ((cov == COV_MULTI_ALT || cov > 0) && f[F_PROPER] > 0)
        add(out + l.alt_pp + seg, 1);
    }

    // -- VarStats: per site, and per allele for single-allele reads -------------
    if (site_ok)
    {
      add(out + l.clip_reads + site, f[F_CLIP_FLAG]);
      add(out + l.site_mapq_sq + site, f[F_MAPQ_SQ]);
    }
    if (cov >= 0)
    {
      const int64_t aseg = site * l.A + cov;
      if (aseg >= 0 && aseg < l.n_sites * l.A)
      {
        add(out + l.pa_clip + aseg, f[F_CLIP_SCALED]);
        add(out + l.pa_mapq + aseg, f[F_MAPQ_SQ]);
        add(out + l.pa_mm + aseg, f[F_MM]);
        add(out + l.pa_sdiff + aseg, f[F_SDIFF]);
      }
      const int64_t sseg = aseg * 4 + f[F_STRAND];
      if (sseg >= 0 && sseg < 4 * l.n_sites * l.A)
        add(out + l.pa_strand + sseg, 1);
    }
  }
}

__global__ void __launch_bounds__(SS_THREADS)
scoring_triangle_kernel(Layout l, int64_t* __restrict__ out, const int64_t* __restrict__ u)
{
  const int64_t total = l.S * l.T;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride)
  {
    const int64_t seg = i / l.T;
    const int t = static_cast<int>(i - seg * l.T);
    int y = 0;  // the y with y (y + 1) / 2 <= t < (y + 1) (y + 2) / 2; y < 64
    while ((y + 1) * (y + 2) / 2 <= t)
      ++y;
    const int x = t - y * (y + 1) / 2;
    out[l.log_delta + i] += u[seg * l.A + x] + u[seg * l.A + y];
  }
}

int blocks_for(int64_t n)
{
  return static_cast<int>(std::min<int64_t>((n + SS_THREADS - 1) / SS_THREADS, SS_MAX_BLOCKS));
}

}  // namespace

// The flat vector's length for (A, n_sites, n_samples); the wrapper
// allocates `out` with it.
extern "C" int64_t gt_site_scoring_size(int A, int64_t n_sites, int64_t n_samples)
{
  return layout(A, n_sites, n_samples).size;
}

// `out` (gt_site_scoring_size entries) and `u` (n_sites * n_samples * A)
// must be zeroed; both launches go on `stream`.
extern "C" int gt_site_scoring(const int32_t* obs, int64_t N, int A, int64_t n_sites,
                               int64_t n_samples, int64_t* out, int64_t* u, void* stream)
{
  if (A < 1 || A > 64 || N < 0 || n_sites < 0 || n_samples < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(A, n_sites, n_samples);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N > 0)
  {
    scoring_rows_kernel<<<blocks_for(N), SS_THREADS, 0, s>>>(obs, N, n_samples, l, out, u);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess)
      return static_cast<int>(err);
  }
  if (l.S * l.T > 0)
    scoring_triangle_kernel<<<blocks_for(l.S * l.T), SS_THREADS, 0, s>>>(l, out, u);
  return static_cast<int>(cudaGetLastError());
}
