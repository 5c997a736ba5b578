// Observation scoring: one scoring flush's [14, N] row matrix into the flat
// int64 state-delta vector.
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
// (2 - e) B_x B_y over the rows of segment s, t(x, y) = y (y + 1) / 2 + x
// (the order of _triangle_xy). This kernel never builds the [N, T] product.
// At A 2 and 4 (up to FOLD_MAX_A) pass 1 adds each row's whole triangle:
// (e - 1)(B_x + B_y) + (2 - e) B_x B_y on t(x, y), which is e B_x on the
// diagonal. A row that explains one allele makes A adds there (2 or 4), and
// the tier needs neither u nor a second pass, whose launch costs a small
// flush more than the extra adds: every A 4 flush measured is small (under
// 16,384 rows even in a 96-sample pool; PERF.md). Above A 4 a row would
// make A adds against 2, so pass 1 adds e - 1 to u[seg, x] for each set bit
// x and 2 - e to W[seg, t(x, y)] for each set pair x <= y (W lives in the
// output's log_delta block), and pass 2 (one thread an (seg, t)) adds
// u[seg, x] + u[seg, y]. The coverage, ambiguity, site and per-allele terms
// are pass 1's.
//
// Rows arrive as int32 columns; the explain bitmap is bits_lo | bits_hi <<
// 32 of their uint32 bit patterns, masked to the A bits below A, and zero
// when apply_score <= 0. Padding rows (cov COV_PAD, eps 0, bits 0, zero
// scalars) add nothing. The per-allele terms take rows with cov >= 0 at
// aseg = site * A + cov, as the plain version computes it (not clamped).
// An index outside its block (a site, sample or aseg that no valid row
// has) is dropped, as jax.ops.segment_sum drops it, so that no add lands
// outside the output; the plain version raises there instead. Indices are
// int64: seg * T passes 2^31 at A = 64 on cohort shapes. Every add is an
// integer add on 64 bits (the two's complement of a negative delta), so
// the sums are exact in any order and the vector equals the plain
// version's (apply_tier_plain) exactly.
//
// What bounds it. The flush reads 56 bytes a row (14 int32) once and
// writes the vector once, 8 bytes an entry: at bench_flush's shapes 0.0016
// to 0.0706 ms at 3.35 TB/s. The integer work is far less. Two things
// stand above that bound, and the design answers each:
// - Fixed cost a call. The main path's flushes hold 100-8,000 rows (a
//   median of 2,306 on the 200 kb cohort), where a call is its device
//   operations and one warp's chain of loads and adds. The launcher zeroes
//   the one buffer (the vector, and u behind it) with one memset, so a call
//   is the memset and pass 1, and pass 2 above A 4: at most 3 device
//   operations. A flush of fewer than 256 rows a site and 16,384 rows in
//   all (every flush of the 200 kb cohort: ~30 rows a site) makes each
//   row's own atomics: with so few warps on the card and so few rows on an
//   address, the warp sums below lengthen the chain more than they save
//   (PERF.md), and its worst case, every row on one address, stays under
//   16,384 same-address atomics.
// - Same-address 64-bit atomics in the L2. The site-level block (clip_reads
//   to the end: n_sites (2 + 8A) entries, 9,216 at A 2 with 512 sites)
//   takes up to 7 adds a row, 2 of them on n_sites addresses. Where a
//   flush's rows, one a lane, do not fit the card at once (from ~135,000
//   rows: the A 2 flushes of a pool of ~50 samples or more at 30x), the
//   grid is persistent (the occupancy API x the SMs) and each block keeps
//   its own copy of as much of the block as its shared memory holds, from
//   the first entry: all of it where it fits (72 KB at A 2 x 512 sites),
//   else a prefix (227 of the 263 KB at A 64 x 64 sites: the site terms,
//   the per-allele sums and most strand counts), the rest taking global
//   atomics. The copy is zeroed at the block's start, filled with
//   shared-memory atomics, and added to the output once per nonzero entry
//   at its end, so that step costs O(blocks x entries), not O(rows). From
//   256 rows a site or 16,384 rows (the A 4 flushes of a 96-sample pool,
//   ~3,000 rows a site, take 2.5x less device time so) and with every
//   shared copy, every add, shared or global, is first summed over the
//   lanes of a warp whose rows share its address: __match_any_sync on
//   the key, a tree of 64-bit shuffles in the group, one atomic from its
//   lowest lane. The keys: the segment up to A 4 (its gt_cov entries among
//   the sums), else (segment, allele of cov); the raw (site, cov, strand)
//   for the per-site and per-allele terms, one match for all three. Rows
//   of one segment on one address then cost one atomic a warp; rows of
//   uniform random keys form groups of one, which costs a match and a vote.
// A warp reads 32 rows' columns coalesced, one int32 a lane.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>
#include <map>
#include <mutex>
#include <set>
#include <tuple>
#include <type_traits>
#include <utility>

namespace {

constexpr int SS_THREADS = 512;
constexpr unsigned FULL = 0xffffffffu;
constexpr int FOLD_MAX_A = 4;  // up to this tier pass 1 adds each row's whole triangle
// A flush sums the adds of a warp's rows that share an address before its
// atomics where its rows are many a site (GROUP_ROWS_A_SITE x n_sites rows
// or more: the per-site entries are the most shared addresses) or many in
// all (GROUP_MIN_ROWS, which bounds the same-address atomics of rows that
// all fall on one site); else each row makes its own adds
constexpr int64_t GROUP_ROWS_A_SITE = 256;
constexpr int64_t GROUP_MIN_ROWS = 16384;
constexpr int COV_MULTI_ALT = -1;
constexpr int COV_MULTI_REF = -2;
constexpr int COV_NULL = -3;  // a lane past N takes a row that adds nothing
constexpr int N_FIELDS = 14;
// the row's columns, in OBS_FIELDS order
enum Field { F_SITE, F_SAMPLE, F_EPS, F_APPLY, F_LO, F_HI, F_COV, F_CLIP_SCALED, F_CLIP_FLAG,
             F_MAPQ_SQ, F_MM, F_SDIFF, F_STRAND, F_PROPER };

// whether pass 1 adds the whole triangle at tier A (no u, no pass 2)
constexpr bool folds(int A)
{
  return A == 2 || A == FOLD_MAX_A;
}

// f(std::integral_constant<int, FA>{}) with the FA of tier A (2, 4, or 0
// for the tiers of pass 2)
template <class F> auto with_fold(int A, F f)
{
  if (A == 2)
    return f(std::integral_constant<int, 2>{});
  if (A == FOLD_MAX_A)
    return f(std::integral_constant<int, FOLD_MAX_A>{});
  return f(std::integral_constant<int, 0>{});
}

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

// the block's copy of the first entries of the site-level block
// (out[clip_reads : size]), as many as fit its shared memory
extern __shared__ unsigned long long ss_site[];

__device__ __forceinline__ void add(int64_t* p, int64_t v)
{
  if (v != 0)
    atomicAdd(reinterpret_cast<unsigned long long*>(p), static_cast<unsigned long long>(v));
}

// entry i of the site-level block: the block's shared copy where it holds
// the entry (i < n_shared), else the output
template <bool SMEM>
__device__ __forceinline__ void site_add(int64_t* site_out, int64_t n_shared, int64_t i, int64_t v)
{
  if (v == 0)
    return;
  if (SMEM && i < n_shared)
    atomicAdd(&ss_site[i], static_cast<unsigned long long>(v));
  else
    atomicAdd(reinterpret_cast<unsigned long long*>(site_out + i), static_cast<unsigned long long>(v));
}

__device__ __forceinline__ int lowest_bit(uint64_t m)
{
  return __ffsll(static_cast<long long>(m)) - 1;
}

// With AGG, the sums of v over the lanes whose key equals the calling
// lane's (its group, by __match_any_sync) end in the group's lowest lane,
// which gets true; every lane of the warp calls it together. A tree in the
// group: in each round a lane adds the value of the next lane of the group
// still in play, and the lanes of odd rank leave, so log2(group size)
// rounds of 64-bit shuffles; a warp of groups of one leaves at once. Sums
// are taken on 64 bits in two's complement. Without AGG every lane keeps
// its own v and gets true.
template <bool AGG, int K>
__device__ __forceinline__ bool group_sum(unsigned long long key, int64_t (&v)[K])
{
  if constexpr (!AGG)
    return true;
  const unsigned peers = __match_any_sync(FULL, key);
  const unsigned lane = threadIdx.x & 31;
  unsigned rank = __popc(peers & ((1u << lane) - 1));
  const bool leader = rank == 0;
  unsigned above = peers & ~((2u << lane) - 1);  // 2u << 31 is 0: lane 31 has none above
  while (__any_sync(FULL, above != 0))
  {
    const int src = __ffs(above) - 1;
#pragma unroll
    for (int k = 0; k < K; ++k)
    {
      const long long t = __shfl_sync(FULL, static_cast<long long>(v[k]), src < 0 ? (int)lane : src);
      if (src >= 0)
        v[k] = static_cast<int64_t>(static_cast<uint64_t>(v[k]) + static_cast<uint64_t>(t));
    }
    above &= __ballot_sync(FULL, (rank & 1) == 0);
    rank >>= 1;
  }
  return leader;
}

// One row of each lane of the warp, all 32 lanes together. FA is the
// tier (2 or 4) whose triangle pass 1 adds whole, 0 above. The key that no
// other lane has, ~lane, is above every index.
template <int FA, bool SMEM, bool AGG>
__device__ __forceinline__ void score_row(const int32_t (&f)[N_FIELDS], int64_t n_samples,
                                          const Layout& l, int64_t n_shared,
                                          int64_t* __restrict__ out, int64_t* __restrict__ u)
{
  const unsigned long long lone = ~static_cast<unsigned long long>(threadIdx.x & 31);
  const int64_t site = f[F_SITE];
  const int64_t seg = site * n_samples + f[F_SAMPLE];
  const bool site_ok = site >= 0 && site < l.n_sites;
  const bool seg_ok = seg >= 0 && seg < l.S;
  const int cov = f[F_COV];
  const int64_t e = f[F_EPS];
  uint64_t bits = static_cast<uint32_t>(f[F_LO])
                  | static_cast<uint64_t>(static_cast<uint32_t>(f[F_HI])) << 32;
  if (l.A < 64)
    bits &= (1ull << l.A) - 1;
  if (f[F_APPLY] <= 0 || !seg_ok)
    bits = 0;

  // -- per segment: coverage, ambiguity, and up to A 4 the folded triangle.
  // There a group is a segment (its A gt_cov entries among the sums), above
  // a (segment, allele of cov) ------------------------------------------------
  {
    constexpr int TA = FA * (FA + 1) / 2;
    const int c = cov >= 0 && cov < l.A ? cov : 127;  // 127: no gt_cov entry
    unsigned long long key = lone;
    if (seg_ok)
      key = FA ? static_cast<unsigned long long>(seg) : static_cast<unsigned long long>(seg) << 7 | c;
    constexpr int K = FA ? TA + FA : 1;  // the sums before amb
    // FA: the triangle in t order, gt_cov[0 .. FA); else gt_cov[c]; then amb, amb_alt, alt_pp
    int64_t v[K + 3] = {};
    if (seg_ok)
    {
      if constexpr (FA > 0)
      {
        // t(x, y), x <= y: (e - 1)(B_x + B_y) + (2 - e) B_x B_y, which is e B_x where x == y
        int t = 0;
#pragma unroll
        for (int y = 0; y < FA; ++y)
#pragma unroll
          for (int x = 0; x <= y; ++x, ++t)
          {
            const int64_t bx = bits >> x & 1, by = bits >> y & 1;
            v[t] = (e - 1) * (bx + by) + (2 - e) * (bx & by);
          }
#pragma unroll
        for (int a = 0; a < FA; ++a)
          v[TA + a] = cov == a;
      }
      else
        v[0] = c != 127;
      v[K] = cov == COV_MULTI_REF || cov == COV_MULTI_ALT;
      v[K + 1] = cov == COV_MULTI_ALT;
      v[K + 2] = (cov == COV_MULTI_ALT || cov > 0) && f[F_PROPER] > 0;
    }
    if (group_sum<AGG>(key, v) && seg_ok)
    {
      if constexpr (FA > 0)
      {
#pragma unroll
        for (int t = 0; t < TA; ++t)
          add(out + l.log_delta + seg * TA + t, v[t]);
#pragma unroll
        for (int a = 0; a < FA; ++a)
          add(out + l.gt_cov + seg * FA + a, v[TA + a]);
      }
      else if (c != 127)
        add(out + l.gt_cov + seg * l.A + c, v[0]);
      add(out + l.amb + seg, v[K]);
      add(out + l.amb_alt + seg, v[K + 1]);
      add(out + l.alt_pp + seg, v[K + 2]);
    }
  }

  // -- the unfolded triangle: u[seg, x] and W[seg, t(x, y)], a bit or a
  // pair a round, as long as any lane has one left ---------------------------
  if constexpr (FA == 0)
  {
    for (uint64_t my = bits; __any_sync(FULL, my != 0); my &= my - 1)
    {
      const bool has = my != 0;
      const unsigned long long key = has ? seg * l.A + lowest_bit(my) : lone;
      int64_t v[1] = {has ? e - 1 : 0};
      if (group_sum<AGG>(key, v) && has)
        add(u + key, v[0]);
    }
    uint64_t ys = bits;  // y runs over the set bits, x over those <= y
    uint64_t xs = ys ? bits & ((2ull << lowest_bit(ys)) - 1) : 0;
    while (__any_sync(FULL, xs != 0))
    {
      const bool has = xs != 0;
      unsigned long long key = lone;
      if (has)
      {
        const int64_t y = lowest_bit(ys);
        key = seg * l.T + y * (y + 1) / 2 + lowest_bit(xs);
      }
      int64_t v[1] = {has ? 2 - e : 0};
      if (group_sum<AGG>(key, v) && has)
        add(out + l.log_delta + key, v[0]);
      if (has && !(xs &= xs - 1))
      {
        ys &= ys - 1;
        xs = ys ? bits & ((2ull << lowest_bit(ys)) - 1) : 0;
      }
    }
  }

  // -- VarStats: per site, and per allele for single-allele reads -----------
  // s, a and t are -1 where their terms are dropped. Rows of one raw (site,
  // cov, strand) share all three, so that is the key, packed where cov and
  // the strand fit a byte each (every row the engine makes; another row
  // takes the lone key, whose bits 16-31 no packed key has)
  {
    const int strand = f[F_STRAND];
    const int64_t aseg = site * l.A + cov;
    const int64_t sseg = aseg * 4 + strand;
    const int64_t s = site_ok ? site : -1;
    const int64_t a = cov >= 0 && aseg >= 0 && aseg < l.n_sites * l.A ? aseg : -1;
    const int64_t t = cov >= 0 && sseg >= 0 && sseg < 4 * l.n_sites * l.A ? sseg : -1;
    const bool packs = cov >= -128 && cov < 128 && strand >= 0 && strand < 256;
    const unsigned long long key = packs ? static_cast<unsigned long long>(static_cast<uint32_t>(f[F_SITE])) << 32
                                             | static_cast<unsigned long long>(static_cast<uint8_t>(cov)) << 8
                                             | static_cast<unsigned long long>(strand)
                                         : lone;
    int64_t v[6] = {f[F_CLIP_FLAG], f[F_MAPQ_SQ], f[F_CLIP_SCALED], f[F_MM], f[F_SDIFF], 1};
    if (group_sum<AGG>(key, v))
    {
      int64_t* site_out = out + l.clip_reads;
      const int64_t base = l.clip_reads;
      if (s >= 0)
      {
        site_add<SMEM>(site_out, n_shared, s, v[0]);
        site_add<SMEM>(site_out, n_shared, l.site_mapq_sq - base + s, v[1]);
      }
      if (a >= 0)
      {
        site_add<SMEM>(site_out, n_shared, l.pa_clip - base + a, v[2]);
        site_add<SMEM>(site_out, n_shared, l.pa_mapq - base + a, v[1]);
        site_add<SMEM>(site_out, n_shared, l.pa_mm - base + a, v[3]);
        site_add<SMEM>(site_out, n_shared, l.pa_sdiff - base + a, v[4]);
      }
      if (t >= 0)
        site_add<SMEM>(site_out, n_shared, l.pa_strand - base + t, v[5]);
    }
  }
}

// Pass 1. A warp takes 32 consecutive rows a step, one a lane, over the
// grid; lanes past N take a row that adds nothing, so every warp-wide call
// has all 32 lanes. In the shared-memory variant (SMEM, n_shared > 0) the
// block zeroes its copy of the first n_shared entries of the site-level
// block first and adds its nonzero entries to the output last; the entries
// past n_shared go to the output. AGG: group_sum's pre-reduction.
template <int FA, bool SMEM, bool AGG>
__global__ void __launch_bounds__(SS_THREADS)
scoring_rows_kernel(const int32_t* __restrict__ obs,  // [14][N] int32, OBS_FIELDS order
                    int64_t N, int64_t n_samples, Layout l, int64_t n_shared,
                    int64_t* __restrict__ out,        // the flat vector, zeroed
                    int64_t* __restrict__ u)          // [S][A] scratch, zeroed (FA 0 only)
{
  if constexpr (SMEM)
  {
    for (int64_t i = threadIdx.x; i < n_shared; i += blockDim.x)
      ss_site[i] = 0;
    __syncthreads();
  }
  const int64_t lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t base = warp * 32; base < N; base += step)
  {
    const int64_t r = base + lane;
    int32_t f[N_FIELDS];
    if (r < N)
    {
#pragma unroll
      for (int k = 0; k < N_FIELDS; ++k)
        f[k] = obs[k * N + r];
    }
    else
    {
#pragma unroll
      for (int k = 0; k < N_FIELDS; ++k)
        f[k] = 0;
      f[F_SITE] = -1;
      f[F_COV] = COV_NULL;
    }
    score_row<FA, SMEM, AGG>(f, n_samples, l, n_shared, out, u);
  }
  if constexpr (SMEM)
  {
    __syncthreads();
    for (int64_t i = threadIdx.x; i < n_shared; i += blockDim.x)
      add(out + l.clip_reads + i, static_cast<int64_t>(ss_site[i]));
  }
}

// Pass 2 (A > FOLD_MAX_A): log_delta[seg, t(x, y)] += u[seg, x] + u[seg, y].
__global__ void __launch_bounds__(SS_THREADS)
scoring_triangle_kernel(Layout l, int64_t* __restrict__ out, const int64_t* __restrict__ u)
{
  const int64_t total = l.S * l.T;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride)
  {
    const int64_t seg = i / l.T;
    const int t = static_cast<int>(i - seg * l.T);
    // the y with y (y + 1) / 2 <= t < (y + 1) (y + 2) / 2; 8t + 1 < 2^24
    // is exact in float, and the two steps correct any rounding of sqrtf
    int y = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
    if ((y + 1) * (y + 2) / 2 <= t)
      ++y;
    if (y * (y + 1) / 2 > t)
      --y;
    const int x = t - y * (y + 1) / 2;
    out[l.log_delta + i] += u[seg * l.A + x] + u[seg * l.A + y];
  }
}

}  // namespace

namespace {  // the launchers

struct DeviceInfo
{
  int device = 0, sms = 0;
  size_t smem_optin = 0;  // the most dynamic shared memory a block may take
};

std::mutex cache_lock;  // guards the caches below

// the current device's SM count and shared memory, read once
cudaError_t device_info(DeviceInfo* info)
{
  constexpr int MAX_DEVICES = 64;
  static DeviceInfo cache[MAX_DEVICES];
  int d = 0;
  cudaError_t err = cudaGetDevice(&d);
  if (err != cudaSuccess)
    return err;
  if (d >= MAX_DEVICES)
    return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(cache_lock);
  if (cache[d].sms == 0)
  {
    cudaDeviceProp p;
    if ((err = cudaGetDeviceProperties(&p, d)) != cudaSuccess)
      return err;
    cache[d].device = d;
    cache[d].smem_optin = p.sharedMemPerBlockOptin;
    cache[d].sms = p.multiProcessorCount;
  }
  *info = cache[d];
  return cudaSuccess;
}

// Lets `kernel` take up to the device's opt-in shared memory a block (past
// 48 KB a launch must be allowed its dynamic shared memory). The attribute
// is one setting of the kernel, which the launches of every host thread
// share, so it is set once per device and kernel, to the most that any
// launch asks for, and never changed.
cudaError_t allow_shared(const void* kernel, const DeviceInfo& dev)
{
  static std::set<std::pair<int, const void*>> allowed;
  std::lock_guard<std::mutex> hold(cache_lock);
  if (allowed.count({dev.device, kernel}))
    return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(dev.smem_optin));
  if (err == cudaSuccess)
    allowed.insert({dev.device, kernel});
  return err;
}

// Blocks of `kernel` that stay resident on the card with `smem` bytes of
// dynamic shared memory a block: the occupancy API x the SMs, cached per
// device, kernel and smem.
cudaError_t resident_blocks(const void* kernel, size_t smem, const DeviceInfo& dev, int64_t* blocks)
{
  static std::map<std::tuple<int, const void*, size_t>, int64_t> cache;
  const auto at = std::make_tuple(dev.device, kernel, smem);
  {
    std::lock_guard<std::mutex> hold(cache_lock);
    const auto hit = cache.find(at);
    if (hit != cache.end())
    {
      *blocks = hit->second;
      return cudaSuccess;
    }
  }
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, SS_THREADS, smem);
  if (err != cudaSuccess)
    return err;
  if (per_sm < 1)
    return cudaErrorInvalidConfiguration;
  *blocks = (int64_t)per_sm * dev.sms;
  std::lock_guard<std::mutex> hold(cache_lock);
  cache[at] = *blocks;
  return cudaSuccess;
}

struct Flush
{
  const int32_t* obs;
  int64_t N, n_samples;
  Layout l;
  int64_t* out;
  int64_t* u;
};

// the entries of the site-level block that a block's shared memory holds,
// from its first
int64_t shared_entries(const Layout& l, const DeviceInfo& dev)
{
  return std::min<int64_t>(l.size - l.clip_reads, dev.smem_optin / 8);
}

// Pass 1's shape: one row a lane, on as many blocks as that takes, while
// they all fit the card at once; there a block's few rows would not pay
// for zeroing and adding back a shared copy. Past that a persistent grid,
// each block with its copy of the site-level block's first entries
// (`n_shared`, 0 for none). The adds of a warp's rows are summed in the
// warp first (`group`) where the rows are many a site or many in all, and
// always with a shared copy.
struct Plan
{
  bool persistent = false;
  int64_t n_shared = 0;
  bool group = false;
};

template <int FA> cudaError_t plan_for(const Flush& f, const DeviceInfo& dev, Plan* plan)
{
  int64_t resident = 0;
  const cudaError_t err = resident_blocks(reinterpret_cast<const void*>(scoring_rows_kernel<FA, false, true>), 0,
                                          dev, &resident);
  if (err != cudaSuccess)
    return err;
  *plan = Plan{false, 0, f.N >= GROUP_MIN_ROWS || f.N >= GROUP_ROWS_A_SITE * f.l.n_sites};
  if ((f.N + SS_THREADS - 1) / SS_THREADS > resident)
    *plan = Plan{true, shared_entries(f.l, dev), true};
  return cudaSuccess;
}

template <int FA, bool SMEM, bool AGG>
cudaError_t launch_rows(const Flush& f, const Plan& plan, const DeviceInfo& dev, cudaStream_t s)
{
  const auto kernel = scoring_rows_kernel<FA, SMEM, AGG>;
  const void* k = reinterpret_cast<const void*>(kernel);
  const size_t smem = SMEM ? static_cast<size_t>(plan.n_shared) * 8 : 0;
  cudaError_t err;
  if (SMEM && (err = allow_shared(k, dev)) != cudaSuccess)
    return err;
  int64_t blocks = (f.N + SS_THREADS - 1) / SS_THREADS;
  if (plan.persistent)
  {
    int64_t resident = 0;
    if ((err = resident_blocks(k, smem, dev, &resident)) != cudaSuccess)
      return err;
    blocks = std::min(blocks, resident);
  }
  kernel<<<static_cast<int>(std::max<int64_t>(1, blocks)), SS_THREADS, smem, s>>>(
    f.obs, f.N, f.n_samples, f.l, SMEM ? plan.n_shared : 0, f.out, f.u);
  return cudaGetLastError();
}

// The whole apply on `s` under `plan`: one memset of the buffer (the
// vector, then u above A 4), pass 1, and pass 2 above A 4.
cudaError_t run(const Flush& f, const Plan& plan, const DeviceInfo& dev, cudaStream_t s)
{
  const int A = static_cast<int>(f.l.A);
  const int64_t entries = f.l.size + (folds(A) ? 0 : f.l.S * A);
  cudaError_t err = entries > 0 ? cudaMemsetAsync(f.out, 0, entries * 8, s) : cudaSuccess;
  if (err != cudaSuccess || f.N == 0)
    return err;
  err = with_fold(A, [&](auto fa) {
    constexpr int FA = decltype(fa)::value;
    if (plan.n_shared > 0)
      return launch_rows<FA, true, true>(f, plan, dev, s);
    return plan.group ? launch_rows<FA, false, true>(f, plan, dev, s) : launch_rows<FA, false, false>(f, plan, dev, s);
  });
  if (err != cudaSuccess || folds(A) || f.l.S == 0)
    return err;
  int64_t resident = 0;
  if ((err = resident_blocks(reinterpret_cast<const void*>(scoring_triangle_kernel), 0, dev, &resident))
      != cudaSuccess)
    return err;
  const int64_t total = f.l.S * f.l.T;
  const int blocks = static_cast<int>(std::max<int64_t>(1, std::min(resident, (total + SS_THREADS - 1) / SS_THREADS)));
  scoring_triangle_kernel<<<blocks, SS_THREADS, 0, s>>>(f.l, f.out, f.u);
  return cudaGetLastError();
}

// gt_site_scoring's plan for a flush of this shape on the current device
cudaError_t plan_of(const Flush& f, DeviceInfo* dev, Plan* plan)
{
  const cudaError_t err = device_info(dev);
  if (err != cudaSuccess)
    return err;
  return with_fold(static_cast<int>(f.l.A), [&](auto fa) { return plan_for<decltype(fa)::value>(f, *dev, plan); });
}

}  // namespace (the launchers)

// The flat vector's length for (A, n_sites, n_samples).
extern "C" int64_t gt_site_scoring_size(int A, int64_t n_sites, int64_t n_samples)
{
  return layout(A, n_sites, n_samples).size;
}

// The buffer gt_site_scoring takes: the flat vector, then u ([S][A]) when
// A is above FOLD_MAX_A.
extern "C" int64_t gt_site_scoring_buffer(int A, int64_t n_sites, int64_t n_samples)
{
  const Layout l = layout(A, n_sites, n_samples);
  return l.size + (folds(A) ? 0 : l.S * A);
}

// How many entries of the site-level block (n_sites (2 + 8A), from its
// first) a block keeps in shared memory in a flush of N rows of this shape
// on the current device (0 in a flush small enough for one row a lane);
// -1 on an error.
extern "C" int64_t gt_site_scoring_shared(int64_t N, int A, int64_t n_sites, int64_t n_samples)
{
  DeviceInfo dev;
  Plan plan;
  if (plan_of(Flush{nullptr, N, n_samples, layout(A, n_sites, n_samples), nullptr, nullptr}, &dev, &plan)
      != cudaSuccess)
    return -1;
  return plan.n_shared;
}

// `buf` (gt_site_scoring_buffer entries, any contents) ends with the flat
// vector in its first gt_site_scoring_size entries. On `stream`: one memset
// of `buf`, pass 1, and pass 2 above A 4; the first gt_site_scoring_shared
// entries of the site-level block go to shared memory.
extern "C" int gt_site_scoring(const int32_t* obs, int64_t N, int A, int64_t n_sites,
                               int64_t n_samples, int64_t* buf, void* stream)
{
  if (A < 1 || A > 64 || N < 0 || n_sites < 0 || n_samples < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(A, n_sites, n_samples);
  const Flush f{obs, N, n_samples, l, buf, buf + l.size};
  DeviceInfo dev;
  Plan plan;
  cudaError_t err = plan_of(f, &dev, &plan);
  if (err == cudaSuccess)
    err = run(f, plan, dev, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}
