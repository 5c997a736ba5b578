// Batched semi-global affine-gap Smith-Waterman, row-scan layout: one warp
// per (query, database) pair.
//
// Replaces graphtyper_tpu/ops/sw_pallas.py sw_align_pallas (Pallas kernel
// _sw_kernel, pallas_call at :257). Same function as csrc/sw_rot.cu and the
// same exactness contract: identical (score, database_begin, database_end)
// for every pair. Scores: match, -mismatch, gap open go (first gap base),
// extend ge, flat query-end clip; codes >= 4 score 0 (:121); database
// columns at or past dlen score NEG (:122) and are free at both ends.
//
// Design. The Pallas kernel spans database columns over vector lanes and
// computes each DP row at once, the row's horizontal gap E being a prefix
// max over columns (:48-59, :138-145). Here a warp takes one pair: lane l
// owns the strip of C = ceil(N / 32) neighbouring columns [l*C, l*C + C).
// The strip's H, F and start live in registers, and so do the lane's best
// clip-end candidate, its start, row and column. The query is staged in
// shared memory; query rows run in the outer loop, and rows past qlen are
// never computed (the Pallas kernel freezes them). Per row:
//   1. the diagonal of the strip's first column comes from the lane to the
//      left (one shuffle); M and F per column, in registers;
//   2. E = prefix max over columns of T = H_tmp + (j+1)*ge carrying the
//      start: sequential inside the strip, then a 5-step __shfl_up_sync
//      scan of the strip tails across the warp, then a fix-up pass over the
//      strip with the carry from the lanes to the left;
//   3. H, start and the clip-end candidates (rows i < qlen) are updated.
// At the end a butterfly reduction picks the lexicographic best of
// :166-188: the largest value, a full query winning a tie against an end
// clip, then the smallest row * (N + 2) + column.
//
// Tie rules. The Pallas scan takes the earlier lane only when it is
// strictly greater (:55): among equal prefix values the latest column's
// start wins (the host DP's _running_argmax). Every combine here, inside
// the strip and across the warp, is "the later element unless the earlier
// one is strictly greater", which is associative, so every bracketing
// gives the Pallas result; the fill (NEG, 0) that the Pallas shift puts in
// front of column 0 is applied once to each lane's carry. M wins against F
// on >= (:134), E wins only on > (:143).
//
// Sentinels, as sw_align_plain and sw_rot.cu give them: qlen = 0 gives
// (0, 0, 0); no valid database column gives (NEG, 0, 0).
//
// What bounds it. Integer ALU work: the recurrence of :119-157 needs 26
// int32 adds, compares and selects per DP cell of the rows i <= qlen and
// columns j < dlen, on 132 SMs x 64 int32 lanes (PERF.md, chip_smoke.py's
// SW_OPS_PER_CELL); the bytes moved (B * (M + N) codes in,
// 12 bytes a pair out) are negligible. A pair's row is one warp's work, so
// a batch of B pairs keeps B warps busy: at the main path's 1-40 pairs the
// kernel is latency bound on one warp's chain of rows (about 2C dependent
// combines and 6 shuffle rounds a row), not on a chain of M*N cells as in
// sw_rot.cu's thread per pair.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t NEG = -1000000;  // the JAX package's NEG = -(10**6)
constexpr int32_t BIG = 0x3FFFFFFF;
constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SW_ROW_WARPS = 4;  // warps (pairs) per block

// (value, key, payload) butterfly: the largest value, then the smallest key;
// every lane ends with the same triple
__device__ __forceinline__ void warp_best(int& v, int& k, int& p)
{
  for (int off = WARP / 2; off > 0; off >>= 1)
  {
    const int ov = __shfl_xor_sync(FULL, v, off);
    const int ok = __shfl_xor_sync(FULL, k, off);
    const int op = __shfl_xor_sync(FULL, p, off);
    if (ov > v || (ov == v && ok < k))
    {
      v = ov;
      k = ok;
      p = op;
    }
  }
}

template <int C>
__global__ void sw_row_kernel(const uint8_t* __restrict__ q,     // [B][M]
                              const int32_t* __restrict__ qlen,  // [B]
                              const uint8_t* __restrict__ d,     // [B][N]
                              const int32_t* __restrict__ dlen,  // [B]
                              int32_t* __restrict__ out,         // [3][B]
                              int B, int M, int N,
                              int match, int mismatch, int go, int ge, int clip)
{
  extern __shared__ uint8_t q_smem[];  // SW_ROW_WARPS x M query codes
  const int lane = threadIdx.x % WARP;
  const int warp = threadIdx.x / WARP;
  const int b = blockIdx.x * SW_ROW_WARPS + warp;
  if (b >= B)
    return;  // warp-uniform
  const int ql = qlen[b];
  if (ql <= 0)
  {
    if (lane == 0)
    {
      out[b] = 0;
      out[B + b] = 0;
      out[2 * B + b] = 0;
    }
    return;
  }
  const int rows = ql < M ? ql : M;
  const int dl = dlen[b] < N ? dlen[b] : N;
  uint8_t* qs = q_smem + (size_t)warp * M;
  for (int i = lane; i < rows; i += WARP)
    qs[i] = q[(size_t)b * M + i];
  __syncwarp();

  const int j0 = lane * C;  // the strip's first column (0-based)
  int dc[C], H[C], F[C], S[C];
#pragma unroll
  for (int c = 0; c < C; ++c)
  {
    const int j = j0 + c;
    dc[c] = j < N ? d[(size_t)b * N + j] : 5;
    H[c] = 0;      // virtual row 0
    F[c] = NEG;
    S[c] = j + 1;  // a free database start: column j + 1 starts at j + 1
  }
  int bm = NEG, bk = BIG, bs = 0;  // the strip's best clip-end: value, row*(N+2)+j+1, start

  for (int i = 1; i <= rows; ++i)
  {
    const int qb = qs[i - 1];
    const int fresh = (i == 1) ? 0 : -clip;  // restart after a clipped query head
    // H and start of column j0 - 1 in the row above (:125-126)
    int hd = __shfl_up_sync(FULL, H[C - 1], 1);
    int sd = __shfl_up_sync(FULL, S[C - 1], 1);
    if (lane == 0)
    {
      hd = (i == 1) ? 0 : NEG;
      sd = 0;
    }

    // M, F and H_tmp per column (:119-136); the strip's inclusive prefix of
    // (T, start) in (tv, ta), the later column winning a tie
    int tv = NEG, ta = 0;
#pragma unroll
    for (int c = 0; c < C; ++c)
    {
      const int j = j0 + c;
      int s = (qb == dc[c]) ? match : -mismatch;
      if (qb >= 4 || dc[c] >= 4)
        s = 0;
      if (j >= dl)
        s = NEG;
      const bool use_fresh = fresh > hd;
      const int mc = (use_fresh ? fresh : hd) + s;
      const int dstart = use_fresh ? j : sd;
      const int h_up = H[c], s_up = S[c];
      const int fn = max(h_up - go, F[c] - ge);
      const bool use_m = mc >= fn;
      F[c] = fn;
      H[c] = use_m ? mc : fn;      // H_tmp
      S[c] = use_m ? dstart : s_up;  // its start
      const int t = H[c] + (j + 1) * ge;
      if (c == 0 || t >= tv)
      {
        tv = t;
        ta = S[c];
      }
      hd = h_up;
      sd = s_up;
    }

    // inclusive scan of the strip tails over the lanes, then the exclusive
    // carry of lane l: the prefix of columns [0, l*C) behind the fill (NEG, 0)
#pragma unroll
    for (int off = 1; off < WARP; off <<= 1)
    {
      const int ov = __shfl_up_sync(FULL, tv, off);
      const int oa = __shfl_up_sync(FULL, ta, off);
      if (lane >= off && ov > tv)
      {
        tv = ov;
        ta = oa;
      }
    }
    int rv = __shfl_up_sync(FULL, tv, 1);
    int ra = __shfl_up_sync(FULL, ta, 1);
    if (lane == 0 || NEG > rv)
    {
      rv = NEG;
      ra = 0;
    }

    // E and the row's final H and start (:138-149); clip-end candidates (:152-157)
    const bool mid_row = i < ql;
#pragma unroll
    for (int c = 0; c < C; ++c)
    {
      const int j = j0 + c;
      const int ht = H[c], st = S[c];
      const int e = rv - go - j * ge;
      if (e > ht)
      {
        H[c] = e;
        S[c] = ra;
      }
      const int t = ht + (j + 1) * ge;
      if (t >= rv)
      {
        rv = t;
        ra = st;
      }
      if (mid_row && j < dl && H[c] - clip > bm)
      {
        bm = H[c] - clip;
        bk = i * (N + 2) + j + 1;
        bs = S[c];
      }
    }
  }

  // the last row's best: the largest H over valid columns, then the smallest column
  int fv = NEG, fk = BIG, fs = 0;
#pragma unroll
  for (int c = 0; c < C; ++c)
  {
    const int j = j0 + c;
    if (j < dl && H[c] > fv)
    {
      fv = H[c];
      fk = j + 1;
      fs = S[c];
    }
  }
  warp_best(fv, fk, fs);
  warp_best(bm, bk, bs);
  if (lane == 0)
  {
    const bool use_clip = bm > fv;  // strict: a full query wins a tie
    if (use_clip)
    {
      out[b] = bm;
      out[B + b] = bs;
      out[2 * B + b] = bk % (N + 2);
    }
    else if (fk != BIG)
    {
      out[b] = fv;
      out[B + b] = fs;
      out[2 * B + b] = fk;
    }
    else  // no valid database column
    {
      out[b] = NEG;
      out[B + b] = 0;
      out[2 * B + b] = 0;
    }
  }
}

template <int C>
int launch(const uint8_t* q, const int32_t* qlen, const uint8_t* d, const int32_t* dlen,
           int32_t* out, int B, int M, int N, int match, int mismatch, int go, int ge,
           int clip, cudaStream_t stream)
{
  const int blocks = (B + SW_ROW_WARPS - 1) / SW_ROW_WARPS;
  const size_t smem = (size_t)SW_ROW_WARPS * M;
  sw_row_kernel<C><<<blocks, SW_ROW_WARPS * WARP, smem, stream>>>(
    q, qlen, d, dlen, out, B, M, N, match, mismatch, go, ge, clip);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes (graphtyper_tpu_torch/kernels.py).
// q [B][M] and d [B][N] uint8 codes, row-major as the caller holds them;
// out [3][B] int32. Takes N <= 512 (a strip of at most 16 columns a lane)
// and M <= 12288 (the staged queries within 48 KB of shared memory); returns
// cudaErrorInvalidValue outside that. Launches on `stream`, allocates
// nothing, does not synchronise; returns cudaGetLastError() of the launch.
extern "C" int gt_sw_row(const uint8_t* q, const int32_t* qlen, const uint8_t* d,
                         const int32_t* dlen, int32_t* out, int B, int M, int N, int match,
                         int mismatch, int go, int ge, int clip, void* stream)
{
  if (B <= 0)
    return 0;
  if (N < 0 || N > 16 * WARP || M < 0 || M > 12288)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= WARP)
    return launch<1>(q, qlen, d, dlen, out, B, M, N, match, mismatch, go, ge, clip, s);
  if (N <= 2 * WARP)
    return launch<2>(q, qlen, d, dlen, out, B, M, N, match, mismatch, go, ge, clip, s);
  if (N <= 4 * WARP)
    return launch<4>(q, qlen, d, dlen, out, B, M, N, match, mismatch, go, ge, clip, s);
  if (N <= 8 * WARP)
    return launch<8>(q, qlen, d, dlen, out, B, M, N, match, mismatch, go, ge, clip, s);
  return launch<16>(q, qlen, d, dlen, out, B, M, N, match, mismatch, go, ge, clip, s);
}
