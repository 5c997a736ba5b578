// Batched semi-global affine-gap Smith-Waterman for indel realignment, the
// main path's kernel: one warp per (query, database) pair, the query rows
// spread over the lanes in an anti-diagonal wavefront.
//
// Replaces graphtyper_tpu/ops/sw_rot.py sw_align_rot (Pallas kernel
// _sw_rot_kernel, pallas_call at :282). Same function and same exactness
// contract: identical (score, database_begin, database_end) for every pair,
// under the tie rules written down at sw_rot.py:12-24. Scores: match,
// -mismatch, gap open go (first gap base), extend ge, flat query-end clip;
// codes >= 4 score 0; database columns are free at both ends.
//
// Design. The Pallas kernel runs query rows in register blocks, database
// columns in order, with E and F as register carries (sw_rot.py:1-10). The
// same recurrence runs here, one pair over the 32 lanes of a warp:
//   - Rows across lanes. Lane l owns R consecutive query rows of a band of
//     32 * R rows; R = ceil(min(M, 256) / 32), 1 to 8, is a template
//     parameter (M = 151 gives R = 5 over 31 lanes).
//   - Wavefront. At step t lane l computes column j = t - l for its R rows,
//     top to bottom. By one __shfl_up_sync each of final H, its start and F
//     it takes the bottom row of lane l - 1 at column j, which that lane
//     computed at step t - 1; the value it took one step earlier is its
//     first row's diagonal. Lane 0 takes the band's top boundary: virtual
//     row 0 (H 0, start j + 1, F NEG) for the first band. The wavefront
//     ends at column min(dlen, N) - 1: a column at or past dlen feeds only
//     such columns (E flows right, F down) and never reaches the output.
//     A pair takes about min(dlen, N) + 31 steps, not M * N serial cells.
//   - Carries per row, in registers: E and its start, H_tmp and its start
//     at column j - 1 (E(j) = max(E(j-1) - ge, H_tmp(j-1) - go), the fresh
//     term winning a tie), final H and its start at column j - 1 (the
//     diagonal of the row below), the query code, and the row's best
//     (value, column + 1, start): the largest H, the smallest column among
//     its maxima.
//   - Lockstep. Every lane runs every shuffle with the full mask; a lane
//     with no row or no column in a step computes nothing that step.
//   - Bands. A query of more than 256 rows runs in bands of 256 rows, one
//     after another in the same warp. The band's last lane writes its
//     bottom row (final H, start, F per column) to a [3][B][N] scratch, the
//     Pallas kernel's boundary row (Hrow/Srow/Frow, sw_rot.py:68-70); lane 0
//     of the next band reads it back after a fence and __syncwarp(). Inside
//     a band lane 0 reads column j at step j and lane 31 overwrites it at
//     step j + 31, after lane 0 has consumed it.
//   - Outputs. After each band a lane folds its rows' bests in row order:
//     the clip-end best over rows i < qlen (value - clip, strictly greater,
//     so the earliest row wins a tie), and the last row's best (row qlen).
//     Butterfly reductions on (value, row, column) pick the warp's; a full
//     query wins a tie against an end clip. qlen = 0 gives (0, 0, 0); no
//     valid column gives (NEG, 0, 0).
//
// What bounds it. Integer ALU work, about 26 int32 operations per DP cell
// of rows i <= qlen and columns j < dlen (chip_smoke.py SW_OPS_PER_CELL)
// on 132 SMs x 64 int32 lanes; the bytes (codes in, 12 bytes a pair out)
// are negligible. At the main path's 1-40 pairs a few warps run alone and
// the time is their dependent chain: per step, one shuffle round and R
// cells whose final H feeds the row below (about 4 dependent operations a
// cell: the F max, M against F, E against H_tmp). The wavefront makes that
// chain min(dlen, N) + 31 steps long instead of M * N cells; at large
// batches the warps of an SM hide each other's latency.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int32_t NEG = -1000000;  // the JAX package's NEG = -(10**6)
constexpr int32_t BIG = 0x3FFFFFFF;
constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SW_ROT_WARPS = 4;  // warps (pairs) per block
constexpr int MAX_R = 8;         // rows a lane at most
constexpr int BAND_ROWS = WARP * MAX_R;  // query rows of one band (256)

// (value, row, column, start) butterfly: the largest value, then the
// smallest row, then the smallest column; every lane ends with the same
__device__ __forceinline__ void warp_best(int& v, int& r, int& c, int& s)
{
  for (int off = WARP / 2; off > 0; off >>= 1)
  {
    const int ov = __shfl_xor_sync(FULL, v, off);
    const int orow = __shfl_xor_sync(FULL, r, off);
    const int oc = __shfl_xor_sync(FULL, c, off);
    const int os = __shfl_xor_sync(FULL, s, off);
    if (ov > v || (ov == v && (orow < r || (orow == r && oc < c))))
    {
      v = ov;
      r = orow;
      c = oc;
      s = os;
    }
  }
}

template <int R>
__global__ void sw_rot_kernel(const uint8_t* __restrict__ q,     // [B][M]
                              const int32_t* __restrict__ qlen,  // [B]
                              const uint8_t* __restrict__ d,     // [B][N]
                              const int32_t* __restrict__ dlen,  // [B]
                              int32_t* __restrict__ out,         // [3][B]
                              int32_t* __restrict__ scratch,     // [3][B][N] when M > 32 * R
                              int B, int M, int N,
                              int match, int mismatch, int go, int ge, int clip)
{
  const int lane = threadIdx.x % WARP;
  const int b = blockIdx.x * SW_ROT_WARPS + threadIdx.x / WARP;
  if (b >= B)
    return;  // warp-uniform
  const int ql = qlen[b];
  const int rows = ql < M ? ql : M;             // rows past qlen are frozen
  const int cols = max(0, min(dlen[b], N));     // columns that reach the output
  const uint8_t* db = d + (size_t)b * N;
  const size_t plane = (size_t)B * N;

  int bm = NEG, br = BIG, bc = 0, bs = 0;  // clip-end best: value, row, column + 1, start
  int fv = NEG, fc = 0, fs = 0;            // last-row best: value, column + 1, start

  for (int base = 0; base < rows; base += WARP * R)
  {
    const int i0 = base + lane * R + 1;  // the lane's first row (1-based)
    const int busy = min(WARP, (rows - base + R - 1) / R);  // lanes with a row
    const bool first_band = base == 0;
    const bool last_band = base + WARP * R >= rows;

    int qc[R], Hp[R], Sp[R], Hlt[R], Slt[R], E[R], SE[R], rb[R], rc[R], rs[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
    {
      const int i = i0 + r;
      qc[r] = i <= rows ? q[(size_t)b * M + i - 1] : 5;
      Hp[r] = NEG;  // final H and start at column j - 1: the row below's diagonal
      Sp[r] = 0;
      Hlt[r] = NEG;  // H_tmp and its start at column j - 1
      Slt[r] = 0;
      E[r] = NEG;
      SE[r] = 0;
      rb[r] = NEG;  // the row's best: value, column + 1, start
      rc[r] = 0;
      rs[r] = 0;
    }
    int pH = (i0 == 1) ? 0 : NEG;  // the row above's final H and start at column j - 1
    int pS = 0;
    int oH = 0, oS = 0, oF = NEG;  // the bottom row's final H, start and F at the last column

    const int steps = cols + busy - 1;
    for (int t = 0; t < steps; ++t)
    {
      int tH = __shfl_up_sync(FULL, oH, 1);  // the row above at column j
      int tS = __shfl_up_sync(FULL, oS, 1);
      int tF = __shfl_up_sync(FULL, oF, 1);
      const int j = t - lane;
      if (lane < busy && j >= 0 && j < cols)
      {
        if (lane == 0)
        {
          if (first_band)  // virtual row 0
          {
            tH = 0;
            tS = j + 1;
            tF = NEG;
          }
          else  // the previous band's bottom row
          {
            const size_t o = (size_t)b * N + j;
            tH = scratch[o];
            tS = scratch[plane + o];
            tF = scratch[2 * plane + o];
          }
        }
        const int dc = __ldg(db + j);
        int dH = pH, dS = pS;  // diagonal: the row above at column j - 1
        pH = tH;
        pS = tS;
#pragma unroll
        for (int r = 0; r < R; ++r)
        {
          const int fresh = (i0 + r == 1) ? 0 : -clip;  // restart after a clipped query head
          int s = (qc[r] == dc) ? match : -mismatch;
          if (qc[r] >= 4 || dc >= 4)
            s = 0;
          const bool use_fresh = fresh > dH;
          const int mc = (use_fresh ? fresh : dH) + s;
          const int dstart = use_fresh ? j : dS;

          const int fn = max(tH - go, tF - ge);
          const bool use_m = mc >= fn;
          const int ht = use_m ? mc : fn;
          const int st = use_m ? dstart : tS;

          const bool take_fresh = Hlt[r] - go >= E[r] - ge;
          const int en = take_fresh ? Hlt[r] - go : E[r] - ge;
          const int sen = take_fresh ? Slt[r] : SE[r];

          const bool use_e = en > ht;
          const int hf = use_e ? en : ht;
          const int sf = use_e ? sen : st;

          if (hf > rb[r])  // columns run in order: the smallest column among maxima
          {
            rb[r] = hf;
            rc[r] = j + 1;
            rs[r] = sf;
          }
          Hlt[r] = ht;
          Slt[r] = st;
          E[r] = en;
          SE[r] = sen;
          dH = Hp[r];
          dS = Sp[r];
          Hp[r] = hf;
          Sp[r] = sf;
          tH = hf;
          tS = sf;
          tF = fn;
        }
        oH = tH;
        oS = tS;
        oF = tF;
        if (!last_band && lane == WARP - 1)
        {
          const size_t o = (size_t)b * N + j;
          scratch[o] = oH;
          scratch[plane + o] = oS;
          scratch[2 * plane + o] = oF;
        }
      }
    }

    // the band's rows in order: an earlier row wins a tie
#pragma unroll
    for (int r = 0; r < R; ++r)
    {
      const int i = i0 + r;
      if (i < ql && i <= rows && rb[r] - clip > bm)
      {
        bm = rb[r] - clip;
        br = i;
        bc = rc[r];
        bs = rs[r];
      }
      if (i == ql && i <= rows)
      {
        fv = rb[r];
        fc = rc[r];
        fs = rs[r];
      }
    }
    __threadfence_block();
    __syncwarp();  // the next band's lane 0 reads what lane 31 wrote
  }

  int fr = 0;  // one lane holds row qlen
  warp_best(fv, fr, fc, fs);
  warp_best(bm, br, bc, bs);
  if (lane == 0)
  {
    const bool use_clip = bm > fv;  // a full query wins a tie
    out[b] = ql > 0 ? (use_clip ? bm : fv) : 0;
    out[B + b] = use_clip ? bs : fs;
    out[2 * B + b] = use_clip ? bc : fc;
  }
}

// f(std::integral_constant<int, R>{}) with the rows a lane of a query of M
// rows: R = ceil(min(M, BAND_ROWS) / WARP), at least 1
template <class F>
int with_rows(int M, F&& f)
{
  const int band = M < BAND_ROWS ? M : BAND_ROWS;  // rows of the first band
  switch (band <= WARP ? 1 : (band + WARP - 1) / WARP)
  {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    default: return f(std::integral_constant<int, MAX_R>{});
  }
}

template <int R>
int launch(const uint8_t* q, const int32_t* qlen, const uint8_t* d, const int32_t* dlen,
           int32_t* out, int32_t* scratch, int B, int M, int N, int match, int mismatch,
           int go, int ge, int clip, cudaStream_t stream)
{
  const int blocks = (B + SW_ROT_WARPS - 1) / SW_ROT_WARPS;
  sw_rot_kernel<R><<<blocks, SW_ROT_WARPS * WARP, 0, stream>>>(
    q, qlen, d, dlen, out, scratch, B, M, N, match, mismatch, go, ge, clip);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes (graphtyper_tpu_torch/kernels.py).
// q [B][M] and d [B][N] uint8 codes, row-major as the caller holds them;
// out [3][B] int32; scratch [3][B][N] int32, needed only when M >
// gt_sw_rot_band_rows() (may be null otherwise). Launches on `stream`,
// allocates nothing, does not synchronise; returns cudaGetLastError() of the
// launch (0 when accepted), or cudaErrorInvalidValue for a negative M or N,
// or a query of more than one band without scratch.
extern "C" int gt_sw_rot(const uint8_t* q, const int32_t* qlen, const uint8_t* d,
                         const int32_t* dlen, int32_t* out, int32_t* scratch, int B, int M,
                         int N, int match, int mismatch, int go, int ge, int clip, void* stream)
{
  if (B <= 0)
    return 0;
  if (M < 0 || N < 0 || (M > BAND_ROWS && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_rows(M, [&](auto r) {
    return launch<decltype(r)::value>(q, qlen, d, dlen, out, scratch, B, M, N, match, mismatch, go,
                                      ge, clip, s);
  });
}

// The query rows of one band: a query of more rows needs gt_sw_rot's scratch.
extern "C" int gt_sw_rot_band_rows() { return BAND_ROWS; }
