// Batched semi-global affine-gap Smith-Waterman for indel realignment.
//
// Replaces graphtyper_tpu/ops/sw_rot.py sw_align_rot (Pallas kernel
// _sw_rot_kernel). Same function and same exactness contract: identical
// (score, database_begin, database_end) for every pair, under the tie rules
// written down at sw_rot.py:12-24 (E take_fresh on >=, F takes the start of
// the row above's final state, the clip-end best is lexicographic on
// (value desc, row asc, column asc), the last row keeps the smallest column
// among its maxima, a full query beats an end clip on an equal score, rows
// past qlen are frozen). Scores: match, -mismatch, gap open go (first gap
// base), extend ge, flat query-end clip; codes >= 4 score 0; database
// columns are free at both ends.
//
// Design: one thread per (query, database) pair, the layout the TPU kernel
// had across its (8, 128) lanes. Query rows run in the outer loop, database
// columns in the inner loop, with E, its start and the diagonal as register
// carries (the rotated kernel with a register block of one row). The
// previous row's final H, start and F live in scratch laid out [N][B], so
// the 32 threads of a warp touch 32 neighbouring words per column. Inputs
// arrive transposed the same way ([M][B] and [N][B] uint8 codes).
//
// What bounds it: integer ALU work (about 35 select/add/compare operations
// per cell, no multiply) and the latency of the three scratch loads per
// cell. A pair's DP is one sequential chain of M*N cells, so latency is
// hidden only by other warps; at the main path's batches (B = 1-40) one
// warp runs alone and the kernel is latency bound. An anti-diagonal
// wavefront or a warp per pair would fix that; this version is the simple
// exact one.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t NEG = -1000000;  // the JAX package's NEG = -(10**6)
constexpr int32_t BIG = 0x3FFFFFFF;

__global__ void sw_rot_kernel(const uint8_t* __restrict__ qT,    // [M][B]
                              const int32_t* __restrict__ qlen,  // [B]
                              const uint8_t* __restrict__ dT,    // [N][B]
                              const int32_t* __restrict__ dlen,  // [B]
                              int32_t* __restrict__ out,         // [3][B]
                              int32_t* __restrict__ Hs,          // [N][B]
                              int32_t* __restrict__ Ss,          // [N][B]
                              int32_t* __restrict__ Fs,          // [N][B]
                              int B, int M, int N,
                              int match, int mismatch, int go, int ge, int clip)
{
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B)
    return;
  const int ql = qlen[b];
  const int dl = dlen[b];

  // virtual row 0: H = 0 everywhere, start(column j+1) = j+1, F = NEG
  for (int j = 0; j < N; ++j)
  {
    const size_t o = (size_t)j * B + b;
    Hs[o] = 0;
    Ss[o] = j + 1;
    Fs[o] = NEG;
  }

  int bm = NEG, sm = 0, jm = 0, rm = BIG;  // clip-end best
  int fin = NEG, fin_j = 0, fin_s = 0;    // last-row best
  const int rows = ql < M ? ql : M;       // rows past qlen are frozen
  for (int i = 1; i <= rows; ++i)
  {
    const int qc = qT[(size_t)(i - 1) * B + b];
    const int fresh = (i == 1) ? 0 : -clip;  // restart after a clipped query head
    const bool mid_row = i < ql;
    const bool last_row = i == ql;
    int diag_H = (i == 1) ? 0 : NEG;  // H_final(row above, column j-1)
    int diag_S = 0;
    int Hlt = NEG, Slt = 0;  // H_tmp and its start at column j-1 of this row
    int E = NEG, SE = 0;
    for (int j = 0; j < N; ++j)
    {
      const size_t o = (size_t)j * B + b;
      const int top_H = Hs[o];
      const int top_S = Ss[o];
      const int top_F = Fs[o];
      const int dc = dT[o];
      const bool d_on = j < dl;

      int s = (qc == dc) ? match : -mismatch;
      if (qc >= 4 || dc >= 4)
        s = 0;
      if (!d_on)
        s = NEG;

      const bool use_fresh = fresh > diag_H;
      const int dv = use_fresh ? fresh : diag_H;
      const int dstart = use_fresh ? j : diag_S;
      const int Mc = dv + s;

      const int Fn = max(top_H - go, top_F - ge);
      const bool use_M = Mc >= Fn;
      const int Ht = use_M ? Mc : Fn;
      const int St = use_M ? dstart : top_S;

      // E(j) = max(E(j-1) - ge, H_tmp(j-1) - go); ties take the fresh term
      const bool take_fresh = Hlt - go >= E - ge;
      const int En = take_fresh ? Hlt - go : E - ge;
      const int SEn = take_fresh ? Slt : SE;

      const bool use_E = En > Ht;
      const int Hf = use_E ? En : Ht;
      const int Sf = use_E ? SEn : St;

      if (mid_row && d_on)
      {
        const int cand = Hf - clip;
        if (cand > bm || (cand == bm && i < rm))
        {
          bm = cand;
          sm = Sf;
          jm = j + 1;
          rm = i;
        }
      }
      if (last_row && d_on && Hf > fin)
      {
        fin = Hf;
        fin_j = j + 1;
        fin_s = Sf;
      }

      Hlt = Ht;
      Slt = St;
      E = En;
      SE = SEn;
      diag_H = top_H;
      diag_S = top_S;
      Hs[o] = Hf;
      Ss[o] = Sf;
      Fs[o] = Fn;
    }
  }

  const bool use_clip = bm > fin;
  out[b] = ql > 0 ? (use_clip ? bm : fin) : 0;
  out[B + b] = use_clip ? sm : fin_s;
  out[2 * B + b] = use_clip ? jm : fin_j;
}

}  // namespace

// Plain C entry point, bound with ctypes (graphtyper_tpu_torch/kernels.py).
// Launches on `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError() of the launch (0 when it was accepted).
extern "C" int gt_sw_rot(const uint8_t* qT, const int32_t* qlen, const uint8_t* dT,
                         const int32_t* dlen, int32_t* out, int32_t* Hs, int32_t* Ss,
                         int32_t* Fs, int B, int M, int N, int match, int mismatch, int go,
                         int ge, int clip, void* stream)
{
  if (B <= 0)
    return 0;
  const int threads = 64;
  const int blocks = (B + threads - 1) / threads;
  sw_rot_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
    qT, qlen, dT, dlen, out, Hs, Ss, Fs, B, M, N, match, mismatch, go, ge, clip);
  return static_cast<int>(cudaGetLastError());
}
