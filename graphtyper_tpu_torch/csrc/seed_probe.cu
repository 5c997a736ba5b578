// Device seeding: the 97 exact and Hamming-1 probes of every kmer, tested
// against the index's membership bitset and packed into candidate words.
// One warp per row.
//
// Replaces graphtyper_tpu/ops/seed_probe.py _probe_bits_impl (:92, the
// jitted XLA op behind DeviceSeeder.probe_bits). Same output bit for bit:
// bit b = kpos * 97 + j of row r's words is set iff probe j of kmer kpos
// passes (native/gt_align.cpp CandView), and bits past 97 * nk are 0, the
// JAX code's pad (:114-116). Probe j = 0 is the key itself; j > 0 flips
// two-bit position (j - 1) / 3 by xor with (j - 1) % 3 + 1, the order of
// _ham_masks (:43-57). A probe's bitset index is the top `bits` bits of
// lo * HASH_C1 + hi * HASH_C2 in uint32 (:106-107, gt_build_seed_bitset).
//
// What bounds it. Per row it reads 9 bytes a kmer and writes 4 bytes a
// word (88 bytes at nk = 4), and the bitset once (2 to 32 MB, which stays
// in the 50 MB L2). The integer work is about 10 operations a probe, 97 nk
// probes a row (chip_smoke.py counts both for the bound). In practice every
// probe is one 4-byte gather at a random place of the bitset, a sector of
// its own in the L2, so the kernel is bound by the L2's rate of random
// sector reads; chip_smoke.py's "gather" line measures that rate on the
// card (csrc/gather.cu).
//
// Design. Warp w takes whole rows. Kmers go in chunks of 32: the 32 * 97
// bits of a chunk are exactly its 97 words, so chunk c fills words
// 97 c .. 97 c + 96 of the row. Lane k loads kmer 32 c + k's key and flag
// once, coalesced, and __shfl_sync hands them to the lanes that probe it.
// Lane l takes bit 32 w + l of each word w; its (kmer, probe) pair moves by
// 32 bits a word, one compare and subtract instead of a division, and the
// probe's xor mask comes from a table in shared memory. A lane issues the
// gathers of WORDS_IN_FLIGHT words before it tests any (13 at nk = 4), so
// a warp keeps 32 * 13 loads in flight. Then one __ballot_sync a word packs
// the bits in lane order, lane i keeps word i, and the group's words are
// stored coalesced. Every lane takes part in each shuffle and ballot; only
// the loads are masked. The engine writes valid as 0 or 1 only
// (native/gt_align.cpp:3584-3586 and gt_stream_stage), so testing
// valid != 0 is the JAX code's multiplication by valid.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int PROBES = 97;
constexpr uint32_t HASH_C1 = 0x9E3779B1u;  // native/gt_align.cpp gt_build_seed_bitset
constexpr uint32_t HASH_C2 = 0x85EBCA77u;
constexpr int SP_THREADS = 256;
constexpr int WORDS_IN_FLIGHT = 16;  // words whose gathers a lane issues before it tests any
constexpr int SP_MAX_BLOCKS = 1 << 12;
constexpr unsigned FULL = 0xffffffffu;

// the xor masks of the 97 probes, (hi, lo) halves
__shared__ uint32_t sp_mask_hi[PROBES];
__shared__ uint32_t sp_mask_lo[PROBES];

__global__ void __launch_bounds__(SP_THREADS)
seed_probe_kernel(const uint32_t* __restrict__ hi,      // [S][nk] exact kmer keys, high halves
                  const uint32_t* __restrict__ lo,      // [S][nk]
                  const uint8_t* __restrict__ valid,    // [S][nk], 0 or 1
                  const uint32_t* __restrict__ bitset,  // [2^(bits - 5)]
                  uint32_t* __restrict__ out,           // [S][prow]
                  int S, int nk, int prow, int bits)
{
  for (int j = threadIdx.x; j < PROBES; j += blockDim.x)
  {
    const uint64_t m = j == 0 ? 0 : (uint64_t)((j - 1) % 3 + 1) << (2 * ((j - 1) / 3));
    sp_mask_hi[j] = (uint32_t)(m >> 32);
    sp_mask_lo[j] = (uint32_t)m;
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int warps = gridDim.x * (blockDim.x / 32);
  // row is the same on every lane of a warp, so every loop below is
  // warp-uniform
  for (int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32; row < S; row += warps)
  {
    for (int c = 0; 32 * c < nk; ++c)
    {
      const int kc = min(nk - 32 * c, 32);  // kmers of the chunk
      const int wc = min(prow - PROBES * c, PROBES);  // its words
      uint32_t key_hi = 0, key_lo = 0;
      int key_ok = 0;
      if (lane < kc)
      {
        const int64_t o = (int64_t)row * nk + 32 * c + lane;
        key_hi = hi[o];
        key_lo = lo[o];
        key_ok = valid[o] != 0;
      }
      uint32_t* dst = out + (int64_t)row * prow + PROBES * c;
      for (int w0 = 0; w0 < wc; w0 += WORDS_IN_FLIGHT)
      {
        // lane's bit b of word w0 of the chunk: kmer kpos, probe j
        const int b = 32 * w0 + lane;
        int kpos = b / PROBES;
        int j = b - kpos * PROBES;
        uint32_t got[WORDS_IN_FLIGHT], shift[WORDS_IN_FLIGHT];
#pragma unroll
        for (int i = 0; i < WORDS_IN_FLIGHT; ++i)
        {
          const uint32_t ph = __shfl_sync(FULL, key_hi, kpos & 31) ^ sp_mask_hi[j];
          const uint32_t pl = __shfl_sync(FULL, key_lo, kpos & 31) ^ sp_mask_lo[j];
          const int ok = __shfl_sync(FULL, key_ok, kpos & 31);
          const uint32_t idx = (pl * HASH_C1 + ph * HASH_C2) >> (32 - bits);
          got[i] = 0;
          if (ok != 0 && kpos < kc && w0 + i < wc)
            got[i] = __ldg(bitset + (idx >> 5));
          shift[i] = idx & 31u;
          j += 32;
          if (j >= PROBES)
          {
            j -= PROBES;
            ++kpos;
          }
        }
        uint32_t mine = 0;
#pragma unroll
        for (int i = 0; i < WORDS_IN_FLIGHT; ++i)
        {
          const uint32_t word = __ballot_sync(FULL, (got[i] >> shift[i]) & 1u);
          if (lane == i)
            mine = word;
        }
        if (lane < WORDS_IN_FLIGHT && w0 + lane < wc)
          dst[w0 + lane] = mine;
      }
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes (graphtyper_tpu_torch/kernels.py).
// hi, lo, valid [S][nk]; bitset of 2^(bits - 5) uint32 words, 6 <= bits <= 32;
// out [S][prow] uint32, prow = ceil(97 nk / 32), S * prow < 2^30. Launches on `stream`, allocates
// nothing, does not synchronise; returns cudaGetLastError() of the launch.
extern "C" int gt_seed_probe(const uint32_t* hi, const uint32_t* lo, const uint8_t* valid,
                             const uint32_t* bitset, uint32_t* out, int S, int nk, int bits,
                             void* stream)
{
  if (S <= 0)
    return 0;
  const int64_t prow = ((int64_t)nk * PROBES + 31) / 32;
  if (nk <= 0 || bits < 6 || bits > 32 || (int64_t)S * prow >= (1ll << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const int warps_per_block = SP_THREADS / 32;
  const int blocks = std::min((S + warps_per_block - 1) / warps_per_block, SP_MAX_BLOCKS);
  seed_probe_kernel<<<blocks, SP_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
    hi, lo, valid, bitset, out, S, nk, (int)prow, bits);
  return static_cast<int>(cudaGetLastError());
}
