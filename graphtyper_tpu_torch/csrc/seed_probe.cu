// Device seeding: the 97 exact and Hamming-1 probes of every kmer, tested
// against the index's membership bitset and packed into candidate words.
// One warp per output word.
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
// Design. Word w of the output is warp w's: lane i takes flat bit
// 32 (w % prow) + i of row w / prow, builds its probe, gathers its bitset
// word and tests its bit, and the warp's __ballot_sync packs the 32 bits in
// lane order; lane 0 stores the word. Every lane takes part in the ballot
// and only the arithmetic is masked. The engine writes valid as 0 or 1 only
// (native/gt_align.cpp:3584-3586 and gt_stream_stage), so testing
// valid != 0 is the JAX code's multiplication by valid.
//
// What bounds it. Per row it reads 9 bytes a kmer and writes 4 bytes a
// word (88 bytes at nk = 4), and the bitset once (2 to 32 MB, which stays
// in the 50 MB L2). The integer work is about 10 operations a probe, 97 nk
// probes a row, which at 2^19 rows and nk = 4 takes longer on 132 SMs x 64
// int32 lanes than the bytes take at 3.35 TB/s (chip_smoke.py counts both).
// One gather per lane into an L2-resident table; a grid-stride loop over
// the words keeps 64 warps an SM busy.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int PROBES = 97;
constexpr uint32_t HASH_C1 = 0x9E3779B1u;  // native/gt_align.cpp gt_build_seed_bitset
constexpr uint32_t HASH_C2 = 0x85EBCA77u;
constexpr int SP_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(SP_THREADS)
seed_probe_kernel(const uint32_t* __restrict__ hi,      // [S][nk] exact kmer keys, high halves
                  const uint32_t* __restrict__ lo,      // [S][nk]
                  const uint8_t* __restrict__ valid,    // [S][nk], 0 or 1
                  const uint32_t* __restrict__ bitset,  // [2^(bits - 5)]
                  uint32_t* __restrict__ out,           // [S][prow]
                  int n_words, int nk, int prow, int bits)
{
  const int lane = threadIdx.x % 32;
  const int warps = gridDim.x * (blockDim.x / 32);
  // w is the same on every lane of a warp, so the loop and the ballot are
  // warp-uniform
  for (int w = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32; w < n_words; w += warps)
  {
    const int row = w / prow;
    const int b = (w - row * prow) * 32 + lane;
    const int kpos = b / PROBES;
    const int j = b - kpos * PROBES;
    uint32_t bit = 0;
    if (kpos < nk)
    {
      const int64_t o = (int64_t)row * nk + kpos;
      if (valid[o] != 0)
      {
        uint32_t ph = hi[o], pl = lo[o];
        if (j > 0)
        {
          const uint64_t m = (uint64_t)((j - 1) % 3 + 1) << (2 * ((j - 1) / 3));
          ph ^= (uint32_t)(m >> 32);
          pl ^= (uint32_t)m;
        }
        const uint32_t h = pl * HASH_C1 + ph * HASH_C2;
        const uint32_t idx = h >> (32 - bits);
        bit = (__ldg(bitset + (idx >> 5)) >> (idx & 31u)) & 1u;
      }
    }
    const uint32_t word = __ballot_sync(FULL, bit != 0);
    if (lane == 0)
      out[w] = word;
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
  const int n_words = (int)(S * prow);
  const int warps_per_block = SP_THREADS / 32;
  const int blocks = (int)std::min<int64_t>((n_words + warps_per_block - 1) / warps_per_block, 1 << 16);
  seed_probe_kernel<<<blocks, SP_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
    hi, lo, valid, bitset, out, n_words, nk, (int)prow, bits);
  return static_cast<int>(cudaGetLastError());
}
