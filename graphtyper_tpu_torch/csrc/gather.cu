// A reading, not a kernel of the port: the card's rate of random 4-byte
// loads from a table that stays in the L2, the work that bounds the seed
// probes (csrc/seed_probe.cu) and the verdicts' searches
// (csrc/device_align.cu). Every thread walks GATHER_ILP independent
// sequences of table indices (a linear congruential generator each, its top
// bits the index) and issues their GATHER_ILP loads before it uses any, so
// the card holds as many loads in flight as it can; the xor of what a
// thread loaded is stored once, so no load is dead. Built and timed by
// graphtyper_tpu_torch/tools/bench_align.py gather_rate.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int GATHER_THREADS = 256;
constexpr int GATHER_ILP = 8;

__global__ void __launch_bounds__(GATHER_THREADS)
gather_kernel(const uint32_t* __restrict__ table, int log2_words, int rounds, uint32_t* __restrict__ out)
{
  const uint32_t tid = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t x[GATHER_ILP];
#pragma unroll
  for (int i = 0; i < GATHER_ILP; ++i)
    x[i] = (tid * GATHER_ILP + i) * 0x9E3779B1u + 0x7F4A7C15u;
  uint32_t acc = 0;
  for (int r = 0; r < rounds; ++r)
  {
    uint32_t v[GATHER_ILP];
#pragma unroll
    for (int i = 0; i < GATHER_ILP; ++i)
    {
      x[i] = x[i] * 1664525u + 1013904223u;
      v[i] = __ldg(table + (x[i] >> (32 - log2_words)));
    }
#pragma unroll
    for (int i = 0; i < GATHER_ILP; ++i)
      acc ^= v[i];
  }
  out[tid] = acc;
}

}  // namespace

// table of 2^log2_words uint32 words (1 <= log2_words <= 31); out [blocks *
// gather_threads()] uint32. Each thread loads GATHER_ILP * rounds words.
// Launches on `stream`; returns cudaGetLastError() of the launch.
extern "C" int gt_gather(const uint32_t* table, int log2_words, int blocks, int rounds, uint32_t* out,
                         void* stream)
{
  if (log2_words < 1 || log2_words > 31 || blocks <= 0 || rounds <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  gather_kernel<<<blocks, GATHER_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(table, log2_words,
                                                                                  rounds, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gt_gather_threads() { return GATHER_THREADS; }
extern "C" int gt_gather_ilp() { return GATHER_ILP; }
