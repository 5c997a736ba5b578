// csrc/site_scoring.cu with its launch path named by the caller, for
// tools/bench_scoring: the same kernels and launchers, built into a
// library of the tool's own, so that it can time each path at any shape
// while the port's build chooses the path from the shape alone.
//
//     nvcc <the port's flags> -I graphtyper_tpu_torch/csrc -shared -o paths.so scoring_paths.cu

#include "site_scoring.cu"

// gt_site_scoring with pass 1 on the persistent grid (persistent != 0) or
// one row a lane on as many blocks as that takes, the first n_shared
// entries of the site-level block (at most what a block's shared memory
// holds) in each block's shared memory, and the warp's sums before the
// atomics (group != 0; always with a shared copy).
extern "C" int gt_site_scoring_path(const int32_t* obs, int64_t N, int A, int64_t n_sites, int64_t n_samples,
                                    int64_t* buf, int persistent, int64_t n_shared, int group, void* stream)
{
  if (A < 1 || A > 64 || N < 0 || n_sites < 0 || n_samples < 0 || n_shared < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(A, n_sites, n_samples);
  DeviceInfo dev;
  cudaError_t err = device_info(&dev);
  if (err != cudaSuccess)
    return static_cast<int>(err);
  const Plan plan{persistent != 0, std::min(n_shared, shared_entries(l, dev)), group != 0};
  return static_cast<int>(run(Flush{obs, N, n_samples, l, buf, buf + l.size}, plan, dev,
                              static_cast<cudaStream_t>(stream)));
}
