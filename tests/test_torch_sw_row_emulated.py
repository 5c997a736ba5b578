"""The row-scan CUDA kernel's body (csrc/sw_row.cu, the code before its
launcher) compiled for the CPU with g++ and run as a lockstep emulation of
each warp: 32 threads that meet at a barrier around every shuffle. It is
held exactly to `sw_align_plain`, and with any one of its three E-scan tie
sites flipped it must fail the E-tie batch, so the batch can see the rule.
The kernel itself is held on the card (tests/test_torch_sw_cuda.py)."""

import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from graphtyper_tpu_torch.constants import (
    SCORE_CLIP,
    SCORE_GAP_EXTEND,
    SCORE_GAP_OPEN,
    SCORE_MATCH,
    SCORE_MISMATCH,
)
from graphtyper_tpu_torch.ops.sw_rot import sw_align_plain
from test_torch_sw import CASES
from test_torch_sw_batches import e_tie_batch

SOURCE = pathlib.Path(__file__).resolve().parent.parent / "graphtyper_tpu_torch" / "csrc" / "sw_row.cu"
LAUNCHER = "template <int C>\nint launch("

# what the kernel body needs of the CUDA runtime, for one warp at a time
STUB = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cstdint>
#define __global__
#define __device__
#define __forceinline__ inline
#define __shared__
struct dim_ { unsigned x; };
inline thread_local dim_ threadIdx, blockIdx;
inline std::barrier<>* g_bar;
inline int g_slot[32];
inline int exchange(int v, int src)
{
  g_slot[threadIdx.x % 32] = v;
  g_bar->arrive_and_wait();
  const int r = g_slot[src];
  g_bar->arrive_and_wait();
  return r;
}
inline int __shfl_up_sync(unsigned, int v, int off)
{
  const int l = threadIdx.x % 32;
  return exchange(v, l >= off ? l - off : l);
}
inline int __shfl_xor_sync(unsigned, int v, int off) { return exchange(v, (threadIdx.x % 32) ^ off); }
inline void __syncwarp() { g_bar->arrive_and_wait(); }
using std::max;
"""

HARNESS = r"""
#include <cstdio>
#include <thread>
#include <vector>
#include "cuda_runtime.h"
namespace { uint8_t q_smem[1 << 16]; }
#include "body.inc"
}  // namespace

template <int C>
void run(const std::vector<uint8_t>& q, const std::vector<int32_t>& ql, const std::vector<uint8_t>& d,
         const std::vector<int32_t>& dl, std::vector<int32_t>& out, int B, int M, int N, const int* sc)
{
  for (int blk = 0; blk * SW_ROW_WARPS < B; ++blk)
    for (int w = 0; w < SW_ROW_WARPS; ++w)
    {
      std::barrier<> bar(32);
      g_bar = &bar;
      std::vector<std::thread> lanes;
      for (int l = 0; l < 32; ++l)
        lanes.emplace_back([&, blk, w, l] {
          threadIdx.x = w * 32 + l;
          blockIdx.x = blk;
          sw_row_kernel<C>(q.data(), ql.data(), d.data(), dl.data(), out.data(), B, M, N,
                           sc[0], sc[1], sc[2], sc[3], sc[4]);
        });
      for (auto& t : lanes)
        t.join();
    }
}

int main(int, char** argv)
{
  FILE* f = std::fopen(argv[1], "rb");
  int h[8];  // B, M, N, match, mismatch, go, ge, clip
  if (std::fread(h, 4, 8, f) != 8)
    return 1;
  const int B = h[0], M = h[1], N = h[2];
  std::vector<uint8_t> q(B * M), d(B * N);
  std::vector<int32_t> ql(B), dl(B), out(3 * B);
  if (std::fread(q.data(), 1, B * M, f) + std::fread(ql.data(), 4, B, f)
      + std::fread(d.data(), 1, B * N, f) + std::fread(dl.data(), 4, B, f) != size_t(B * M + 2 * B + B * N))
    return 1;
  std::fclose(f);
  if (N <= 32) run<1>(q, ql, d, dl, out, B, M, N, h + 3);
  else if (N <= 64) run<2>(q, ql, d, dl, out, B, M, N, h + 3);
  else if (N <= 128) run<4>(q, ql, d, dl, out, B, M, N, h + 3);
  else if (N <= 256) run<8>(q, ql, d, dl, out, B, M, N, h + 3);
  else run<16>(q, ql, d, dl, out, B, M, N, h + 3);
  f = std::fopen(argv[2], "wb");
  std::fwrite(out.data(), 4, 3 * B, f);
  std::fclose(f);
  return 0;
}
"""

# the E scan's three tie sites, "the later column unless the earlier one is
# strictly greater", each with the opposite rule
TIE_SITES = {
    "in_strip": ("if (c == 0 || t >= tv)", "if (c == 0 || t > tv)"),
    "shuffle": ("if (lane >= off && ov > tv)", "if (lane >= off && ov >= tv)"),
    "fix_up": ("if (t >= rv)", "if (t > rv)"),
}


def _build(directory: pathlib.Path, site: str | None = None) -> pathlib.Path:
    body = SOURCE.read_text().split(LAUNCHER)[0].replace("#include <cuda_runtime.h>", "")
    if site is not None:
        old, new = TIE_SITES[site]
        assert body.count(old) == 1, old
        body = body.replace(old, new)
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "cuda_runtime.h").write_text(STUB)
    (directory / "body.inc").write_text(body)
    (directory / "harness.cpp").write_text(HARNESS)
    exe = directory / "sw_row_emulated"
    subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-I", str(directory),
                    str(directory / "harness.cpp"), "-o", str(exe)], check=True, timeout=300)
    return exe


def _emulate(exe: pathlib.Path, Q, qlens, D, dlens) -> np.ndarray:
    B, M = Q.shape
    head = [B, M, D.shape[1], SCORE_MATCH, SCORE_MISMATCH, SCORE_GAP_OPEN, SCORE_GAP_EXTEND, SCORE_CLIP]
    src, dst = exe.parent / "in.bin", exe.parent / "out.bin"
    with open(src, "wb") as f:
        for a in (np.array(head, np.int32), Q.astype(np.uint8), qlens.astype(np.int32),
                  D.astype(np.uint8), dlens.astype(np.int32)):
            np.ascontiguousarray(a).tofile(f)
    subprocess.run([str(exe), str(src), str(dst)], check=True, timeout=300)
    return np.fromfile(dst, np.int32).reshape(3, B)


def _plain(Q, qlens, D, dlens) -> np.ndarray:
    out = sw_align_plain(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (Q, qlens, D, dlens)))
    return np.stack([o.numpy() for o in out])


@pytest.fixture(scope="module")
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("needs g++")


@pytest.fixture(scope="module")
def emulated(gxx, tmp_path_factory):
    return _build(tmp_path_factory.mktemp("sw_row"))


EXTRA = {  # the E-tie batch at strip widths 1 and 8
    "e_ties_12x32": lambda: e_tie_batch(32, B=16, M=12, N=32),
    "e_ties_40x256": lambda: e_tie_batch(256, B=16, M=40, N=256),
}


@pytest.mark.parametrize("case", sorted(CASES) + sorted(EXTRA))
def test_emulated_kernel_matches_plain(emulated, case):
    args = (CASES.get(case) or EXTRA[case])()
    np.testing.assert_array_equal(_emulate(emulated, *args), _plain(*args))


@pytest.mark.parametrize("site", sorted(TIE_SITES))
def test_e_ties_catch_a_flipped_tie_site(gxx, tmp_path, site):
    args = e_tie_batch(256, B=64, M=40, N=256)
    got = _emulate(_build(tmp_path, site), *args)
    assert (got != _plain(*args)).any(axis=0).sum() > 0
