"""The wavefront CUDA kernel's body (csrc/sw_rot.cu, the code before its
launcher) compiled for the CPU with g++ and run as a lockstep emulation of
each warp: 32 threads that meet at a barrier around every shuffle, with the
stub runtime of tests/test_torch_sw_row_emulated.py. A lane that skipped a
shuffle would deadlock here. The body is held exactly to `sw_align_plain`
at R = 1, 2, 5 and 8 rows a lane, at the main path's batches, on a window
wider than 512 columns and on queries of two bands; with any one of its
tie sites flipped it must fail at least one of those batches. The kernel
itself is held on the card (tests/test_torch_sw_cuda.py)."""

import pathlib
import subprocess

import numpy as np
import pytest

from test_torch_sw import CASES
from test_torch_sw_batches import e_tie_batch, insertion_batch, planted_batch, two_band_batch
from test_torch_sw_row_emulated import STUB, _emulate, _plain, gxx  # noqa: F401 (fixture)

SOURCE = pathlib.Path(__file__).resolve().parent.parent / "graphtyper_tpu_torch" / "csrc" / "sw_rot.cu"
LAUNCHER = "template <int R>\nint launch("

# what the wavefront kernel needs beyond the row kernel's stub
STUB_EXTRA = r"""
using std::min;
template <class T> inline T __ldg(const T* p) { return *p; }
inline void __threadfence_block() {}
"""

HARNESS = r"""
#include <cstdio>
#include <thread>
#include <vector>
#include "cuda_runtime.h"
#include "body.inc"
}  // namespace

template <int R>
void run(const std::vector<uint8_t>& q, const std::vector<int32_t>& ql, const std::vector<uint8_t>& d,
         const std::vector<int32_t>& dl, std::vector<int32_t>& out, std::vector<int32_t>& scratch,
         int B, int M, int N, const int* sc)
{
  for (int blk = 0; blk * SW_ROT_WARPS < B; ++blk)
    for (int w = 0; w < SW_ROT_WARPS; ++w)
    {
      std::barrier<> bar(32);
      g_bar = &bar;
      std::vector<std::thread> lanes;
      for (int l = 0; l < 32; ++l)
        lanes.emplace_back([&, blk, w, l] {
          threadIdx.x = w * 32 + l;
          blockIdx.x = blk;
          sw_rot_kernel<R>(q.data(), ql.data(), d.data(), dl.data(), out.data(), scratch.data(),
                           B, M, N, sc[0], sc[1], sc[2], sc[3], sc[4]);
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
  std::vector<int32_t> ql(B), dl(B), out(3 * B), scratch(M > BAND_ROWS ? 3 * B * N : 0);
  if (std::fread(q.data(), 1, B * M, f) + std::fread(ql.data(), 4, B, f)
      + std::fread(d.data(), 1, B * N, f) + std::fread(dl.data(), 4, B, f) != size_t(B * M + 2 * B + B * N))
    return 1;
  std::fclose(f);
  with_rows(M, [&](auto r) {  // the kernel's own dispatch
    run<decltype(r)::value>(q, ql, d, dl, out, scratch, B, M, N, h + 3);
    return 0;
  });
  f = std::fopen(argv[2], "wb");
  std::fwrite(out.data(), 4, 3 * B, f);
  std::fclose(f);
  return 0;
}
"""

# every tie rule of the kernel, each with the opposite rule
TIE_SITES = {
    "take_fresh": ("const bool take_fresh = Hlt[r] - go >= E[r] - ge;",
                   "const bool take_fresh = Hlt[r] - go > E[r] - ge;"),
    "m_against_f": ("const bool use_m = mc >= fn;", "const bool use_m = mc > fn;"),
    "e_against_h_tmp": ("const bool use_e = en > ht;", "const bool use_e = en >= ht;"),
    "fresh_restart": ("const bool use_fresh = fresh > dH;", "const bool use_fresh = fresh >= dH;"),
    "row_column_tie": ("if (hf > rb[r])", "if (hf >= rb[r])"),
    "clip_end_row_tie": ("rb[r] - clip > bm)", "rb[r] - clip >= bm)"),
    "lane_tie": ("(orow < r || (orow == r && oc < c))", "(orow > r || (orow == r && oc > c))"),
    "full_query_wins": ("const bool use_clip = bm > fv;", "const bool use_clip = bm >= fv;"),
}


def _build(directory: pathlib.Path, site: str | None = None) -> pathlib.Path:
    body = SOURCE.read_text().split(LAUNCHER)[0].replace("#include <cuda_runtime.h>", "")
    if site is not None:
        old, new = TIE_SITES[site]
        assert body.count(old) == 1, old
        body = body.replace(old, new)
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "cuda_runtime.h").write_text(STUB + STUB_EXTRA)
    (directory / "body.inc").write_text(body)
    (directory / "harness.cpp").write_text(HARNESS)
    exe = directory / "sw_rot_emulated"
    subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-I", str(directory),
                    str(directory / "harness.cpp"), "-o", str(exe)], check=True, timeout=300)
    return exe


@pytest.fixture(scope="module")
def emulated(gxx, tmp_path_factory):
    return _build(tmp_path_factory.mktemp("sw_rot"))


BATCHES = {  # rows a lane R = ceil(min(M, 256) / 32)
    "e_ties_R1_24x128": lambda: e_tie_batch(128, B=16, M=24, N=128),
    "e_ties_R2_48x128": lambda: e_tie_batch(129, B=16, M=48, N=128),
    "e_ties_R5_151x256": lambda: e_tie_batch(256, B=16, M=151, N=256),
    "e_ties_R8_250x384": lambda: e_tie_batch(384, B=8, M=250, N=384),
    "main_path_1x151x506": lambda: planted_batch(2025, 1),
    "main_path_6x151x506": lambda: planted_batch(2025, 6),
    "main_path_40x151x506": lambda: planted_batch(2025, 40),
    "insertion_30bp_N576": lambda: insertion_batch(7, 12),
    "two_bands_300x640": lambda: two_band_batch(5, 6),
}


@pytest.mark.parametrize("case", sorted(CASES) + sorted(BATCHES))
def test_emulated_kernel_matches_plain(emulated, case):
    args = (CASES.get(case) or BATCHES[case])()
    np.testing.assert_array_equal(_emulate(emulated, *args), _plain(*args))


# the batches a flipped site is tried on, cheapest first; it must fail one
FLIP_BATCHES = ("adversarial", "random0", "e_ties", "gap_ties", "e_ties_R1_24x128",
                "e_ties_R5_151x256", "main_path_6x151x506", "two_bands_300x640")


@pytest.mark.parametrize("site", sorted(TIE_SITES))
def test_flipped_tie_site_fails_a_batch(gxx, tmp_path, site):
    exe = _build(tmp_path, site)
    for name in FLIP_BATCHES:
        args = (CASES.get(name) or BATCHES[name])()
        if (_emulate(exe, *args) != _plain(*args)).any():
            return
    pytest.fail(f"flipping {site} changed no output on {FLIP_BATCHES}")
