"""The seed-probe kernel's body (csrc/seed_probe.cu, the code before the end
of its anonymous namespace) compiled for the CPU with g++ and run block by
block as a lockstep emulation: each warp's 32 threads meet at a barrier
around every __shfl_sync and __ballot_sync, and a block's threads at
__syncthreads after the mask table is filled. Two blocks of two warps
stride over the rows. It is held exactly to `probe_bits_plain` on the
synthetic adversarial batches at nk = 2, 4 and 8, and at nk = 40, whose
second chunk of 32 kmers fills words 97 to 121; with the ballot's lane
order reversed it must fail. The kernel itself is held on the card
(tests/test_torch_ops_cuda.py)."""

import pathlib

import numpy as np
import pytest
import torch

from graphtyper_tpu_torch.ops.seed_probe import bitset_bits_for, build_bitset, prow_for, probe_bits_plain
from test_torch_device_align_batches import synthetic_index, synthetic_rows
from test_torch_device_align_emulated import _run, build_body
from test_torch_sw_row_emulated import gxx  # noqa: F401 (fixture)

SOURCE = pathlib.Path(__file__).resolve().parent.parent / "graphtyper_tpu_torch" / "csrc" / "seed_probe.cu"
LANE_ORDER = ("const int b = 32 * w0 + lane;", "const int b = 32 * w0 + (31 - lane);")

HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "cuda_runtime.h"
#include "body.inc"
}  // namespace

int main(int, char** argv)
{
  FILE* f = std::fopen(argv[1], "rb");
  int h[3];  // S, nk, bits
  if (std::fread(h, 4, 3, f) != 3)
    return 1;
  const int S = h[0], nk = h[1], bits = h[2];
  const size_t n = (size_t)S * nk, n_bitset = (size_t)1 << (bits - 5);
  std::vector<uint32_t> hi(n), lo(n), bitset(n_bitset);
  std::vector<uint8_t> valid(n);
  if (std::fread(hi.data(), 4, n, f) + std::fread(lo.data(), 4, n, f) + std::fread(valid.data(), 1, n, f)
      + std::fread(bitset.data(), 4, n_bitset, f) != 3 * n + n_bitset)
    return 1;
  std::fclose(f);
  const int prow = (nk * PROBES + 31) / 32;
  std::vector<uint32_t> out((size_t)S * prow);
  run_grid(2, 64, [&] {
    seed_probe_kernel(hi.data(), lo.data(), valid.data(), bitset.data(), out.data(), S, nk, prow, bits);
  });
  f = std::fopen(argv[2], "wb");
  std::fwrite(out.data(), 4, out.size(), f);
  std::fclose(f);
  return 0;
}
"""


@pytest.fixture(scope="module")
def batch():
    """The synthetic index and its bitset at 14 bits, fewer than a pool's:
    more probes pass, and the emulation reads a small table."""
    idx = synthetic_index(0)
    bits = 14
    assert bits < bitset_bits_for(len(idx["keys"]))  # more probes pass than in a real pool
    return idx, bits, build_bitset(idx["keys"], bits)


def _emulate(exe, rows, bits, bitset):
    hi, lo, valid = rows[:3]
    S, nk = hi.shape
    out = _run(exe, [np.array([S, nk, bits], np.int32), hi, lo, valid, bitset], S * prow_for(nk))
    return out.view(np.uint32).reshape(S, prow_for(nk))


def _plain(rows, bits, bitset):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (*rows[:3], bitset)]
    return probe_bits_plain(*t, bits).numpy()


@pytest.fixture(scope="module")
def emulated(gxx, tmp_path_factory):
    return build_body(tmp_path_factory.mktemp("seed_probe"), SOURCE, HARNESS, "seed_probe_emulated")


@pytest.mark.parametrize("nk", [2, 4, 8, 40])
def test_emulated_kernel_matches_plain(emulated, batch, nk):
    idx, bits, bitset = batch
    rows = synthetic_rows(idx, nk, seed=10 + nk, n=120)
    got = _emulate(emulated, rows, bits, bitset)
    want = _plain(rows, bits, bitset)
    np.testing.assert_array_equal(got, want)
    assert 0 < np.unpackbits(want.view(np.uint8)).mean() < 0.5


def test_flipped_lane_order_fails(gxx, batch, tmp_path):
    idx, bits, bitset = batch
    exe = build_body(tmp_path, SOURCE, HARNESS, "flipped", LANE_ORDER)
    rows = synthetic_rows(idx, 4, seed=14, n=120)
    assert (_emulate(exe, rows, bits, bitset) != _plain(rows, bits, bitset)).any()
