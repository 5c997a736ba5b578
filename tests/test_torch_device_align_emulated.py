"""The verdict kernel's body (csrc/device_align.cu, the code before the end
of its anonymous namespace) compiled for the CPU with g++ against a stub
CUDA runtime and run in one thread over every row, held exactly to
`verdicts_plain` on the synthetic adversarial batches at nk = 2, 4 and 8.
Two rules are flipped in a temporary copy, and each flip must show:
  * the `mid < hi` guard of the lower_bound. Past convergence it only moves
    an index that is already past the table's end further out, which the
    clamps then map to the same entry, so no verdict row can see it; the
    check holds the kernel's search itself to the JAX package's
    `_lower_bound_u64` on the batch's keys and chain ends, where the flip
    must change an index;
  * the -1 of an empty payload slot, which must change the verdict rows.
The kernel itself is held on the card (tests/test_torch_ops_cuda.py)."""

import pathlib
import subprocess
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphtyper_tpu.ops import device_align as ref_device_align
from graphtyper_tpu_torch.ops import device_align
from graphtyper_tpu_torch.ops.device_align import DeviceAligner, verdicts_plain
from test_torch_device_align_batches import synthetic_index, synthetic_rows
from test_torch_sw_row_emulated import STUB, gxx  # noqa: F401 (fixture)

SOURCE = pathlib.Path(__file__).resolve().parent.parent / "graphtyper_tpu_torch" / "csrc" / "device_align.cu"
BODY_END = "}  // namespace\n"

# what the kernel bodies need beyond the row kernel's stub
STUB_EXTRA = r"""
using std::min;
#define __launch_bounds__(...)
#define __restrict__
inline dim_ blockDim{1}, gridDim{1};
struct uint4 { unsigned x, y, z, w; };
template <class T> inline T __ldg(const T* p) { return *p; }
inline unsigned __ballot_sync(unsigned, bool pred)
{
  g_slot[threadIdx.x % 32] = pred ? 1 : 0;
  g_bar->arrive_and_wait();
  unsigned m = 0;
  for (int i = 0; i < 32; ++i)
    m |= unsigned(g_slot[i] != 0) << i;
  g_bar->arrive_and_wait();
  return m;
}
"""

HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "cuda_runtime.h"
#include "body.inc"
}  // namespace

template <class T> std::vector<T> rd(FILE* f, size_t n)
{
  std::vector<T> v(n);
  if (n && std::fread(v.data(), sizeof(T), n, f) != n)
    std::exit(1);
  return v;
}

int main(int, char** argv)
{
  FILE* f = std::fopen(argv[1], "rb");
  int h[9];  // S, nk, n_keys, n_labels, n_ref, n_arena, key_steps, ref_steps, mode
  if (std::fread(h, 4, 9, f) != 9)
    return 1;
  const int S = h[0], nk = h[1];
  auto keys_hi = rd<uint32_t>(f, h[2]), keys_lo = rd<uint32_t>(f, h[2]);
  auto offsets = rd<int32_t>(f, h[2] + 1);
  auto lab_start = rd<uint32_t>(f, h[3]), lab_end = rd<uint32_t>(f, h[3]);
  auto lab_var = rd<int32_t>(f, h[3]);
  auto bucket = rd<int32_t>(f, (1 << BUCKET_BITS) + 1);
  auto ref_order = rd<uint32_t>(f, h[4]);
  auto ref_len = rd<int32_t>(f, h[4]), ref_start = rd<int32_t>(f, h[4]);
  auto arena = rd<uint8_t>(f, h[5]);
  const Tables t{keys_hi.data(), keys_lo.data(), offsets.data(), lab_start.data(), lab_end.data(),
                 lab_var.data(), bucket.data(), ref_order.data(), ref_len.data(), ref_start.data(),
                 arena.data(), h[2], h[3], h[4], h[5], h[6], h[7]};
  std::vector<int32_t> out;
  if (h[8] == 0)  // the kernel over S rows
  {
    auto hi = rd<uint32_t>(f, (size_t)S * nk), lo = rd<uint32_t>(f, (size_t)S * nk);
    auto valid = rd<uint8_t>(f, (size_t)S * nk);
    auto tails = rd<uint8_t>(f, (size_t)S * TAIL_PAD);
    auto lens = rd<int32_t>(f, S);
    out.resize((size_t)S * OUT_COLS);
    device_align_kernel(hi.data(), lo.data(), valid.data(), tails.data(), lens.data(), t,
                        out.data(), S, nk);
  }
  else  // its two searches on S queries: the key's in its bucket, and chain_end + 1's
  {
    auto qh = rd<uint32_t>(f, S), ql = rd<uint32_t>(f, S), qe = rd<uint32_t>(f, S);
    for (int i = 0; i < S; ++i)
    {
      const int b = (int)(qh[i] >> (32 - BUCKET_BITS));
      out.push_back(lower_bound_u64(qh[i], ql[i], t.keys_hi, t.keys_lo, t.n_keys, t.key_steps,
                                    t.bucket[b], t.bucket[b + 1]));
      out.push_back(lower_bound_u64(0u, qe[i], nullptr, t.ref_order, t.n_ref, t.ref_steps, 0,
                                    t.n_ref));
    }
  }
  std::fclose(f);
  f = std::fopen(argv[2], "wb");
  std::fwrite(out.data(), 4, out.size(), f);
  std::fclose(f);
  return 0;
}
"""

RULES = {
    "mid_lt_hi_guard": ("less && mid < hi ? mid + 1 : lo", "less ? mid + 1 : lo"),
    "empty_slot": ("slot[j] = -1;", "slot[j] = 0;"),
}


def build_body(directory: pathlib.Path, source: pathlib.Path, harness: str, name: str,
               rule: tuple[str, str] | None = None) -> pathlib.Path:
    """Compile `source` up to the end of its anonymous namespace with
    `harness` against the stub runtime; `rule` = (old, new) is replaced in
    the body first and must occur once."""
    body = source.read_text().split(BODY_END)[0].replace("#include <cuda_runtime.h>", "")
    if rule is not None:
        old, new = rule
        assert body.count(old) == 1, old
        body = body.replace(old, new)
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "cuda_runtime.h").write_text(STUB + STUB_EXTRA)
    (directory / "body.inc").write_text(body)
    (directory / "harness.cpp").write_text(harness)
    exe = directory / name
    subprocess.run(["g++", "-std=c++20", "-O1", "-fno-strict-aliasing", "-pthread", "-I",
                    str(directory), str(directory / "harness.cpp"), "-o", str(exe)],
                   check=True, timeout=300)
    return exe


def _run(exe: pathlib.Path, arrays, n_out: int) -> np.ndarray:
    src, dst = exe.parent / "in.bin", exe.parent / "out.bin"
    with open(src, "wb") as f:
        for a in arrays:
            np.ascontiguousarray(a).tofile(f)
    subprocess.run([str(exe), str(src), str(dst)], check=True, timeout=300)
    out = np.fromfile(dst, np.int32)
    assert out.size == n_out
    return out


@pytest.fixture(scope="module")
def index():
    idx = synthetic_index(0)
    dal = DeviceAligner(types.SimpleNamespace(**idx), "cpu")
    return idx, dal


def _header(dal, S, nk, mode):
    t = dal.tables
    return np.array([S, nk, dal.n_keys, t[3].shape[0], dal.n_ref, t[-1].shape[0], dal.key_steps,
                     dal.ref_steps, mode], np.int32)


def _tables(dal):
    return [t.numpy() for t in dal.tables]


def _emulate_verdicts(exe, dal, rows):
    hi, lo, valid, tails, lens = rows
    S, nk = hi.shape
    out = _run(exe, [_header(dal, S, nk, 0), *_tables(dal), hi, lo, valid, tails, lens],
               S * device_align.OUT_COLS)
    return out.reshape(S, device_align.OUT_COLS)


def _plain(dal, rows):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in rows]
    return verdicts_plain(*t, *dal.tables, key_steps=dal.key_steps, ref_steps=dal.ref_steps).numpy()


@pytest.fixture(scope="module")
def emulated(gxx, tmp_path_factory):
    return build_body(tmp_path_factory.mktemp("device_align"), SOURCE, HARNESS, "device_align_emulated")


@pytest.mark.parametrize("nk", [2, 4, 8])
def test_emulated_kernel_matches_plain(emulated, index, nk):
    idx, dal = index
    rows = synthetic_rows(idx, nk, seed=nk)
    got = _emulate_verdicts(emulated, dal, rows)
    np.testing.assert_array_equal(got, _plain(dal, rows))
    assert (got[:, 0] & 1).sum() > 0  # some rows are clean


def _search_queries(idx, dal):
    """The batch's kmer keys and the chain ends + 1 of its labels (uint32),
    paired up to one length."""
    hi, lo, *_ = synthetic_rows(idx, 4, seed=4)
    qh, ql = hi.reshape(-1), lo.reshape(-1)
    ends = (dal.tables[4].numpy().astype(np.uint64) + 1).astype(np.uint32)
    qe = np.resize(ends, qh.shape[0])
    return qh, ql, qe


def _reference_search(dal, qh, ql, qe):
    """graphtyper_tpu/ops/device_align.py _lower_bound_u64, as its verdicts
    call it."""
    kh, kl, bucket, ref_order = (jnp.asarray(dal.tables[i].numpy()) for i in (0, 1, 6, 7))
    b = jnp.asarray(qh >> np.uint32(32 - device_align.BUCKET_BITS)).astype(jnp.int32)
    pos = ref_device_align._lower_bound_u64(jnp.asarray(qh), jnp.asarray(ql), kh, kl, dal.key_steps,
                                            bounds=(bucket[b], bucket[b + 1]))
    r = ref_device_align._lower_bound_u64(jnp.zeros(qe.shape, jnp.uint32), jnp.asarray(qe),
                                          jnp.zeros_like(ref_order), ref_order, dal.ref_steps)
    return np.stack([np.asarray(pos), np.asarray(r)], axis=1).reshape(-1)


def test_emulated_searches_match_reference(emulated, index):
    idx, dal = index
    qh, ql, qe = _search_queries(idx, dal)
    got = _run(emulated, [_header(dal, len(qh), 4, 1), *_tables(dal), qh, ql, qe], 2 * len(qh))
    np.testing.assert_array_equal(got, _reference_search(dal, qh, ql, qe))


def test_flipped_guard_changes_a_search(gxx, index, tmp_path):
    idx, dal = index
    exe = build_body(tmp_path, SOURCE, HARNESS, "flipped", RULES["mid_lt_hi_guard"])
    qh, ql, qe = _search_queries(idx, dal)
    got = _run(exe, [_header(dal, len(qh), 4, 1), *_tables(dal), qh, ql, qe], 2 * len(qh))
    assert (got != _reference_search(dal, qh, ql, qe)).any()


def test_flipped_empty_slot_changes_the_verdicts(gxx, index, tmp_path):
    idx, dal = index
    exe = build_body(tmp_path, SOURCE, HARNESS, "flipped", RULES["empty_slot"])
    rows = synthetic_rows(idx, 4, seed=4)
    assert (_emulate_verdicts(exe, dal, rows) != _plain(dal, rows)).any()
