"""The align stage's two kernels against the card's gather rate: the
measured gather ceiling, and the random loads a verdict launch issues.

    python -m graphtyper_tpu_torch.tools.bench_align [--out FILE]

`gather_rate` times csrc/gather.cu: random 4-byte loads from a table of a
given size at full occupancy, in G loads/s; run as a script it prints the
rate for tables from 2 to 64 MB, and its last line is one JSON object with
every reading. `verdict_gathers` counts, from the data, the loads from the
tables that csrc/device_align.cu issues on given rows (the seed probes
issue one load a probe, 97 a valid kmer). chip_smoke.py's "gather" line
uses both on the kernels' own inputs.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import math
import sys
from pathlib import Path

import numpy as np
import torch

from graphtyper_tpu_torch import kernels
from graphtyper_tpu_torch.tools.bench_sw import time_ms

M32 = 0xFFFFFFFF
TAIL_PAD = 32  # csrc/device_align.cu: tail bytes a row
VP, I32 = ctypes.c_void_p, ctypes.c_int


def _i32(x: np.ndarray) -> np.ndarray:
    return ((x.astype(np.int64) & M32) ^ 0x80000000) - 0x80000000


@functools.cache
def _gather_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(kernels.build_shared("gt_gather", [kernels.CSRC / "gather.cu"], [kernels.find_nvcc()],
                                               list(kernels.NVCC_FLAGS))))
    lib.gt_gather.restype = I32
    lib.gt_gather.argtypes = [VP, I32, I32, I32, VP, VP]
    lib.gt_gather_threads.restype = I32
    lib.gt_gather_ilp.restype = I32
    return lib


def gather_rate(table_bytes: int, dev: torch.device) -> dict:
    """G loads/s of random 4-byte loads from a table of at least
    `table_bytes` (the next power of two), every SM full of threads."""
    lib = _gather_lib()
    log2 = max(1, math.ceil(math.log2(max(table_bytes, 8) / 4)))
    table = torch.randint(0, 1 << 30, (1 << log2,), dtype=torch.int32, device=dev)
    threads = lib.gt_gather_threads()
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count * (2048 // threads)
    rounds = 64
    out = torch.empty(blocks * threads, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run():
        rc = lib.gt_gather(table.data_ptr(), log2, blocks, rounds, out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"gather kernel launch failed: cudaGetLastError() = {rc}")

    ms, _ = time_ms(run)
    loads = blocks * threads * lib.gt_gather_ilp() * rounds
    return dict(table_bytes=4 << log2, loads=loads, ms=ms, gloads_per_s=loads / ms / 1e6)


def verdict_gathers(dal, rows, verdicts: np.ndarray, S: int) -> int:
    """The loads from the tables (every `__ldg` of csrc/device_align.cu) that
    one launch issues on `rows` padded to S rows, counted from the data.
    Per row, each kmer it searches (max(nk_r, 1) of them): its 2 bucket
    bounds, key_steps halvings, its key record and its first label, then
    one load a further label (up to 6). Per row with a tail: ref_steps
    levels of the reference search, the node record, and the arena's
    16-byte chunks under the tail, or, when the tail reaches past either
    end of the arena, one load a byte. `dal` is the DeviceAligner, rows
    (hi, lo, valid, tails, lens) the unpadded rows and `verdicts` their
    [>= n, 9] output. The rows' own loads (keys, tails, lengths) are not
    counted. tests/test_torch_device_align_emulated.py holds this count to
    the kernel body's own, load for load."""
    hi, lo, valid, tails, lens = rows
    n, nk = hi.shape
    keys_hi, keys_lo, offsets, *_, ref_order, ref_len, ref_start, arena = (t.cpu().numpy() for t in dal.tables)
    keys = (keys_hi.astype(np.uint64) << np.uint64(32)) | keys_lo
    offsets = offsets.astype(np.int64)

    def labels(qh, ql):
        q = (qh.astype(np.uint64) << np.uint64(32)) | ql
        pos = np.searchsorted(keys, q)
        posc = np.minimum(pos, len(keys) - 1)
        size = np.where((pos < len(keys)) & (keys[posc] == q), offsets[posc + 1] - offsets[posc], 0)
        return np.minimum(size, 6)

    lens = lens.astype(np.int64)
    nk_r = np.minimum(np.where(lens >= 32, 1 + (lens - 32) // 31, 0), nk)
    searched = np.arange(nk)[None, :] < np.maximum(nk_r, 1)[:, None]
    n_lab = labels(hi, lo) * searched
    pad_lab = int(labels(np.zeros(1, np.uint32), np.zeros(1, np.uint32))[0])  # padded rows: key 0, length 0
    kmers = int(searched.sum()) + (S - n)
    loads = kmers * (dal.key_steps + 4) + int(np.maximum(n_lab - 1, 0).sum()) + (S - n) * max(pad_lab - 1, 0)

    tail = np.maximum(lens - 1 - 31 * nk_r, 0)
    has_tail = tail > 0
    chain_end = ((verdicts[:n, 2].astype(np.int64) & M32) - tail) & M32
    r = np.searchsorted(ref_order.astype(np.int64), (chain_end + 1) & M32, side="left") - 1
    rc = np.clip(r, 0, len(ref_order) - 1)
    first = _i32(ref_start[rc].astype(np.int64) + _i32(chain_end - ref_order[rc]) + 1)
    inside = (first >= 0) & (first + tail <= dal.n_arena)
    skip = first & 15
    chunks = np.where(inside, 1 + (skip + tail > 16) + (skip + tail > 32), np.minimum(tail, TAIL_PAD))
    return loads + int(has_tail.sum()) * (dal.ref_steps + 1) + int(chunks[has_tail].sum())


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m graphtyper_tpu_torch.tools.bench_align",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON result to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_align times a kernel on the card; torch.cuda.is_available() is False")
    dev = torch.device("cuda")
    ceiling = {mb: gather_rate(mb << 20, dev) for mb in (2, 4, 8, 16, 32, 64)}
    print(f"gather ({torch.cuda.get_device_name(dev)}): random 4-byte loads, G/s by table size: "
          + ", ".join(f"{mb} MB {g['gloads_per_s']:.1f}" for mb, g in ceiling.items()), flush=True)
    line = json.dumps(dict(device=torch.cuda.get_device_name(dev), gather=ceiling))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
