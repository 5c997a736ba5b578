"""Device seeding: the 97-probe exact + Hamming-1 k-mer expansion and its
membership filter, one pass over every read-orientation row.

Port of graphtyper_tpu/ops/seed_probe.py. Each row carries nk exact 32-mer
keys as (hi, lo) uint32 halves and a validity flag (the engine's
gt_prep_fetch_kmers). Every key expands into 97 probes (the key, then each
of its 32 two-bit positions xor 1, 2 and 3), each probe is hashed into a
2^bits membership bitset of the index keys, and the pass/fail bits are
packed into uint32 words, bit kpos * 97 + j of a row for probe j of kmer
kpos (native/gt_align.cpp CandView). The host verifies the set bits
exactly, so the words only prune: the bitset has no false negatives.

`probe_bits` is the wrapper: a CPU tensor runs `probe_bits_plain`, the
plain PyTorch version; a CUDA tensor launches csrc/seed_probe.cu (one warp
per output word, the bits joined by a ballot), or the call raises.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from graphtyper_tpu_torch import counters, kernels

K = 32
PROBES_PER_KMER = 97  # 1 exact + 32 positions x 3 deltas
HASH_C1 = 0x9E3779B1  # must match native/gt_align.cpp gt_build_seed_bitset
HASH_C2 = 0x85EBCA77
M32 = 0xFFFFFFFF


@lru_cache(maxsize=1)
def _ham_masks() -> tuple[np.ndarray, np.ndarray]:
    """XOR masks per probe j (hi, lo uint32 halves); j=0 exact,
    j = 1 + kpos*3 + (d-1) flips 2-bit position kpos (shift ascending) by d
    — the same probe order the host seeding loop uses."""
    hi = np.zeros(PROBES_PER_KMER, np.uint32)
    lo = np.zeros(PROBES_PER_KMER, np.uint32)
    j = 1
    for kpos in range(K):
        for d in (1, 2, 3):
            m = d << (2 * kpos)
            hi[j] = (m >> 32) & M32
            lo[j] = m & M32
            j += 1
    return hi, lo


def bitset_bits_for(n_keys: int) -> int:
    """Bitset sized so the false-positive rate stays ~1-2%."""
    bits = 24
    while (1 << bits) < 64 * max(1, n_keys) and bits < 28:
        bits += 1
    return bits


def build_bitset(keys_u64: np.ndarray, bits: int) -> np.ndarray:
    """Host-side bitset build (numpy twin of gt_build_seed_bitset)."""
    lo = (keys_u64 & np.uint64(M32)).astype(np.uint32)
    hi = (keys_u64 >> np.uint64(32)).astype(np.uint32)
    h = (lo * np.uint32(HASH_C1) + hi * np.uint32(HASH_C2)) >> np.uint32(32 - bits)
    words = np.zeros(1 << (bits - 5), np.uint32)
    np.bitwise_or.at(words, h >> np.uint32(5), np.uint32(1) << (h & np.uint32(31)))
    return words


def prow_for(nk: int) -> int:
    return (nk * PROBES_PER_KMER + 31) // 32


def probe_bits_plain(hi: torch.Tensor, lo: torch.Tensor, valid: torch.Tensor,
                     bitset: torch.Tensor, bits: int) -> torch.Tensor:
    """graphtyper_tpu/ops/seed_probe.py:92 _probe_bits_impl in torch, on
    int64 with explicit 32-bit wrap-around. hi/lo [S, nk] uint32, valid
    [S, nk] uint8 (0 or 1, as the engine writes it), bitset uint32 words.
    Returns [S, prow_for(nk)] uint32 on the inputs' device."""
    S, nk = hi.shape
    dev = hi.device
    mask_hi, mask_lo = (torch.from_numpy(m.astype(np.int64)).to(dev) for m in _ham_masks())
    p_hi = hi.to(torch.int64)[:, :, None] ^ mask_hi  # [S, nk, 97]
    p_lo = lo.to(torch.int64)[:, :, None] ^ mask_lo
    h = (p_lo * HASH_C1 + p_hi * HASH_C2) & M32
    idx = h >> (32 - bits)
    words = bitset.to(torch.int64)
    bit = (words[idx >> 5] >> (idx & 31)) & 1
    bit = bit * (valid != 0).to(torch.int64)[:, :, None]

    prow = prow_for(nk)
    flat = torch.zeros((S, prow * 32), dtype=torch.int64, device=dev)
    flat[:, : nk * PROBES_PER_KMER] = bit.reshape(S, nk * PROBES_PER_KMER)
    weights = torch.ones(32, dtype=torch.int64, device=dev) << torch.arange(32, device=dev)
    return (flat.reshape(S, prow, 32) * weights).sum(-1).to(torch.uint32)


def probe_bits(hi: torch.Tensor, lo: torch.Tensor, valid: torch.Tensor,
               bitset: torch.Tensor, bits: int) -> torch.Tensor:
    """Candidate words [S, prow_for(nk)] uint32 on the inputs' device. CPU
    tensors run `probe_bits_plain`; CUDA tensors go to csrc/seed_probe.cu,
    which is built at first use, or the call raises."""
    if hi.device.type == "cpu":
        counters.add("seed_probe_plain")
        return probe_bits_plain(hi, lo, valid, bitset, bits)
    dev = hi.device
    lib = kernels.load()
    kernels.check_cuda("probe_bits", dev, (
        ("hi", hi, torch.uint32, 2), ("lo", lo, torch.uint32, 2),
        ("valid", valid, torch.uint8, 2), ("bitset", bitset, torch.uint32, 1),
    ))
    S, nk = hi.shape
    if lo.shape != hi.shape or valid.shape != hi.shape:
        raise ValueError(f"probe_bits: hi {tuple(hi.shape)}, lo {tuple(lo.shape)} and valid "
                         f"{tuple(valid.shape)} differ")
    if not 5 < bits <= 32 or bitset.shape[0] != 1 << (bits - 5):
        raise ValueError(f"probe_bits: a bitset of {bits} bits has 2^{bits - 5} words, "
                         f"got {bitset.shape[0]}")
    prow = prow_for(nk)
    if S * prow >= 2**30:
        raise ValueError("probe_bits: S * prow must be below 2^30")
    with torch.cuda.device(dev):
        out = torch.empty((S, prow), dtype=torch.uint32, device=dev)
        rc = lib.gt_seed_probe(
            hi.data_ptr(), lo.data_ptr(), valid.data_ptr(), bitset.data_ptr(), out.data_ptr(),
            S, nk, bits, torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"seed_probe kernel launch failed: cudaGetLastError() = {rc}")
    counters.add("seed_probe")
    return out


def _upload_rows(a: np.ndarray, S: int, fill: int, device: torch.device) -> torch.Tensor:
    """`a` [n, ...] padded to S rows with `fill`, as a tensor on `device`.
    A CUDA copy goes through pinned memory without blocking the host;
    PyTorch's pinned-memory allocator keeps the staging block alive until
    the copy on the current stream has finished."""
    cuda = device.type == "cuda"
    src = torch.from_numpy(np.ascontiguousarray(a))
    staged = torch.full((S, *a.shape[1:]), fill, dtype=src.dtype, pin_memory=cuda)
    staged[: a.shape[0]] = src
    return staged.to(device, non_blocking=True) if cuda else staged


def padded_rows(n_rows: int) -> int:
    """Rows after padding: a power of two of at least 1024, so a pool's
    batches share a few shapes (graphtyper_tpu/ops/seed_probe.py:192)."""
    return 1 << max(10, (n_rows - 1).bit_length()) if n_rows else 1024


def stage_kmers(hi: np.ndarray, lo: np.ndarray, valid: np.ndarray, device: torch.device | str):
    """Upload the per-row kmer matrices once, row-padded with zeros; the
    caller keeps the returned (hi, lo, valid) tensors across call
    iterations."""
    device = torch.device(device)
    S = padded_rows(hi.shape[0])
    return (
        _upload_rows(hi.astype(np.uint32, copy=False), S, 0, device),
        _upload_rows(lo.astype(np.uint32, copy=False), S, 0, device),
        _upload_rows(valid.astype(np.uint8, copy=False), S, 0, device),
    )


class DeviceSeeder:
    """Per-index seeding state: the membership bitset lives on `device` for
    the lifetime of one call iteration's index."""

    def __init__(self, keys_u64: np.ndarray, device: torch.device | str, bits: int | None = None):
        import ctypes

        from graphtyper_tpu_torch.io.native import get_lib

        self.device = torch.device(device)
        self.bits = bits if bits is not None else bitset_bits_for(len(keys_u64))
        lib = get_lib()
        lib.gt_build_seed_bitset.restype = None
        lib.gt_build_seed_bitset.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32,
        ]
        keys = np.ascontiguousarray(keys_u64, dtype=np.uint64)
        words = np.empty(1 << (self.bits - 5), np.uint32)  # the engine zeroes it
        lib.gt_build_seed_bitset(
            keys.ctypes.data_as(ctypes.c_void_p), len(keys),
            words.ctypes.data_as(ctypes.c_void_p), self.bits,
        )
        self.bitset = torch.from_numpy(words).to(self.device)

    def probe_bits(self, kmers, n_rows: int, nk: int) -> np.ndarray:
        """kmers = (hi, lo, valid) [S, nk] tensors on this seeder's device
        (S row-padded); returns candidate words [n_rows, PROW] uint32 on the
        host."""
        hi, lo, valid = kmers
        if hi.shape[1] != nk:
            raise ValueError(f"probe_bits: nk {nk} but the kmer matrix has {hi.shape[1]} columns")
        packed = probe_bits(hi, lo, valid, self.bitset, self.bits)
        return packed[:n_rows].cpu().numpy()
