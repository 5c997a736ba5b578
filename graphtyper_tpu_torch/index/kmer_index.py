"""Device-friendly k-mer index: sorted kmer keys + CSR label spans.

Replaces the reference's phmap hash table (ph_index.hpp) with a layout XLA
can gather from: lookup is a binary search (`searchsorted`) over the sorted
key array; Hamming-1 probing expands each query key into 96 mutated keys
(kmer_help_functions.cpp:93-119) and batches the search.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from graphtyper_tpu_torch.constants import INVALID_ID, K


@dataclass
class KmerIndex:
    keys: np.ndarray  # [U] uint64 sorted unique kmers
    offsets: np.ndarray  # [U+1] int64 label spans
    label_start: np.ndarray  # [L] int64 (may be special positions)
    label_end: np.ndarray  # [L] int64
    label_var_id: np.ndarray  # [L] int64 (INVALID_ID if none)

    @classmethod
    def build(cls, kmers: np.ndarray, starts: np.ndarray, ends: np.ndarray, var_ids: np.ndarray) -> "KmerIndex":
        order = np.argsort(kmers, kind="stable")  # stable: preserve emission order per key
        kmers = kmers[order]
        # run boundaries on the sorted array (np.unique would sort again)
        if len(kmers):
            new_run = np.empty(len(kmers), dtype=bool)
            new_run[0] = True
            np.not_equal(kmers[1:], kmers[:-1], out=new_run[1:])
            keys = kmers[new_run]
            first_idx = np.nonzero(new_run)[0]
            offsets = np.empty(len(keys) + 1, dtype=np.int64)
            offsets[:-1] = first_idx
            offsets[-1] = len(kmers)
        else:
            keys = kmers
            offsets = np.zeros(1, dtype=np.int64)
        return cls(
            keys=keys,
            offsets=offsets,
            label_start=starts[order],
            label_end=ends[order],
            label_var_id=var_ids[order],
        )

    def __len__(self) -> int:
        return len(self.keys)

    @property
    def num_labels(self) -> int:
        return len(self.label_start)

    def get(self, kmer: int) -> list[tuple[int, int, int]]:
        """Labels (start, end, var_id) for an exact kmer (ph_index get)."""
        i = np.searchsorted(self.keys, np.uint64(kmer))
        if i >= len(self.keys) or self.keys[i] != np.uint64(kmer):
            return []
        a, b = int(self.offsets[i]), int(self.offsets[i + 1])
        return [
            (int(self.label_start[j]), int(self.label_end[j]), int(self.label_var_id[j]))
            for j in range(a, b)
        ]

    def multi_get(self, kmers: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized lookup. Returns (span_begin[Q], span_end[Q]) into the
        label arrays; misses yield empty spans."""
        kmers = kmers.astype(np.uint64)
        idx = np.searchsorted(self.keys, kmers)
        idx_c = np.minimum(idx, len(self.keys) - 1) if len(self.keys) else np.zeros_like(idx)
        hit = np.zeros(len(kmers), dtype=bool)
        if len(self.keys):
            hit = self.keys[idx_c] == kmers
        begin = np.where(hit, self.offsets[idx_c], 0)
        end = np.where(hit, self.offsets[np.minimum(idx_c + 1, len(self.offsets) - 1)], 0)
        return begin, end

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            keys=self.keys,
            offsets=self.offsets,
            label_start=self.label_start,
            label_end=self.label_end,
            label_var_id=self.label_var_id,
        )

    @classmethod
    def load(cls, path: str) -> "KmerIndex":
        z = np.load(path)
        return cls(z["keys"], z["offsets"], z["label_start"], z["label_end"], z["label_var_id"])


def hamming1_keys(kmers: np.ndarray) -> np.ndarray:
    """All 96 Hamming-distance-1 mutations of each packed kmer
    (kmer_help_functions.cpp query_index_hamming_distance1_without_index).

    Returns [Q, 96] uint64 (the original key is NOT included).
    """
    kmers = kmers.astype(np.uint64)[:, None]  # [Q, 1]
    shifts = np.arange(K, dtype=np.uint64) * np.uint64(2)  # per position
    cur = (kmers >> shifts[None, :]) & np.uint64(3)  # [Q, K] current base codes
    deltas = np.arange(1, 4, dtype=np.uint64)  # xor alternatives 1..3
    mutated = cur[:, :, None] ^ deltas[None, None, :]  # [Q, K, 3]
    cleared = kmers[:, :, None] & ~(np.uint64(3) << shifts[None, :, None])
    out = cleared | (mutated << shifts[None, :, None])
    return out.reshape(len(kmers), K * 3)
