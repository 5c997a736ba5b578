"""Rep-sharded distributed alignment: hosts split the cohort's align work.

Port of graphtyper_tpu/parallel/rep_shard.py. Sample-sharded cohort calling
(parallel/distributed.py genotype_distributed) leaves each host aligning its
own shard's deduplicated (pos, seq) representatives, and since the cohort's
rep space is largely shared across sample shards, the align stage does not
divide as hosts are added. This module divides it. The align work unit is
the oriented rep sequence (a prepared pool's row): find_genotype_paths is a
pure function of its bytes against the replicated graph and index, so a
row's result is the same on every host. Per call iteration:

1. every host collects the distinct row sequences across its pools
   (gt_prep_fetch_seqs; the prep is cached, so the later call_pool reuses
   the same dedup and rows) and digests each (blake2b-128, the global
   identity of an align work unit);
2. digests partition by their first 8 bytes mod n_hosts; each host aligns
   the owned sequences it holds (NativeAligner.align_rows_raw, the
   serialized-Geno layout of gt_align_fetch); no sequence crosses the wire;
3. one allgather ships (digests, table) pairs, which become a RepOracle;
4. gt_call_finish imports the resolved rows (ExtView in native/gt_align.cpp)
   and skips find_genotype_paths for them; rows nobody aligned fall back to
   the local walk.

The imported Geno is the exact serialization round trip of what the host's
own walk would give, so the VCF is byte-identical.

`local_row_seqs` takes each pool's prepared entry from the port's pinned
cache (pipeline/native_caller.py `_get_prep`) and releases it when it has
read the rows, so the exchange never holds a PrepPool past its use.
"""

from __future__ import annotations

import pickle

import numpy as np

PAD = 15  # prep row padding code (gt_prep_fetch_seqs memsets 15)

EXT_KEYS = (
    "longest", "poff", "p_start", "p_end", "p_rsi", "p_rei", "p_mm",
    "soff", "s_vorder", "noff", "nums",
)


def _as_void(mat: np.ndarray) -> np.ndarray:
    """[N, L] uint8 -> [N] void view for vectorized bytewise sort/unique
    (rows pad with 15, which no real base code uses, so equal bytes ==
    equal (seq, len))."""
    mat = np.ascontiguousarray(mat)
    return mat.view([("v", np.void, mat.shape[1])])["v"].reshape(-1)


def _pad_to(mat: np.ndarray, width: int) -> np.ndarray:
    if mat.shape[1] == width:
        return mat
    out = np.full((mat.shape[0], width), PAD, dtype=np.uint8)
    out[:, : mat.shape[1]] = mat
    return out


def _concat_tables(tables: list[dict]) -> dict:
    """Concatenate per-host serialized Geno tables, rebasing the offset
    arrays (poff -> path base, soff -> site base, noff -> num base)."""
    out = {k: [] for k in EXT_KEYS}
    p_base = s_base = n_base = 0
    n_genos = 0
    for t in tables:
        out["longest"].append(t["longest"])
        out["poff"].append(t["poff"][1:] + p_base)
        out["p_start"].append(t["p_start"])
        out["p_end"].append(t["p_end"])
        out["p_rsi"].append(t["p_rsi"])
        out["p_rei"].append(t["p_rei"])
        out["p_mm"].append(t["p_mm"])
        out["soff"].append(t["soff"][1:] + s_base)
        out["s_vorder"].append(t["s_vorder"])
        out["noff"].append(t["noff"][1:] + n_base)
        out["nums"].append(t["nums"])
        n_genos += len(t["longest"])
        p_base += len(t["p_start"])
        s_base += len(t["s_vorder"])
        n_base += len(t["nums"])
    merged = {}
    merged["longest"] = (
        np.concatenate(out["longest"]) if n_genos else np.zeros(0, np.int32)
    )
    merged["poff"] = np.concatenate([np.zeros(1, np.int64)] + out["poff"])
    for k in ("p_start", "p_end", "p_rsi", "p_rei", "p_mm", "s_vorder", "nums"):
        dt = {"p_start": np.int64, "p_end": np.int64, "s_vorder": np.int64,
              "nums": np.uint16}.get(k, np.int32)
        merged[k] = (np.concatenate(out[k]) if out[k] else np.zeros(0, dt)).astype(dt)
    merged["soff"] = np.concatenate([np.zeros(1, np.int64)] + out["soff"])
    merged["noff"] = np.concatenate([np.zeros(1, np.int64)] + out["noff"])
    return merged


class RepOracle:
    """Digest-keyed exchanged Geno table. resolve() maps one prep's rows to
    the 12 flat arrays gt_call_finish imports (ExtView layout; unresolved
    rows fall back to host alignment)."""

    def __init__(self, digests: np.ndarray, table: dict):
        # digests [M, 16] (one per exchanged geno, in table order)
        dv = _as_void(np.ascontiguousarray(digests))
        order = np.argsort(dv, kind="stable")
        self.sorted_digests = dv[order]
        self.sorted_ext = order.astype(np.int64)
        self.table = table
        self.n_resolved = 0
        self.n_rows = 0

    def resolve(self, codes: np.ndarray, lens: np.ndarray):
        n_rows = len(lens)
        if n_rows and len(self.sorted_digests):
            keys = _as_void(
                _digest_rows([codes[i, : lens[i]].tobytes() for i in range(n_rows)])
            )
            idx = np.searchsorted(self.sorted_digests, keys)
            idx = np.minimum(idx, len(self.sorted_digests) - 1)
            hit = self.sorted_digests[idx] == keys
            row_ext = np.where(hit, self.sorted_ext[idx], -1).astype(np.int64)
        else:
            row_ext = np.full(n_rows, -1, dtype=np.int64)
        self.n_rows += n_rows
        self.n_resolved += int((row_ext >= 0).sum())
        t = self.table
        return (
            np.ascontiguousarray(row_ext), t["longest"], t["poff"], t["p_start"],
            t["p_end"], t["p_rsi"], t["p_rei"], t["p_mm"], t["soff"],
            t["s_vorder"], t["noff"], t["nums"],
        )


def local_row_seqs(hts_pools: list[list[str]], region, sam_flag_filter: int,
                   ref_path: str | None = None) -> np.ndarray:
    """Distinct oriented row sequences across this host's pools as a
    bytewise-sorted [N, L] uint8 matrix (pad 15). Builds (and caches) each
    pool's prep, so the subsequent call_pool reuses the same dedup and row
    numbering. Each entry is released once its rows are read."""
    from graphtyper_tpu_torch.io.native import get_lib
    from graphtyper_tpu_torch.pipeline.native_caller import _get_prep, _setup_lib

    lib = get_lib()
    _setup_lib(lib)
    mats = []
    for pool in hts_pools:
        entry = _get_prep(lib, pool, region, sam_flag_filter, False,
                          position_filter=False, ref_path=ref_path)
        if entry is None:
            continue
        try:  # _get_prep hands the entry out pinned
            codes, _lens = entry.fetch_row_seqs(lib)
        finally:
            entry.release(lib)
        mats.append(codes)
    if not mats:
        return np.zeros((0, 0), dtype=np.uint8)
    width = max(m.shape[1] for m in mats)
    stacked = np.concatenate([_pad_to(m, width) for m in mats])
    order = np.argsort(_as_void(stacked), kind="stable")
    stacked = stacked[order]
    keep = np.ones(len(stacked), bool)
    if len(stacked) > 1:
        keep[1:] = _as_void(stacked)[1:] != _as_void(stacked)[:-1]
    return np.ascontiguousarray(stacked[keep])


def _rows_to_seqs(mat: np.ndarray) -> list[bytes]:
    """Trim pad-15 tails; the aligner consumes raw code strings. Internal
    15s cannot occur (codes are <= 14), so the last non-pad column is the
    length."""
    if not mat.size:
        return []
    w = mat.shape[1]
    lens = w - (mat[:, ::-1] != PAD).argmax(axis=1)
    return [mat[i, : lens[i]].tobytes() for i in range(mat.shape[0])]


_LOCAL_CACHE: dict = {}  # union_key -> (mine_seqs, mine_digests)


def _digest_rows(seqs: list[bytes]) -> np.ndarray:
    """[N, 16] blake2b-128 digests of the trimmed row sequences. The digest
    IS the cross-host identity of an align work unit: collision probability
    is ~2^-128, and inputs are non-adversarial read sequences."""
    import hashlib

    out = np.empty((len(seqs), 16), dtype=np.uint8)
    for i, s in enumerate(seqs):
        out[i] = np.frombuffer(hashlib.blake2b(s, digest_size=16).digest(), np.uint8)
    return out


def build_oracle(graph, index, my_mat: np.ndarray, allgather_bytes,
                 n_hosts: int, host: int, n_threads: int = 0,
                 union_key=None) -> RepOracle:
    """One-collective exchange: hosts never ship sequences, only results.
    The oriented seq's 128-bit digest is its global identity; digests
    partition round-robin by their first 8 bytes mod n_hosts, each host
    aligns the OWNED sequences it locally has, and one allgather ships
    (digests, serialized Geno table). Rows whose seq no other host aligned
    (unowned-and-unshared) simply fall back to the local walk — no work is
    duplicated either way, and nothing larger than the result table
    crosses the wire. The local seq set and digests are iteration-
    invariant (reads don't change); pass union_key to reuse them."""
    import os
    import time

    from graphtyper_tpu_torch.typer.native_align import NativeAligner

    _prof = bool(os.environ.get("GT_DIST_PROFILE"))
    t0 = time.perf_counter()

    def mark(stage):
        nonlocal t0
        if _prof:
            now = time.perf_counter()
            print(f"[rep_shard h{host}] {stage} {now - t0:.2f}s", flush=True)
            t0 = now

    cached = _LOCAL_CACHE.get(union_key) if union_key is not None else None
    if cached is None:
        seqs = _rows_to_seqs(my_mat)
        digests = _digest_rows(seqs)
        owner = (
            digests[:, :8].copy().view(np.uint64).reshape(-1) % n_hosts
            if len(seqs)
            else np.zeros(0, np.uint64)
        )
        keep = np.nonzero(owner == host)[0]
        mine_seqs = [seqs[i] for i in keep]
        mine_digests = np.ascontiguousarray(digests[keep])
        mark(f"digest+partition (local={len(seqs)}, mine={len(mine_seqs)})")
        if union_key is not None:
            _LOCAL_CACHE.clear()
            _LOCAL_CACHE[union_key] = (mine_seqs, mine_digests)
    else:
        mine_seqs, mine_digests = cached

    if n_threads <= 0:
        try:
            n_threads = len(os.sched_getaffinity(0))
        except AttributeError:
            n_threads = os.cpu_count() or 1
    aligner = NativeAligner(graph, index)
    table_mine = aligner.align_rows_raw(mine_seqs, n_threads=n_threads)
    mark(f"align_partition (n={len(mine_seqs)})")
    parts = [
        pickle.loads(b)
        for b in allgather_bytes(
            pickle.dumps((mine_digests, table_mine), protocol=pickle.HIGHEST_PROTOCOL)
        )
    ]
    mark("gather_tables")
    merged = _concat_tables([t for _d, t in parts])
    # each digest has exactly one owner and only the owner aligns it, so
    # digests are unique across parts by construction
    all_digests = np.concatenate([d for d, _t in parts])
    return RepOracle(all_digests, merged)
