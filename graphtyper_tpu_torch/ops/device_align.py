"""Device-resident read alignment: the call iteration's align stage.

Port of graphtyper_tpu/ops/device_align.py. The k-mer index (sorted keys,
label spans) and the graph's reference arena stay in device memory for one
call iteration (`DeviceAligner`). One launch per batch of read-orientation
rows decides, for every row, whether it is "clean": its exact stride-31
32-mers all hit one placement whose labels chain, its right tail stays
inside one reference node with few mismatches, and no host code path could
give another result. The C++ engine (native/gt_align.cpp
synth_geno_from_verdict) rebuilds a clean row's path set from its verdict
row and skips seed, lattice and walk; every other row goes to the host
aligner. The rules and why they are sufficient are in the JAX package's
module docstring; verify mode (GT_DEVICE_ALIGN=verify) runs both and counts
divergences.

A verdict row is 9 int32: meta = clean | min(mm, 7) << 1 | min(nv, 6) << 4,
the chain's start and end (uint32 bit patterns), and the first 6 crossed
variant labels as var_id + (kmer << 24), -1 when empty.

`DeviceAligner.verdicts_async` is the wrapper: CPU tensors run
`verdicts_plain`, the plain PyTorch version, on the tables in the JAX
package's layout (`TABLES`); CUDA tensors launch csrc/device_align.cu (one
thread per row) on the same tables packed into 16-byte records
(`PACKED`), or the call raises.
"""

from __future__ import annotations

import functools
import threading
import time

import numpy as np
import torch

from graphtyper_tpu_torch import counters, kernels
from graphtyper_tpu_torch.ops.seed_probe import _upload_rows, padded_rows

K = 32
LABEL_CAP = 6  # per-kmer gathered labels; bigger spans fall back
VAR_SLOTS = 6  # chain variant payload slots; more crossed vars fall back
TAIL_PAD = 32  # >= max tail length (30: one more kmer fits at 31)
OUT_COLS = 9  # meta (verdict | mm<<1 | nv<<4), start, end, slot0..5
SPECIAL_START = 0xD0000000
VAR_ID_BITS = 24  # slot encoding: var_id | (kmer_index << 24)
BUCKET_BITS = 14  # prefix-bucket accelerator over the sorted key table
M32 = 0xFFFFFFFF
#: the searches add two table positions in int32, as the JAX package does
MAX_TABLE = 1 << 30

#: the tables in the order `verdicts_plain` takes them
TABLES = ("keys_hi", "keys_lo", "offsets", "lab_start", "lab_end", "lab_var", "bucket",
          "ref_order", "ref_len", "ref_start", "ref_arena")
#: the same tables as csrc/device_align.cu reads them, in its order: a
#: record [n_keys, 4] of (key lo, key hi, offsets[i], offsets[i + 1]), a
#: record [n_labels, 4] of (start, end, variant, 0), the buckets, a record
#: [n_ref, 4] of (node start, length, arena offset, 0), all int32 bit
#: patterns, and the arena padded with zeros to a multiple of 16 bytes
PACKED = ("key_rec", "lab_rec", "bucket", "ref_rec", "ref_arena")


def _ceil_log2(n: int) -> int:
    n = max(2, int(n))
    return int(n - 1).bit_length()


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to the int32 of their low 32 bits."""
    return ((x & M32) ^ 0x80000000) - 0x80000000


def _lower_bound_u64(q_hi, q_lo, keys_hi, keys_lo, steps: int, lo, hi):
    """graphtyper_tpu/ops/device_align.py:81: exactly `steps` halvings of
    [lo, hi) over a sorted uint64 table held as int64 halves, for the first
    index i with keys[i] >= q, with the same clamps and guards."""
    n = keys_hi.shape[0]
    for _ in range(steps):
        mid = (lo + hi) >> 1
        midc = torch.clamp(mid, max=n - 1)
        mh = keys_hi[midc]
        ml = keys_lo[midc]
        less = (mh < q_hi) | ((mh == q_hi) & (ml < q_lo))
        lo, hi = torch.where(less & (mid < hi), mid + 1, lo), torch.where(less, hi, torch.minimum(hi, mid))
    return lo


def verdicts_plain(hi, lo, valid, tails, lens, keys_hi, keys_lo, offsets, lab_start, lab_end,
                   lab_var, bucket, ref_order, ref_len, ref_start, ref_arena, *,
                   key_steps: int, ref_steps: int) -> torch.Tensor:
    """graphtyper_tpu/ops/device_align.py:107 _verdicts_impl in torch, on
    int64 with explicit 32-bit wrap-around. hi/lo [S, nk] uint32, valid
    [S, nk] uint8, tails [S, TAIL_PAD] uint8, lens [S] int32, then the
    tables of `DeviceAligner` (`TABLES`). Returns [S, OUT_COLS] int32 on the
    inputs' device."""
    S, nk = hi.shape
    dev = hi.device
    i64 = torch.int64
    hi, lo, lens = hi.to(i64), lo.to(i64), lens.to(i64)
    keys_hi, keys_lo, offsets = keys_hi.to(i64), keys_lo.to(i64), offsets.to(i64)
    lab_start, lab_end, lab_var = lab_start.to(i64), lab_end.to(i64), lab_var.to(i64)
    bucket, ref_order, ref_len, ref_start = (t.to(i64) for t in (bucket, ref_order, ref_len, ref_start))
    n_keys, n_labels, n_ref = keys_hi.shape[0], lab_start.shape[0], ref_order.shape[0]

    nk_r = torch.where(lens >= K, 1 + torch.div(lens - K, K - 1, rounding_mode="floor"), 0)
    nk_r = torch.clamp(nk_r, max=nk)
    karange = torch.arange(nk, dtype=i64, device=dev)[None, :]
    kmask = karange < nk_r[:, None]  # [S, nk] kmers the read actually has

    # ---- exact index probe per kmer -------------------------------------
    b = hi >> (32 - BUCKET_BITS)
    pos = _lower_bound_u64(hi, lo, keys_hi, keys_lo, key_steps, bucket[b], bucket[b + 1])
    posc = torch.clamp(pos, max=max(0, n_keys - 1))
    found = (pos < n_keys) & (keys_hi[posc] == hi) & (keys_lo[posc] == lo)
    a = offsets[posc]
    size = torch.where(found, offsets[torch.clamp(posc + 1, max=n_keys)] - a, 0)
    okcap = (size >= 1) & (size <= LABEL_CAP)

    # ---- gather up to LABEL_CAP labels per kmer --------------------------
    slot = torch.arange(LABEL_CAP, dtype=i64, device=dev)[None, None, :]
    lidx = torch.clamp(a[:, :, None] + slot, 0, max(0, n_labels - 1))
    slot_on = slot < size[:, :, None]  # [S, nk, CAP]
    ls, le, lv = lab_start[lidx], lab_end[lidx], lab_var[lidx]
    same_span = ((~slot_on) | ((ls == ls[:, :, :1]) & (le == le[:, :, :1]))).all(dim=2)
    ls0, le0 = ls[:, :, 0], le[:, :, 0]

    kmer_ok = (valid != 0) & found & okcap & same_span
    all_kmers_ok = (kmer_ok | ~kmask).all(dim=1) & (nk_r >= 2)
    link = (le0[:, :-1] == ls0[:, 1:]) | ~kmask[:, 1:]
    chain_ok = link.all(dim=1)

    last = torch.clamp(nk_r - 1, min=0)
    chain_end = le0.gather(1, last[:, None])[:, 0]
    start = ls0[:, 0]
    end_plain = chain_end < SPECIAL_START

    # ---- right-tail extension inside one reference node ------------------
    tail_len = torch.clamp(lens - 1 - 31 * nk_r, min=0)
    has_tail = tail_len > 0
    zeros = torch.zeros_like(chain_end)
    r = _lower_bound_u64(zeros, (chain_end + 1) & M32, torch.zeros_like(ref_order), ref_order,
                         ref_steps, zeros, torch.full_like(chain_end, n_ref)) - 1
    rc = torch.clamp(r, 0, max(0, n_ref - 1))
    node_order, node_len = ref_order[rc], ref_len[rc]
    off_in_node = _i32(chain_end - node_order)
    in_node = (r >= 0) & (chain_end >= node_order) & (off_in_node < node_len)
    tail_fits = _i32(off_in_node + tail_len) < node_len

    tk = torch.arange(TAIL_PAD, dtype=i64, device=dev)[None, :]
    tidx = _i32(ref_start[rc][:, None] + off_in_node[:, None] + 1 + tk)
    refb = ref_arena[torch.clamp(tidx, 0, ref_arena.shape[0] - 1)].to(i64)
    tmask = tk < tail_len[:, None]
    readb = tails.to(i64)
    mm = (tmask & (readb != refb) & (readb < 4) & (refb < 4)).sum(dim=1)
    no_tag = ((~tmask) | (refb != 6)).all(dim=1)
    budget = torch.clamp(2 + torch.div(tail_len + 1, 11, rounding_mode="floor"), max=7)
    tail_ok = torch.where(has_tail, in_node & tail_fits & no_tag & (mm <= budget) & (mm <= 2), True)
    mm = torch.where(has_tail, mm, 0)

    # ---- chain variant payload -------------------------------------------
    vmask = slot_on & (lv >= 0) & kmask[:, :, None]  # [S, nk, CAP]
    nv = vmask.sum(dim=(1, 2))
    small_ids = ((~vmask) | (lv < (1 << VAR_ID_BITS))).all(dim=2).all(dim=1)
    flat_mask = vmask.reshape(S, nk * LABEL_CAP)
    flat_val = _i32(lv + (karange[:, :, None] << VAR_ID_BITS)).reshape(S, nk * LABEL_CAP)
    rank = flat_mask.cumsum(dim=1) - 1
    # each of the first VAR_SLOTS variant labels lands in the slot of its
    # rank; every other entry lands in a spare last column
    target = torch.where(flat_mask & (rank < VAR_SLOTS), rank, VAR_SLOTS)
    slots = torch.full((S, VAR_SLOTS + 1), -1, dtype=i64, device=dev)
    slots.scatter_(1, target, flat_val)
    slots = slots[:, :VAR_SLOTS]

    # a Hamming-1 fork at a crossed site can tie only when mm >= 1
    safety = (mm == 0) | (nv == 0)
    two_kmer_ok = (nk_r >= 3) | (mm <= 1)
    verdict = (all_kmers_ok & chain_ok & end_plain & tail_ok & (nv <= VAR_SLOTS) & small_ids
               & safety & two_kmer_ok)

    end = torch.where(has_tail, chain_end + tail_len, chain_end)
    meta = verdict.to(i64) | (torch.clamp(mm, max=7) << 1) | (torch.clamp(nv, max=VAR_SLOTS) << 4)
    out = torch.cat([meta[:, None], _i32(start)[:, None], _i32(end)[:, None], slots], dim=1)
    return out.to(torch.int32)


#: this process's running verdict telemetry, the align_rows and
#: align_wall_s of ops/site_scoring.py's GT_SCORING_STATS lines: the rows
#: collected and the host wall of their launches and waits
ALIGN_STATS = {"align_rows": 0, "align_wall_s": 0.0}
_ALIGN_LOCK = threading.Lock()


class PendingVerdicts:
    """Verdicts of one launch, on their way to the host. On the card the
    rows are copied into pinned memory behind the kernel and `wait` blocks
    on that copy's event only, not on later work of the stream."""

    def __init__(self, host: torch.Tensor, event, n_rows: int, launch_s: float) -> None:
        self._host = host
        self._event = event
        self.n_rows = n_rows
        self._launch_s = launch_s

    def wait(self) -> np.ndarray:
        """int32 [n_rows, OUT_COLS] on the host. The counters take the rows
        and the host time spent in the launch and here."""
        t0 = time.perf_counter()
        if self._event is not None:
            self._event.synchronize()
        # a batch without rows still hands the engine a non-null pointer
        out = self._host[: self.n_rows].numpy() if self.n_rows else np.zeros((0, OUT_COLS), np.int32)
        wall = self._launch_s + time.perf_counter() - t0
        counters.add("device_align_wall_s", wall)
        counters.add("device_align_rows", self.n_rows)
        with _ALIGN_LOCK:
            ALIGN_STATS["align_rows"] += self.n_rows
            ALIGN_STATS["align_wall_s"] += wall
        return out


class DeviceAligner:
    """Per-(graph, index) alignment state: the index and reference tables
    go to `device` once and stay there for the call iteration, in the
    layout that runs on it: `packed` for the kernel on a card, `tables` for
    `verdicts_plain` on the CPU (either is uploaded at its first use)."""

    def __init__(self, na, device: torch.device | str) -> None:
        """na: typer.native_align.NativeAligner (flat graph + index arrays).
        Raises on an empty table: the JAX package's gathers raise there too,
        and its caller then aligns every row on the host
        (`tables_nonempty` lets the pipeline skip the launch instead)."""
        self.device = torch.device(device)
        keys = np.asarray(na.keys, dtype=np.uint64)
        self.n_keys = len(keys)
        self.n_ref = len(na.ref_order)
        if not tables_nonempty(na):
            raise ValueError("DeviceAligner: the index or the reference arena is empty")
        if max(self.n_keys, len(na.lab_start), self.n_ref, len(na.ref_arena)) >= MAX_TABLE:
            raise ValueError(f"DeviceAligner: tables must hold fewer than {MAX_TABLE} entries")
        hi_host = (keys >> np.uint64(32)).astype(np.uint32)
        # prefix buckets over the top BUCKET_BITS of each key: search only
        # within the (small) bucket span instead of the whole table
        tops = (hi_host >> np.uint32(32 - BUCKET_BITS)).astype(np.int64)
        bucket = np.searchsorted(tops, np.arange((1 << BUCKET_BITS) + 1)).astype(np.int32)
        span = int((bucket[1:] - bucket[:-1]).max())
        self.key_steps = _ceil_log2(span + 1)
        self.ref_steps = _ceil_log2(self.n_ref + 1)
        host = dict(
            keys_hi=hi_host,
            keys_lo=(keys & np.uint64(M32)).astype(np.uint32),
            offsets=np.asarray(na.offsets, dtype=np.int32),
            lab_start=np.asarray(na.lab_start, dtype=np.uint32),
            lab_end=np.asarray(na.lab_end, dtype=np.uint32),
            lab_var=np.asarray(na.lab_var, dtype=np.int64).astype(np.int32),  # INVALID -> -1
            bucket=bucket,
            ref_order=np.asarray(na.ref_order, dtype=np.uint32),
            ref_len=np.asarray(na.ref_dna_len, dtype=np.int32),
            ref_start=np.asarray(na.ref_dna_start, dtype=np.int32),
            ref_arena=np.asarray(na.ref_arena, dtype=np.uint8),
        )
        self._host = host
        self.n_labels = len(host["lab_start"])
        self.n_arena = len(host["ref_arena"])

    @functools.cached_property
    def tables(self) -> tuple[torch.Tensor, ...]:
        """The tables of `TABLES` on this aligner's device."""
        return tuple(torch.from_numpy(np.ascontiguousarray(self._host[n])).to(self.device) for n in TABLES)

    @functools.cached_property
    def packed(self) -> tuple[torch.Tensor, ...]:
        """The tables of `PACKED` on this aligner's device."""
        return tuple(torch.from_numpy(a).to(self.device) for a in pack_tables(self._host))

    def table_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tables)

    def launch(self, kmers, tails: torch.Tensor, lens: torch.Tensor, nk: int) -> torch.Tensor:
        """The verdict rows [S, OUT_COLS] int32 of every staged row, on this
        aligner's device. CPU tensors run `verdicts_plain`; CUDA tensors go
        to csrc/device_align.cu, which is built at first use, or the call
        raises."""
        hi, lo, valid = kmers
        if hi.shape[1] != nk:
            raise ValueError(f"verdicts: nk {nk} but the kmer matrix has {hi.shape[1]} columns")
        steps = dict(key_steps=self.key_steps, ref_steps=self.ref_steps)
        if hi.device.type == "cpu":
            counters.add("device_align_plain")
            return verdicts_plain(hi, lo, valid, tails, lens, *self.tables, **steps)
        dev = hi.device
        lib = kernels.load()
        S = hi.shape[0]
        kernels.check_cuda("verdicts", dev, (
            ("hi", hi, torch.uint32, 2), ("lo", lo, torch.uint32, 2), ("valid", valid, torch.uint8, 2),
            ("tails", tails, torch.uint8, 2), ("lens", lens, torch.int32, 1),
            *((n, t, t.dtype, t.dim()) for n, t in zip(PACKED, self.packed)),
        ))
        if lo.shape != hi.shape or valid.shape != hi.shape or tails.shape != (S, TAIL_PAD) \
                or lens.shape != (S,):
            raise ValueError(
                f"verdicts: shapes differ: hi {tuple(hi.shape)}, lo {tuple(lo.shape)}, valid "
                f"{tuple(valid.shape)}, tails {tuple(tails.shape)} (want [S, {TAIL_PAD}]), "
                f"lens {tuple(lens.shape)}")
        if any(t.data_ptr() % 16 for t in (tails, *self.packed)):
            raise ValueError("verdicts: tails and the packed tables must start on a 16-byte boundary")
        if S * nk >= 2**30:
            raise ValueError("verdicts: S * nk must be below 2^30")
        with torch.cuda.device(dev):
            out = torch.empty((S, OUT_COLS), dtype=torch.int32, device=dev)
            rc = lib.gt_device_align(
                hi.data_ptr(), lo.data_ptr(), valid.data_ptr(), tails.data_ptr(), lens.data_ptr(),
                *(t.data_ptr() for t in self.packed), out.data_ptr(),
                S, nk, self.n_keys, self.n_labels, self.n_ref, self.n_arena, self.key_steps,
                self.ref_steps, torch.cuda.current_stream(dev).cuda_stream,
            )
        if rc != 0:
            raise RuntimeError(f"device_align kernel launch failed: cudaGetLastError() = {rc}")
        counters.add("device_align")
        return out

    def verdicts_async(self, kmers, tails: torch.Tensor, lens: torch.Tensor, n_rows: int,
                       nk: int) -> PendingVerdicts:
        """Launch the verdicts of the first n_rows staged rows without
        waiting for them. The streaming caller collects them after the host
        has aligned the batch before."""
        t0 = time.perf_counter()
        out = self.launch(kmers, tails, lens, nk)
        if out.device.type == "cpu":
            return PendingVerdicts(out, None, n_rows, time.perf_counter() - t0)
        host = torch.empty((n_rows, OUT_COLS), dtype=torch.int32, pin_memory=True)
        host.copy_(out[:n_rows], non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(out.device))
        return PendingVerdicts(host, event, n_rows, time.perf_counter() - t0)

    def verdicts(self, kmers, tails: torch.Tensor, lens: torch.Tensor, n_rows: int,
                 nk: int) -> np.ndarray:
        """kmers = (hi, lo, valid) [S, nk] tensors; tails [S, TAIL_PAD]
        uint8; lens [S] int32 (all row-padded, on this aligner's device).
        Returns host int32 [n_rows, OUT_COLS]."""
        return self.verdicts_async(kmers, tails, lens, n_rows, nk).wait()


def pack_tables(host: dict) -> tuple[np.ndarray, ...]:
    """The kernel's tables (`PACKED`) from the host tables of `TABLES`:
    each record is one 16-byte load on the card."""
    def record(*cols):
        rec = np.zeros((len(cols[0]), 4), np.int32)
        for i, c in enumerate(cols):
            rec[:, i] = np.asarray(c).astype(np.uint32, copy=False).view(np.int32)
        return rec

    offsets = host["offsets"]
    arena = np.zeros(-(-len(host["ref_arena"]) // 16) * 16, np.uint8)
    arena[: len(host["ref_arena"])] = host["ref_arena"]
    return (record(host["keys_lo"], host["keys_hi"], offsets[:-1], offsets[1:]),
            record(host["lab_start"], host["lab_end"], host["lab_var"]),
            np.ascontiguousarray(host["bucket"], np.int32),
            record(host["ref_order"], host["ref_len"], host["ref_start"]),
            arena)


def tables_nonempty(na) -> bool:
    """Whether every table the verdicts gather from has an entry."""
    return min(len(na.keys), len(na.lab_start), len(na.ref_order), len(na.ref_arena)) > 0


def stage_tails(tails: np.ndarray, lens: np.ndarray, device: torch.device | str):
    """Row-pad and upload the tail matrix (pad code 15) and the length
    vector (pad 0), like `seed_probe.stage_kmers`."""
    device = torch.device(device)
    S = padded_rows(tails.shape[0])
    return (_upload_rows(tails.astype(np.uint8, copy=False), S, 15, device),
            _upload_rows(lens.astype(np.int32, copy=False), S, 0, device))
