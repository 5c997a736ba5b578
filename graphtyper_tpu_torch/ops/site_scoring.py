"""Batched observation scoring on a torch device.

Port of graphtyper_tpu/ops/site_scoring.py: `apply_tier` is the
counterpart of the jitted `_apply_tier_impl` (:141-234) and returns the
same flat vector in the same order (:221-234). On a CUDA tensor it launches
the hand-written kernel csrc/site_scoring.cu (a memset and one launch a
flush at A 2 and 4, a second launch above; built at first use) or raises;
on a CPU tensor it runs `apply_tier_plain`, the torch-op version (integer
segment sums with `index_add_` and a Gram product, in chunks of
`_chunk_rows(A)` rows that bound the [N, T] term).
`ObsBatcher` (:498) applies every tier on its device, whatever the row
count (no host threshold), and writes each flush's rows for a CUDA device
into pinned host memory, copied without blocking the host on the current
stream. The pinned block comes from torch's caching host allocator, which
keeps it for the next flush and hands it out again only after the event it
records on the copy has passed.
Given a mesh (parallel/mesh.py) it applies each flush over the mesh (the
form of :279 `_jitted_apply_tier_sharded`): the rows split into one
contiguous shard a mesh entry, each entry applies its shard on its
device, and the flat int64 vectors are summed on the first device and, where
the mesh's host axis spans a process group, over the group. The
observation layout, the tier buffers, the >64-allele host update and the
materialization into site state are the JAX module's, copied.

Every sum is an integer sum taken in int64, so the result is exact and
independent of the order of the rows, on the kernel and the plain path.

With GT_SCORING_STATS set to a path, every `finalize()` appends one JSON
line of telemetry to it (O_APPEND, so region workers can share the file):
the JAX line's eight keys and `pid`, each the change since this process's
last line, so lines from several processes sum without double counting.
`device_rows` and `device_wall_s` are the rows applied on the scorer's
device (or mesh) and the host wall spent staging, launching and
collecting them; the wall is what the host already waits, no
synchronization is added for it. `host_rows` and `host_apply_wall_s` are
always 0: no row-count threshold sends rows to the host in the port.
`h2d_bytes` counts the bytes of observation matrices copied to a CUDA
device (0 on the CPU), `materialize_wall_s` the host's fold into site
state, and `align_rows`/`align_wall_s` the verdict launches of
ops/device_align.py, in memory and in the streaming caller.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np
import torch

from graphtyper_tpu_torch import counters, kernels

__all__ = [
    "ObsBatcher", "apply_tier", "apply_tier_plain", "split_totals", "tier_for",
    "totals_from_numpy", "totals_to_numpy",
]

# coverage class encoding for buffered observations (host codes NO/MULTI_*
# as large sentinels; the device buffer uses small negatives so real allele
# classes can index per-allele segment sums directly)
COV_MULTI_ALT = -1
COV_MULTI_REF = -2
COV_PAD = -3

ALLELE_TIERS = (2, 4, 8, 16, 32, 64)

#: this process's running scoring telemetry (see the module docstring);
#: the scorer's pool threads add to it under _STATS_LOCK
SCORING_STATS = {"host_rows": 0, "device_rows": 0, "device_wall_s": 0.0,
                 "host_apply_wall_s": 0.0, "materialize_wall_s": 0.0, "h2d_bytes": 0}
_STATS_LOCK = threading.Lock()
_STATS_SNAPSHOT = {**SCORING_STATS, "align_rows": 0, "align_wall_s": 0.0}


def add_stats(**deltas) -> None:
    """Add to this process's SCORING_STATS."""
    with _STATS_LOCK:
        for k, v in deltas.items():
            SCORING_STATS[k] += v


def _write_scoring_stats() -> None:
    """Append the change since the last write to $GT_SCORING_STATS, one
    line per finalize (graphtyper_tpu/ops/site_scoring.py:62)."""
    path = os.environ.get("GT_SCORING_STATS")
    if not path:
        return
    from graphtyper_tpu_torch.ops.device_align import ALIGN_STATS

    with _STATS_LOCK:
        now = {**SCORING_STATS, **ALIGN_STATS.copy()}
        delta = {k: now[k] - _STATS_SNAPSHOT[k] for k in now}
        _STATS_SNAPSHOT.update(now)
    delta = {k: (round(v, 4) if isinstance(v, float) else v) for k, v in delta.items()}
    delta["pid"] = os.getpid()
    fd = os.open(path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
    try:
        os.write(fd, (json.dumps(delta) + "\n").encode())
    finally:
        os.close(fd)

#: columns of one observation row, in buffer order
OBS_FIELDS = (
    "site",
    "sample",
    "eps",
    "apply_score",
    "bits_lo",
    "bits_hi",
    "cov",
    "clipped_scaled",
    "clipped_flag",
    "mapq_sq",
    "mm_scaled",
    "sdiff",
    "strand",
    "proper",
)


def tier_for(cnum: int) -> int | None:
    for t in ALLELE_TIERS:
        if cnum <= t:
            return t
    return None  # host fallback for >64-allele sites (rare)


@lru_cache(maxsize=None)
def _triangle_xy(A: int) -> tuple[np.ndarray, np.ndarray]:
    xs, ys = [], []
    for y in range(A):
        for x in range(y + 1):
            xs.append(x)
            ys.append(y)
    return np.asarray(xs), np.asarray(ys)


def _chunk_rows(A: int) -> int:
    """Rows per `apply_tier_plain` step, sized so the [N, A, A] Gram tensor
    stays small."""
    return max(4096, min(1 << 18, (1 << 23) // (A * A)))


_F = {k: i for i, k in enumerate(OBS_FIELDS)}


def _seg_sum(idx: torch.Tensor, w: torch.Tensor, size: int) -> torch.Tensor:
    """Segment sums of the rows of `w` (or of a vector) by `idx`, int64."""
    out = torch.zeros((size, *w.shape[1:]), dtype=torch.int64, device=w.device)
    return out.index_add_(0, idx, w.to(torch.int64))


def apply_tier(obs_mat: torch.Tensor, A: int, n_sites: int, n_samples: int) -> torch.Tensor:
    """Observation rows -> the flat int64 state-delta vector, on the rows'
    device.

    `obs_mat` is the [14, N] int32 matrix in OBS_FIELDS order (the explain
    bitmaps as the int32 bit patterns of their uint32 words). Padding rows
    (eps 0, bits 0, cov COV_PAD, zero scalars) add nothing. Port of
    graphtyper_tpu/ops/site_scoring.py:141 _apply_tier_impl. A CPU tensor
    runs `apply_tier_plain`; a CUDA tensor goes to csrc/site_scoring.cu,
    built at first use: one `torch.empty` buffer (the vector, then the
    kernel's scratch above A 4), zeroed by the launcher's one memset, and
    all N rows in one launch of pass 1 (and of pass 2 above A 4), or the
    call raises. Above A 4 the vector is a view of the buffer's first
    entries."""
    if obs_mat.device.type == "cpu":
        return apply_tier_plain(obs_mat, A, n_sites, n_samples)
    dev = obs_mat.device
    lib = kernels.load()
    kernels.check_cuda("apply_tier", dev, (("obs_mat", obs_mat, torch.int32, 2),))
    if obs_mat.shape[0] != len(OBS_FIELDS):
        raise ValueError(f"apply_tier: obs_mat must have {len(OBS_FIELDS)} rows, got {tuple(obs_mat.shape)}")
    if A not in ALLELE_TIERS:
        raise ValueError(f"apply_tier: A must be one of {ALLELE_TIERS}, got {A}")
    n_out, n_buf = lib.gt_site_scoring_size(A, n_sites, n_samples), lib.gt_site_scoring_buffer(A, n_sites, n_samples)
    with kernels.device_guard(dev):
        buf = torch.empty(n_buf, dtype=torch.int64, device=dev)
        rc = lib.gt_site_scoring(obs_mat.data_ptr(), obs_mat.shape[1], A, n_sites, n_samples, buf.data_ptr(),
                                 kernels.stream_of(dev))
    if rc != 0:
        raise RuntimeError(f"site_scoring kernel launch failed: cudaGetLastError() = {rc}")
    counters.add("apply_tier")
    return buf if n_buf == n_out else buf[:n_out]


def apply_tier_plain(obs_mat: torch.Tensor, A: int, n_sites: int, n_samples: int) -> torch.Tensor:
    """The torch-op version of `apply_tier`: the rows in chunks of
    `_chunk_rows(A)` (bounds the [N, T] Gram term), their vectors summed.
    Each call bumps the `apply_tier_plain` counter, on any device."""
    counters.add("apply_tier_plain")
    chunk = _chunk_rows(A)
    total = None
    for lo in range(0, max(obs_mat.shape[1], 1), chunk):
        vec = _apply_chunk_plain(obs_mat[:, lo : lo + chunk], A, n_sites, n_samples)
        total = vec if total is None else total.add_(vec)
    return total


def _apply_chunk_plain(obs_mat: torch.Tensor, A: int, n_sites: int, n_samples: int) -> torch.Tensor:
    """One chunk of rows by torch ops: segment sums with `index_add_`, the
    PL triangle as u_x + u_y + W_xy from a [N, T] product."""
    S = n_sites * n_samples
    dev = obs_mat.device
    rows = obs_mat.to(torch.int64)
    site, sample, cov = rows[_F["site"]], rows[_F["sample"]], rows[_F["cov"]]
    applied = rows[_F["apply_score"]] > 0
    seg = site * n_samples + sample

    # explains bitmap B [N, A] from the two 32-bit words
    bits = (rows[_F["bits_lo"]] & 0xFFFFFFFF) | ((rows[_F["bits_hi"]] & 0xFFFFFFFF) << 32)
    shifts = torch.arange(A, device=dev, dtype=torch.int64)
    B = (bits[:, None] >> shifts[None, :]) & 1

    # -- PL triangle (explain_to_score): u_x + u_y + W_xy --------------------
    e = torch.where(applied, rows[_F["eps"]], 0)
    Bm = B * applied[:, None]
    u = _seg_sum(seg, (e - 1)[:, None] * Bm, S)  # [S, A]
    xs, ys = (torch.as_tensor(v, device=dev) for v in _triangle_xy(A))
    W = _seg_sum(seg, Bm[:, xs] * Bm[:, ys] * (2 - e)[:, None], S)  # [S, T]
    log_delta = u[:, xs] + u[:, ys] + W

    # -- coverage_to_gts ------------------------------------------------------
    is_allele = cov >= 0
    gt_cov = _seg_sum(seg, cov[:, None] == shifts[None, :], S)
    multi_alt = cov == COV_MULTI_ALT
    amb = _seg_sum(seg, (cov == COV_MULTI_REF) | multi_alt, S)
    amb_alt = _seg_sum(seg, multi_alt, S)
    alt_pp = _seg_sum(seg, (multi_alt | (is_allele & (cov > 0))) & (rows[_F["proper"]] > 0), S)

    # -- VarStats: per site, and per allele for single-allele reads -----------
    clip_reads = _seg_sum(site, rows[_F["clipped_flag"]], n_sites)
    site_mapq_sq = _seg_sum(site, rows[_F["mapq_sq"]], n_sites)
    aseg = site * A + torch.where(is_allele, cov, 0)
    amask = is_allele.to(torch.int64)
    SA = n_sites * A
    per_allele = [
        _seg_sum(aseg, rows[_F[k]] * amask, SA)
        for k in ("clipped_scaled", "mapq_sq", "mm_scaled", "sdiff")
    ]
    pa_strand = _seg_sum(aseg * 4 + rows[_F["strand"]], amask, SA * 4)

    return torch.cat([
        log_delta.reshape(-1), gt_cov.reshape(-1), amb, amb_alt, alt_pp,
        clip_reads, site_mapq_sq, *per_allele, pa_strand,
    ])


def apply_tier_sharded(mesh, obs_mat: torch.Tensor, A: int, n_sites: int,
                       n_samples: int) -> torch.Tensor:
    """`apply_tier` over a parallel/mesh.py Mesh: the rows of the [14, N]
    host matrix split into `mesh.size` contiguous shards, each shard this
    process runs applied on its entry's device, the vectors summed on the
    first of them and then over the host axis. Equal to the unsharded
    vector bit for bit, since every entry is an integer sum."""
    shards = torch.tensor_split(obs_mat, mesh.size, dim=1)
    total = None
    for i, dev in mesh.local_entries():
        counters.add(f"scoring_rows_shard{i}", shards[i].shape[1])
        if dev.type == "cuda":
            add_stats(h2d_bytes=shards[i].numel() * shards[i].element_size())
        vec = apply_tier(shards[i].to(dev).contiguous(), A, n_sites, n_samples)
        total = vec if total is None else total.add_(vec.to(total.device))
    return mesh.host_sum(total)


def flush_rows(mat: torch.Tensor, A: int, n_sites: int, n_samples: int, device: torch.device,
               mesh=None) -> torch.Tensor:
    """One scoring flush of a tier's [14, N] row matrix: the rows to
    `device` in one non-blocking copy (a mesh ships its own shards), then
    one `apply_tier` over all of them, over the mesh when there is one;
    returns the summed state vector, on `device`. The copy leaves the host
    free only when `mat` is pinned, as `ObsBatcher` makes it."""
    if mesh is not None:
        return apply_tier_sharded(mesh, mat, A, n_sites, n_samples)
    if mat.device.type == "cpu" and device.type == "cuda":
        add_stats(h2d_bytes=mat.numel() * mat.element_size())
        mat = mat.to(device, non_blocking=True)
    return apply_tier(mat, A, n_sites, n_samples)


def split_totals(vec: torch.Tensor, A: int, n_sites: int, n_samples: int) -> dict:
    """The flat vector split into the named totals of the JAX package's
    `_split_out_vec` (:237-257), as views on the vector's device."""
    S = n_sites * n_samples
    T = A * (A + 1) // 2
    sizes = [S * T, S * A, S, S, S, n_sites, n_sites, n_sites * A, n_sites * A,
             n_sites * A, n_sites * A, n_sites * A * 4]
    p = torch.split(vec, sizes)
    return dict(
        log_delta=p[0].reshape(S, T), gt_cov=p[1].reshape(S, A), amb=p[2], amb_alt=p[3],
        alt_pp=p[4], clip_reads=p[5], site_mapq_sq=p[6], pa_clip=p[7].reshape(n_sites, A),
        pa_mapq=p[8].reshape(n_sites, A), pa_mm=p[9].reshape(n_sites, A),
        pa_sdiff=p[10].reshape(n_sites, A), pa_strand=p[11].reshape(n_sites, A, 4),
    )


def totals_to_numpy(t: dict) -> dict:
    """Totals dict of tensors -> int64 numpy arrays (one copy per entry)."""
    return {k: v.detach().cpu().numpy().astype(np.int64) for k, v in t.items()}


def totals_from_numpy(d: dict, device: torch.device | str) -> dict:
    """Totals dict of numpy arrays -> int64 tensors on `device`."""
    return {k: torch.as_tensor(np.asarray(v, dtype=np.int64), device=device) for k, v in d.items()}


def obs_matrix(cols_np: dict, n: int, out: np.ndarray | None = None) -> np.ndarray:
    """[14, n] int32 row matrix of one tier's materialized columns, in `out`
    when given; the uint32 explain words ride as their int32 bit patterns."""
    mat = np.empty((len(OBS_FIELDS), n), dtype=np.int32) if out is None else out
    for i, k in enumerate(OBS_FIELDS):
        v = cols_np[k][:n]
        mat[i] = v.astype(np.uint32).view(np.int32) if k in ("bits_lo", "bits_hi") else v
    return mat


def apply_obs_host(
    site,
    sample: int,
    eps: int,
    apply_score: bool,
    explains,
    cov_code: int,
    clipped_scaled: int,
    clipped_flag: int,
    mapq_sq: int,
    mm_scaled: int,
    sdiff: int,
    strand: int,
    proper: int,
) -> None:
    """Apply one observation row directly to HaplotypeSite state — the exact
    integer updates of _apply_tier, for sites whose allele count exceeds the
    device bitmask tiers (>64)."""
    cnum = site.gt.num
    vs = site.var_stats
    vs.clipped_reads += clipped_flag
    vs.mapq_squared += mapq_sq
    is_allele = cov_code >= 0
    if is_allele:
        pa = vs.per_allele[cov_code]
        pa.clipped_bp += clipped_scaled
        pa.mapq_squared += mapq_sq
        pa.mismatches += mm_scaled
        pa.score_diff += sdiff
        rs = vs.read_strand[cov_code]
        if strand == 0:
            rs.r1_forward += 1
        elif strand == 1:
            rs.r2_forward += 1
        elif strand == 2:
            rs.r1_reverse += 1
        else:
            rs.r2_reverse += 1
    hs = site.hap_samples[sample]
    if apply_score:
        ex = [a for a in explains if a < cnum]
        exset = set(ex)
        i = 0
        for y in range(cnum):
            in_y = y in exset
            for x in range(y + 1):
                in_x = x in exset
                if in_x and in_y:
                    hs.log_score[i] += eps
                elif in_x or in_y:
                    hs.log_score[i] += eps - 1
                i += 1
        hs.max_log_score += eps
    if cov_code == COV_MULTI_REF:
        hs.ambiguous_depth = min(hs.ambiguous_depth + 1, 0xFF)
    elif cov_code == COV_MULTI_ALT:
        hs.ambiguous_depth = min(hs.ambiguous_depth + 1, 0xFF)
        hs.ambiguous_depth_alt = min(hs.ambiguous_depth_alt + 1, 0xFF)
        if proper:
            hs.alt_proper_pair_depth = min(hs.alt_proper_pair_depth + 1, 0xFF)
    else:
        if hs.gt_coverage[cov_code] < 0xFFFF:
            hs.gt_coverage[cov_code] += 1
        if cov_code > 0 and proper:
            hs.alt_proper_pair_depth = min(hs.alt_proper_pair_depth + 1, 0xFF)


@dataclass
class _TierBuffer:
    A: int
    site_ids: list[int] = field(default_factory=list)  # global site index per slot
    slot_of: dict[int, int] = field(default_factory=dict)
    cols: dict[str, list] = field(default_factory=lambda: {k: [] for k in OBS_FIELDS})
    # bulk numpy blocks (native caller feed) — concatenated with `cols` at
    # finalize; avoids per-element Python list churn for large pools
    blocks: list[dict] = field(default_factory=list)

    def slot(self, global_site: int) -> int:
        s = self.slot_of.get(global_site)
        if s is None:
            s = len(self.site_ids)
            self.slot_of[global_site] = s
            self.site_ids.append(global_site)
        return s

    def materialize_cols(self) -> tuple[dict, int]:
        """Concatenate list-cols and numpy blocks into one array per field."""
        out = {}
        n = 0
        for k in OBS_FIELDS:
            parts = [np.asarray(b[k], dtype=np.int64) for b in self.blocks]
            if self.cols[k]:
                parts.append(np.asarray(self.cols[k], dtype=np.int64))
            out[k] = np.concatenate(parts) if parts else np.zeros(0, np.int64)
            n = len(out[k])
        return out, n


class ObsBatcher:
    """Accumulates per-(read, site) observations and applies them to the
    HaplotypeSite states, one flush per allele tier on `device`, or over
    the entries of `mesh`
    (graphtyper_tpu/ops/site_scoring.py:498 without its host path). A CUDA
    device's flushes are written into pinned host memory."""

    def __init__(self, sites, n_samples: int, device: torch.device | str,
                 mesh=None):
        self.sites = sites
        self.n_samples = n_samples
        self.device = torch.device(device)
        self.mesh = mesh  # set -> applied over its entries
        self._pin = mesh is None and self.device.type == "cuda"
        self.tiers: dict[int, _TierBuffer] = {}
        self._totals: dict = {}  # tier -> running flush totals (site-major)
        # exact saturation tracking (haplotype.cpp:528-533): max_log_score is
        # the running sum of applied eps; a read is skipped for scoring once
        # the sum reaches 0xFFFF - eps
        self._eps_sum = np.zeros((len(sites), n_samples), dtype=np.int64)

    def add(
        self,
        site_idx: int,
        cnum: int,
        sample: int,
        eps: int,
        explains,
        cov_code: int,
        clipped_scaled: int,
        clipped_flag: int,
        mapq_sq: int,
        mm_scaled: int,
        sdiff: int,
        strand: int,
        proper: int,
    ) -> None:
        tier = tier_for(cnum)
        buf = self.tiers.get(tier)
        if buf is None:
            buf = self.tiers[tier] = _TierBuffer(A=tier)
        apply_score = self._eps_sum[site_idx, sample] < 0xFFFF - eps
        if apply_score:
            self._eps_sum[site_idx, sample] += eps
        lo = 0
        hi = 0
        for a in explains:
            if a < cnum:
                if a < 32:
                    lo |= 1 << a
                else:
                    hi |= 1 << (a - 32)
        c = buf.cols
        c["site"].append(buf.slot(site_idx))
        c["sample"].append(sample)
        c["eps"].append(eps)
        c["apply_score"].append(1 if apply_score else 0)
        c["bits_lo"].append(lo)
        c["bits_hi"].append(hi)
        c["cov"].append(cov_code)
        c["clipped_scaled"].append(clipped_scaled)
        c["clipped_flag"].append(clipped_flag)
        c["mapq_sq"].append(mapq_sq)
        c["mm_scaled"].append(mm_scaled)
        c["sdiff"].append(sdiff)
        c["strand"].append(strand)
        c["proper"].append(proper)

    # ------------------------------------------------------------------

    def maybe_flush(self, max_rows: int = 2_000_000) -> None:
        """Apply buffered observations to the device-side running totals if
        the buffer grew past `max_rows` — keeps host memory flat when the
        streaming caller feeds millions of rows per pool."""
        for tier, buf in self.tiers.items():
            n = sum(len(np.atleast_1d(b["site"])) for b in buf.blocks) + len(buf.cols["site"])
            if n >= max_rows:
                with counters.span("scoring.flush", n=n):
                    self._flush_tier(tier, buf)

    def finalize(self) -> None:
        """Run the device passes and materialize all accumulated site state.
        Every tier is launched before the first is collected. The whole
        is span `scoring.flush` (n: the rows), with each fold into site
        state a `scoring.materialize` under it."""
        with counters.span("scoring.flush") as sp:
            pending = [
                (tier, buf, self._flush_tier_launch(tier, buf))
                for tier, buf in self.tiers.items()
            ]
            sp.n = sum(launched[2] for _, _, launched in pending if launched is not None)
            for tier, buf, launched in pending:
                self._flush_tier_collect(tier, launched)
                totals = self._totals.pop(tier, None)
                if totals is not None:
                    t0 = time.perf_counter()
                    with counters.span("scoring.materialize"):
                        self._materialize(buf, totals, buf.A)
                    add_stats(materialize_wall_s=time.perf_counter() - t0)
        _write_scoring_stats()

    def _accumulate(self, tier: int, out: dict) -> None:
        """Add one flush's outputs into the running totals, growing the
        site-major arrays when the padded site bucket grew between flushes."""
        prev = self._totals.get(tier)
        if prev is None:
            self._totals[tier] = out
            return
        for k, v in out.items():
            p = prev[k]
            if p.shape[0] < v.shape[0]:
                widths = [(0, v.shape[0] - p.shape[0])] + [(0, 0)] * (p.ndim - 1)
                p = np.pad(p, widths)
            p[: v.shape[0]] += v
            prev[k] = p

    def _flush_tier(self, tier: int, buf: "_TierBuffer") -> None:
        self._flush_tier_collect(tier, self._flush_tier_launch(tier, buf))

    def _flush_tier_launch(self, tier: int, buf: _TierBuffer):
        """Ship the tier's rows in one transfer (from pinned memory to a
        CUDA device) and apply them in one `flush_rows`, over the mesh
        when there is one; returns the summed device vector, the tier's
        sites and its rows, or None when the tier holds no rows."""
        cols_np, n = buf.materialize_cols()
        buf.blocks = []
        buf.cols = {k: [] for k in OBS_FIELDS}
        if n == 0:
            return None
        counters.add("scoring_rows", n)
        t0 = time.perf_counter()
        n_sites = len(buf.site_ids)
        if self._pin:
            mat = torch.empty((len(OBS_FIELDS), n), dtype=torch.int32, pin_memory=True)
            obs_matrix(cols_np, n, out=mat.numpy())
        else:
            mat = torch.from_numpy(obs_matrix(cols_np, n))
        total = flush_rows(mat, buf.A, n_sites, self.n_samples, self.device, self.mesh)
        add_stats(device_rows=n, device_wall_s=time.perf_counter() - t0)
        return total, n_sites, n

    def _flush_tier_collect(self, tier: int, launched) -> None:
        """Copy the tier's summed totals to the host in one copy of the flat
        vector (the JAX op's one fetch, :220) and fold them into the
        running totals that `finalize` materializes."""
        if launched is None:
            return
        t0 = time.perf_counter()
        vec, n_sites, _ = launched
        A = self.tiers[tier].A
        self._accumulate(tier, totals_to_numpy(split_totals(vec.cpu(), A, n_sites, self.n_samples)))
        add_stats(device_wall_s=time.perf_counter() - t0)

    def _materialize(self, buf: _TierBuffer, out: dict, A: int) -> None:
        P = self.n_samples
        for slot, gsite in enumerate(buf.site_ids):
            site = self.sites[gsite]
            cnum = site.gt.num
            T = cnum * (cnum + 1) // 2
            vs = site.var_stats
            vs.clipped_reads += int(out["clip_reads"][slot])
            vs.mapq_squared += int(out["site_mapq_sq"][slot])
            for a in range(cnum):
                pa = vs.per_allele[a]
                pa.clipped_bp += int(out["pa_clip"][slot, a])
                pa.mapq_squared += int(out["pa_mapq"][slot, a])
                pa.mismatches += int(out["pa_mm"][slot, a])
                pa.score_diff += int(out["pa_sdiff"][slot, a])
                rs = vs.read_strand[a]
                rs.r1_forward += int(out["pa_strand"][slot, a, 0])
                rs.r2_forward += int(out["pa_strand"][slot, a, 1])
                rs.r1_reverse += int(out["pa_strand"][slot, a, 2])
                rs.r2_reverse += int(out["pa_strand"][slot, a, 3])
            ls_mat = getattr(site, "log_scores", None)
            batched_ls = ls_mat is not None and len(site.hap_samples) == P
            lo = slot * P
            if batched_ls:
                # one add per site: every hap_sample's log_score is a row
                # view of this matrix. The padded-A triangle enumerates
                # (x<=y, y ascending), so the first T entries are exactly
                # the cnum-allele triangle
                ls_mat[:, :T] += out["log_delta"][lo : lo + P, :T]
            cov_mat = getattr(site, "gt_coverages", None)
            batched_cov = cov_mat is not None and len(site.hap_samples) == P
            if batched_cov:
                # gt_coverage rows are views of this matrix too: one clamped
                # add per site replaces P per-sample numpy calls (the scalar
                # twin sums the full delta then clamps — identical)
                np.minimum(
                    cov_mat[:, :cnum] + out["gt_cov"][lo : lo + P, :cnum],
                    0xFFFF,
                    out=cov_mat[:, :cnum],
                )
            # scalar fields: compute the saturating adds vectorized, assign
            # per object (they are plain attributes, not matrix-backed)
            amb_blk = out["amb"][lo : lo + P]
            amba_blk = out["amb_alt"][lo : lo + P]
            apd_blk = out["alt_pp"][lo : lo + P]
            eps_blk = self._eps_sum[gsite]
            for p in range(P):
                hs = site.hap_samples[p]
                if not batched_ls:
                    hs.log_score[:T] += out["log_delta"][lo + p][:T]
                if not batched_cov:
                    hs.gt_coverage[:cnum] = np.minimum(
                        hs.gt_coverage[:cnum] + out["gt_cov"][lo + p][:cnum], 0xFFFF
                    )
                hs.max_log_score += int(eps_blk[p])
                hs.ambiguous_depth = min(hs.ambiguous_depth + int(amb_blk[p]), 0xFF)
                hs.ambiguous_depth_alt = min(hs.ambiguous_depth_alt + int(amba_blk[p]), 0xFF)
                hs.alt_proper_pair_depth = min(hs.alt_proper_pair_depth + int(apd_blk[p]), 0xFF)
