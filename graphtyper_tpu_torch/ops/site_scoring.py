"""Batched observation scoring on a torch device.

Port of graphtyper_tpu/ops/site_scoring.py: `apply_tier` is the torch form
of the jitted `_apply_tier_impl` (:144) and returns the same flat vector in
the same order (:221-234); `ObsBatcher` subclasses the JAX package's
batcher (:498) and applies every tier on its device, whatever the row
count (no host threshold). The mesh-sharded apply is not ported here.

Every sum is an integer segment sum taken in int64 with `index_add_`, so
the result is exact and independent of the order of the rows.
"""

from __future__ import annotations

import numpy as np
import torch

from graphtyper_tpu.ops import site_scoring as _ref
from graphtyper_tpu.ops.site_scoring import (
    COV_MULTI_ALT,
    COV_MULTI_REF,
    OBS_FIELDS,
    _chunk_rows,
    _triangle_xy,
    tier_for,
)
from graphtyper_tpu_torch import counters

__all__ = [
    "ObsBatcher", "apply_tier", "split_totals", "tier_for", "totals_from_numpy",
    "totals_to_numpy",
]

_F = {k: i for i, k in enumerate(OBS_FIELDS)}


def _seg_sum(idx: torch.Tensor, w: torch.Tensor, size: int) -> torch.Tensor:
    """Segment sums of the rows of `w` (or of a vector) by `idx`, int64."""
    out = torch.zeros((size, *w.shape[1:]), dtype=torch.int64, device=w.device)
    return out.index_add_(0, idx, w.to(torch.int64))


def apply_tier(obs_mat: torch.Tensor, A: int, n_sites: int, n_samples: int) -> torch.Tensor:
    """One chunk of observation rows -> the flat int64 state-delta vector.

    `obs_mat` is the [14, N] int32 matrix in OBS_FIELDS order (the explain
    bitmaps as the int32 bit patterns of their uint32 words). Padding rows
    (eps 0, bits 0, cov COV_PAD, zero scalars) add nothing. Port of
    graphtyper_tpu/ops/site_scoring.py:144 _apply_tier_impl."""
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


def obs_matrix(cols_np: dict, n: int) -> np.ndarray:
    """[14, n] int32 row matrix of one tier's materialized columns; the
    uint32 explain words ride as their int32 bit patterns."""
    mat = np.empty((len(OBS_FIELDS), n), dtype=np.int32)
    for i, k in enumerate(OBS_FIELDS):
        v = cols_np[k][:n]
        mat[i] = v.astype(np.uint32).view(np.int32) if k in ("bits_lo", "bits_hi") else v
    return mat


class ObsBatcher(_ref.ObsBatcher):
    """The JAX package's batcher with every tier applied on `device`.

    Only the two flush hooks change; `tiers`, `_TierBuffer`, `_eps_sum`,
    `maybe_flush`, `finalize` and `_materialize` are inherited, because the
    native caller writes into them directly."""

    def __init__(self, sites, n_samples: int, device: torch.device | str):
        super().__init__(sites, n_samples)
        self.device = torch.device(device)

    def _flush_tier_launch(self, tier: int, buf: _ref._TierBuffer):
        """Ship the tier's rows in one transfer and apply them in chunks of
        `_chunk_rows(A)` rows (bounds the [N, T] Gram term); returns the
        summed device vector, or None when the tier holds no rows."""
        cols_np, n = buf.materialize_cols()
        buf.blocks = []
        buf.cols = {k: [] for k in OBS_FIELDS}
        if n == 0:
            return None
        counters.COUNTS["scoring_rows"] += n
        A = buf.A
        n_sites = len(buf.site_ids)
        mat = torch.from_numpy(obs_matrix(cols_np, n)).to(self.device)
        chunk = _chunk_rows(A)
        total = None
        for lo in range(0, n, chunk):
            vec = apply_tier(mat[:, lo : lo + chunk], A, n_sites, self.n_samples)
            total = vec if total is None else total.add_(vec)
        return total, n_sites

    def _flush_tier_collect(self, tier: int, launched) -> None:
        """Copy the tier's summed totals to the host and fold them into the
        running totals that `finalize` materializes."""
        if launched is None:
            return
        vec, n_sites = launched
        A = self.tiers[tier].A
        self._accumulate(tier, totals_to_numpy(split_totals(vec, A, n_sites, self.n_samples)))
