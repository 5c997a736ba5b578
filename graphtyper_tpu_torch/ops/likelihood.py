"""Batched genotype-likelihood updates as matrix products.

Port of graphtyper_tpu/ops/likelihood.py. Summed over a read batch with the
explains bitmap B [R, A] and weights eps [R], the reference's per-read PL
triangle update (haplotype.cpp:560-583) is

    delta[x, y] = u_x + u_y + W_xy,  u = B^T (eps - 1),  W = B^T diag(2 - eps) B

over the active reads (those that explain some allele). The products stay
in float32; with integer eps every sum is an integer below 2^24, so the
result is exact on any device.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["batch_explains_to_matrix", "score_update_dense", "score_update_triangle",
           "triangle_indices"]


def score_update_dense(B: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """Dense [A, A] float32 log-score delta from the explains bitmap B [R, A]
    and per-read epsilon exponents eps [R]; reads with all-zero rows add
    nothing (graphtyper_tpu/ops/likelihood.py:31)."""
    Bf = B.to(torch.float32)
    eps = eps.to(torch.float32)
    active = (Bf.sum(dim=1) > 0).to(torch.float32)
    epsf = eps * active
    u = Bf.T @ ((eps - 1.0) * active)
    W = (Bf * (2.0 - epsf)[:, None]).T @ Bf
    return u[:, None] + u[None, :] + W


def triangle_indices(num_alleles: int) -> tuple[np.ndarray, np.ndarray]:
    """x, y arrays of the flattened upper triangle, index = x + y(y+1)/2."""
    ys, xs = np.tril_indices(num_alleles)
    return xs, ys


def score_update_triangle(B: torch.Tensor, eps: torch.Tensor, num_alleles: int) -> np.ndarray:
    """Flattened int64 triangle delta in HapSample.log_score layout."""
    dense = score_update_dense(B, eps).cpu().numpy()
    xs, ys = triangle_indices(num_alleles)
    return np.rint(dense[xs, ys]).astype(np.int64)


def batch_explains_to_matrix(explains_per_read: list[set[int]], num_alleles: int) -> np.ndarray:
    """Per-read explain sets packed into a float32 bitmap [R, A]."""
    B = np.zeros((len(explains_per_read), num_alleles), dtype=np.float32)
    for r, ex in enumerate(explains_per_read):
        for a in ex:
            if a < num_alleles:
                B[r, a] = 1.0
    return B
