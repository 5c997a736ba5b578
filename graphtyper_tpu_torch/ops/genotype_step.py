"""The fused genotyping step on a torch device.

Port of graphtyper_tpu/ops/genotype_step.py:

    reads [R, L] --int8 one-hot product--> mismatches [R, H]
    best-hit mask -> explains bitmap B [R, A]
    B --Gram product--> PL-triangle update [A, A]

The mismatch counts come from `ops/hamming.py mismatch_matrix`
(`torch._int_mm`), the Gram update from `ops/likelihood.py
score_update_dense`; the float products stay float32, so with integer
eps every output is an integer below 2^24 and equal on every device. The
sharded form over a mesh of devices is parallel/mesh.py
`sharded_genotype_step`.
"""

from __future__ import annotations

import torch

from graphtyper_tpu_torch.ops.hamming import mismatch_matrix
from graphtyper_tpu_torch.ops.likelihood import score_update_dense

__all__ = ["genotype_forward"]


def genotype_forward(
    read_codes: torch.Tensor,  # [R, L] uint8 (A0..T3, N=4, pad=5)
    hap_codes: torch.Tensor,  # [H, L] uint8 haplotype windows
    hap_allele: torch.Tensor,  # [H, A] 0/1: window h uses allele a
    eps: torch.Tensor,  # [R] float epsilon exponents
    max_mismatches: int = 10,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(score_delta [A, A], explains [R, A]), both float32, on the inputs'
    device (graphtyper_tpu/ops/genotype_step.py:26)."""
    mm = mismatch_matrix(read_codes, hap_codes)  # [R, H]
    best = mm.min(dim=1, keepdim=True).values
    hit = (mm == best) & (mm <= max_mismatches)  # best-path windows
    B = ((hit.to(torch.float32) @ hap_allele.to(torch.float32)) > 0).to(torch.float32)
    return score_update_dense(B, eps), B
