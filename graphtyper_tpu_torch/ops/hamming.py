"""Batched read-against-haplotype mismatch counts as an int8 matrix product.

Port of graphtyper_tpu/ops/hamming.py: reads [R, L] and haplotype windows
[H, L] are one-hot encoded over A/C/G/T ([R, L*4], [H, L*4] int8), their
product counts the matching bases, and the product of the definite-base
masks counts the positions both sides can compare; mismatches are the
difference. N (code 4) and padding (5) one-hot to zero, so they never count.

The products run through `torch._int_mm` (int8 in, int32 out; the int8
tensor cores on the card). Its CUDA form takes only M > 16 and K, N
multiples of 8, so `_dot_int8` pads the operands with zero rows and
columns, which add nothing to any count, and slices the result.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["int_mm_operands", "mismatch_matrix", "one_hot_acgt"]


def one_hot_acgt(codes: torch.Tensor) -> torch.Tensor:
    """[..., L] uint8 codes -> [..., L, 4] int8; codes >= 4 (N, pad) are
    all zero."""
    return (codes[..., None].to(torch.int64) == torch.arange(4, device=codes.device)).to(torch.int8)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int_mm_operands(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 a [M, K] and b [N, K] zero-padded to `torch._int_mm`'s CUDA
    shapes: ([Mp, Kp], the column-major [Kp, Np] view of b)."""
    M, K = a.shape
    N = b.shape[0]
    Mp, Kp, Np = max(_round_up(M, 8), 24), _round_up(max(K, 1), 8), _round_up(max(N, 1), 8)
    return F.pad(a, (0, Kp - K, 0, Mp - M)), F.pad(b, (0, Kp - K, 0, Np - N)).t()


def _dot_int8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] . b [N, K]^T -> [M, N] int32 (graphtyper_tpu/ops/hamming.py:31)."""
    return torch._int_mm(*int_mm_operands(a, b))[: a.shape[0], : b.shape[0]]


def mismatch_matrix(read_codes: torch.Tensor, hap_codes: torch.Tensor) -> torch.Tensor:
    """Mismatch counts [R, H] int32 between reads [R, L] and haplotypes
    [H, L] (uint8 codes): a position counts iff both sides are definite
    bases (A/C/G/T) and differ. Port of graphtyper_tpu/ops/hamming.py:36."""
    R, H = read_codes.shape[0], hap_codes.shape[0]
    matches = _dot_int8(one_hot_acgt(read_codes).reshape(R, -1), one_hot_acgt(hap_codes).reshape(H, -1))
    overlap = _dot_int8((read_codes < 4).to(torch.int8), (hap_codes < 4).to(torch.int8))
    return overlap - matches
