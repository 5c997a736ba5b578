"""Device resolution: one explicit torch.device, chosen at the entry point
and passed down as an argument. Replaces the two `_tpu_available` probes of
the JAX package (ops/sw.py:58, ops/discovery_pileup.py:164); there is no
silent fall back to the CPU."""

from __future__ import annotations

import torch


def resolve_device(name: str | torch.device = "cuda") -> torch.device:
    """torch.device for `name`; raises RuntimeError when CUDA is asked for
    and this process has no usable GPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is False "
            "(no GPU, or PyTorch built without CUDA); pass --device cpu to run "
            "the plain PyTorch versions on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda' or 'cpu'")
    return dev
