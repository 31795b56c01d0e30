"""Plain PyTorch version of the fused RMSNorm kernel."""
from __future__ import annotations

import torch

from repro_torch.core import get_unit

__all__ = ["ref_rmsnorm"]


def ref_rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, sqrt_unit: str = "e2afs",
                eps: float = 1e-6) -> torch.Tensor:
    """fp32 mean of x^2 (a sum divided by d, as ``jnp.mean``), plus eps, the
    unit's rsqrt, ``(x * inv)`` cast to x's dtype, times ``1 + scale`` in
    x's dtype."""
    unit = get_unit(sqrt_unit)
    xf = x.float()
    ms = (xf * xf).sum(dim=-1, keepdim=True) / x.shape[-1]
    inv = unit.rsqrt(ms + eps)
    return (xf * inv).to(x.dtype) * (1.0 + scale.to(x.dtype))
