"""Exact sqrt/rsqrt behind the SqrtUnit interface (the paper's reference)."""
from __future__ import annotations

import torch

__all__ = ["exact_sqrt", "exact_rsqrt"]


def exact_sqrt(x: torch.Tensor, *, ftz: bool = True) -> torch.Tensor:
    del ftz
    return torch.sqrt(x)


def exact_rsqrt(x: torch.Tensor, *, ftz: bool = True) -> torch.Tensor:
    del ftz
    return torch.rsqrt(x)
