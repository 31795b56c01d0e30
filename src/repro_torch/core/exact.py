"""Exact sqrt/rsqrt behind the SqrtUnit interface (the paper's reference)."""
from __future__ import annotations

import torch

__all__ = ["exact_sqrt", "exact_rsqrt"]


def exact_sqrt(x: torch.Tensor, *, ftz: bool = True) -> torch.Tensor:
    """Correctly rounded IEEE sqrt on every device.  PyTorch's vectorised
    float32 sqrt on the CPU is not (it is off by one ulp for about 0.7% of
    inputs), so a CPU float32 tensor goes through float64: a float64 sqrt
    rounded to float32 is correctly rounded (53 >= 2 * 24 + 2 bits)."""
    del ftz
    if x.dtype == torch.float32 and x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def exact_rsqrt(x: torch.Tensor, *, ftz: bool = True) -> torch.Tensor:
    del ftz
    return torch.rsqrt(x)
