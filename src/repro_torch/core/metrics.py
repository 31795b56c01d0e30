"""Input domains for holding a datapath over a format (the grid part of
``repro.core.metrics``)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.numerics import FP32, FloatFormat

__all__ = ["sampled_normal_values"]


def sampled_normal_values(fmt: FloatFormat = FP32, *, mans_per_exp: int = 256) -> torch.Tensor:
    """A deterministic stratified grid of positive normals: EVERY normal
    exponent crossed with ``mans_per_exp`` evenly spaced mantissa codes
    (endpoints included).  For fp32 at the default density that is
    254 x 256 ~ 65k points.  No RNG.  Returns a CPU tensor of ``fmt.dtype``."""
    mans_per_exp = int(mans_per_exp)
    if mans_per_exp < 1:
        raise ValueError(f"mans_per_exp must be >= 1, got {mans_per_exp}")
    exps = np.arange(1, fmt.exp_mask, dtype=np.uint64)  # normals: 1..emax-1
    n = min(mans_per_exp, fmt.one)
    mans = np.unique(np.linspace(0, fmt.one - 1, n).round().astype(np.uint64))
    bits = ((exps[:, None] << fmt.man_bits) | mans[None, :]).reshape(-1)
    ints = bits.astype(np.uint32 if fmt.total_bits == 32 else np.uint16)
    signed = ints.view(np.int32 if fmt.total_bits == 32 else np.int16)
    return torch.from_numpy(signed.copy()).view(fmt.dtype)
