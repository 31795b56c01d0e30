"""RMSNorm with a pluggable sqrt unit (torch port of
``repro.layers.norms.rmsnorm``).

``x * rsqrt(ms + eps)`` is computed through the configured SqrtUnit; the
reduction is float32 whatever the activation dtype.  ``fused=True`` routes
the whole norm through the RMSNorm kernel (the CUDA kernel for a CUDA
tensor, its plain version for a CPU tensor); only "e2afs" has a fused
datapath.  The fused and unfused routes compute the same function: in the
reference they are bit-identical, and here only the order of the float32
sum differs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.ref import ref_rmsnorm

__all__ = ["rmsnorm"]


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, *, sqrt_unit: str = "exact",
            eps: float = 1e-6, fused: bool = False) -> torch.Tensor:
    """Normalise the last axis of ``x``; ``scale`` (d,) is applied as
    ``1 + scale`` (zero-initialised, gemma convention).  Scale first, as in
    the reference."""
    if fused:
        if sqrt_unit != "e2afs":
            raise ValueError(f"fused rmsnorm requires sqrt_unit='e2afs', got {sqrt_unit!r}")
        from repro_torch.kernels.rmsnorm.ops import rmsnorm as rmsnorm_kernel

        return rmsnorm_kernel(x, scale.to(x.dtype), eps=eps)
    return ref_rmsnorm(x, scale, sqrt_unit=sqrt_unit, eps=eps)
