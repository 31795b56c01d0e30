"""Plain PyTorch version of the E2AFS sqrt/rsqrt kernel (the core datapath)."""
from __future__ import annotations

import torch

from repro_torch.core.e2afs import e2afs_rsqrt, e2afs_sqrt

__all__ = ["ref_sqrt", "ref_rsqrt"]


def ref_sqrt(x: torch.Tensor) -> torch.Tensor:
    return e2afs_sqrt(x)


def ref_rsqrt(x: torch.Tensor) -> torch.Tensor:
    return e2afs_rsqrt(x)
