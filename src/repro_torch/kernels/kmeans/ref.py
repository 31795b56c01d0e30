"""Plain PyTorch version of the K-means assignment kernel: the broadcast path
of the reference's ``ref_kmeans_assign``.

It materialises the (N, K, 3) difference tensor and the (N, K) one-hot that
the kernel exists to avoid.  d2 is written out as ``d0*d0 + d1*d1 + d2*d2``,
left to right, the order the CUDA kernel rounds in, so the two give the
same distances and assignments; the reference's three-term sum gives the
same assignments too.  Leading batch dimensions broadcast: px (..., N, 3)
against cent (..., K, 3).
"""
from __future__ import annotations

import torch

from repro_torch.core import get_unit

__all__ = ["ref_kmeans_assign"]


def ref_kmeans_assign(px: torch.Tensor, cent: torch.Tensor, *, sqrt_unit: str = "e2afs"):
    """px: (..., N, 3); cent: (..., K, 3).  Returns (assign (..., N) int32,
    sums (..., K, 3) float32, counts (..., K) float32): one Lloyd
    iteration's statistics."""
    unit = get_unit(sqrt_unit)
    px = px.to(torch.float32)
    cent = cent.to(torch.float32)
    d = px[..., :, None, :] - cent[..., None, :, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    dist = unit.sqrt(torch.clamp(d2, min=1e-9))
    assign = torch.argmin(dist, dim=-1).to(torch.int32)
    onehot = torch.nn.functional.one_hot(assign.long(), cent.shape[-2]).to(torch.float32)
    return assign, onehot.transpose(-1, -2) @ px, onehot.sum(-2)
