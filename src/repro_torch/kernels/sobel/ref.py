"""Plain PyTorch version of the Sobel kernel (torch copy of the reference's
``ref_sobel``, paper §4.1), bit-identical to it."""
from __future__ import annotations

import torch

from repro_torch.core import get_unit

__all__ = ["ref_sobel", "KX", "KY"]

KX = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
KY = ((-1.0, -2.0, -1.0), (0.0, 0.0, 0.0), (1.0, 2.0, 1.0))


def ref_sobel(img: torch.Tensor, *, sqrt_unit: str = "e2afs") -> torch.Tensor:
    """img: (H, W) float32 in [0, 255].  Returns the gradient magnitude
    (H-2, W-2): the 9-tap multiply-accumulate in (di, dj) order, zero taps
    included, then ``sqrt(max(gx^2 + gy^2, 1e-12))`` through the unit."""
    unit = get_unit(sqrt_unit)
    h, w = img.shape
    gx = torch.zeros((h - 2, w - 2), dtype=torch.float32, device=img.device)
    gy = torch.zeros_like(gx)
    for di in range(3):
        for dj in range(3):
            patch = img[di : di + h - 2, dj : dj + w - 2]
            gx = gx + KX[di][dj] * patch
            gy = gy + KY[di][dj] * patch
    mag2 = gx * gx + gy * gy
    return unit.sqrt(torch.clamp(mag2, min=1e-12))
