"""Paper §4.1: Sobel edge detection with approximate square rooters (torch
port of ``repro.apps.sobel``).

The gradient magnitude G = sqrt(Gx^2 + Gy^2) runs through a selected
SqrtUnit; fidelity is PSNR/SSIM of the approximate edge map against the
exact-sqrt edge map (Table 4's protocol).  Numpy in, float64 numpy out; the
work runs on ``device`` (the card unless the caller asks for the CPU).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.apps.metrics_img import psnr, ssim
from repro_torch.device import resolve_device
from repro_torch.kernels.sobel.ref import ref_sobel

__all__ = ["edge_map", "evaluate_units"]


def edge_map(img: np.ndarray, sqrt_unit: str, *, use_kernel: bool = False,
             device=None) -> np.ndarray:
    """(H, W) [0,255] -> normalized edge map in [0,255].  ``use_kernel``
    routes through the fused Sobel kernel (``sqrt_unit="e2afs"`` only)."""
    x = torch.as_tensor(np.ascontiguousarray(img)).to(resolve_device(device), torch.float32)
    if use_kernel:
        if sqrt_unit != "e2afs":
            raise ValueError(
                f"use_kernel=True requires sqrt_unit='e2afs' (the fused Sobel "
                f"kernel embeds the E2AFS datapath), got {sqrt_unit!r}"
            )
        from repro_torch.kernels.sobel.ops import sobel_magnitude

        mag = sobel_magnitude(x)
    else:
        mag = ref_sobel(x, sqrt_unit=sqrt_unit)
    mag = mag.cpu().numpy().astype(np.float64)
    return np.clip(mag / (4.0 * 255.0) * 255.0, 0, 255)  # max |G| = 4*2*255/2


def evaluate_units(img: np.ndarray, units=("esas", "cwaha4", "cwaha8", "e2afs"), *,
                   device=None):
    exact = edge_map(img, "exact", device=device)
    out = {}
    for u in units:
        approx = edge_map(img, u, device=device)
        out[u] = {"psnr": psnr(exact, approx), "ssim": ssim(exact, approx)}
    return out
