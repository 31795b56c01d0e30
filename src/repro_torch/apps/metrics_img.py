"""PSNR and SSIM in float64 numpy (copy of ``repro.apps.metrics_img``).

SSIM follows Wang et al. 2004 with the standard 11x11 Gaussian window
(sigma 1.5), K1=0.01, K2=0.03, L=255."""
from __future__ import annotations

import numpy as np

__all__ = ["psnr", "ssim"]


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(peak**2 / mse)


def _gaussian_kernel(size=11, sigma=1.5):
    r = np.arange(size) - size // 2
    k = np.exp(-(r**2) / (2 * sigma**2))
    k /= k.sum()
    return k


def _filt2(img, k):
    """Separable valid-mode 2D filtering."""
    pad = len(k) // 2
    out = np.apply_along_axis(lambda row: np.convolve(row, k, mode="same"), 1, img)
    out = np.apply_along_axis(lambda col: np.convolve(col, k, mode="same"), 0, out)
    return out[pad:-pad, pad:-pad]


def ssim(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    k = _gaussian_kernel()
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2
    mu_a = _filt2(a, k)
    mu_b = _filt2(b, k)
    s_aa = _filt2(a * a, k) - mu_a**2
    s_bb = _filt2(b * b, k) - mu_b**2
    s_ab = _filt2(a * b, k) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * s_ab + c2)
    den = (mu_a**2 + mu_b**2 + c1) * (s_aa + s_bb + c2)
    return float(np.mean(num / den))
