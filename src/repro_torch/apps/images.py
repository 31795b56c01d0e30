"""Procedural stand-ins for the paper's four 8-bit grayscale test images
(numpy copy of ``repro.apps.images``; the same arrays).

"peppers / boat / house / barbara" are generated with matching statistical
character (smooth blobs / mixed shapes / rectilinear structures /
high-frequency stripes, barbara's signature), deterministically.  The
PSNR/SSIM comparison is approximate against exact on the same image, so the
conclusions track the paper's."""
from __future__ import annotations

import numpy as np

__all__ = ["test_image", "IMAGE_NAMES", "rgb_test_image"]

IMAGE_NAMES = ("peppers", "boat", "house", "barbara")
_SIZE = 256


def _grid(n=_SIZE):
    y, x = np.mgrid[0:n, 0:n].astype(np.float64) / n
    return x, y


def _smooth_noise(rng, n=_SIZE, octaves=4):
    img = np.zeros((n, n))
    for o in range(octaves):
        k = min(2 ** (o + 2), n)
        coarse = rng.rand(k, k)
        reps = -(-n // k)  # ceil; crop below handles non-multiples
        img += np.kron(coarse, np.ones((reps, reps)))[:n, :n] / (o + 1)
    return img


def test_image(name: str, n: int = _SIZE) -> np.ndarray:
    """Returns (n, n) float64 in [0, 255]."""
    x, y = _grid(n)
    rng = np.random.RandomState(sum(map(ord, name)))
    if name == "peppers":  # smooth organic blobs
        img = np.zeros((n, n))
        for _ in range(14):
            cx, cy, r = rng.rand(), rng.rand(), 0.08 + 0.18 * rng.rand()
            blob = np.exp(-(((x - cx) ** 2 + (y - cy) ** 2) / r**2))
            img += blob * (0.3 + 0.7 * rng.rand())
        img += 0.15 * _smooth_noise(rng, n)
    elif name == "boat":  # diagonal edges + sky gradient + texture
        img = 0.7 - 0.4 * y
        img += 0.35 * ((y - 0.35 - 0.25 * np.abs(x - 0.5)) > 0)  # hull triangle
        img -= 0.3 * ((np.abs(x - 0.5) < 0.02) & (y < 0.6))  # mast
        img += 0.1 * _smooth_noise(rng, n) + 0.05 * np.sin(40 * np.pi * y) * (y > 0.7)
    elif name == "house":  # rectilinear blocks + roof
        img = 0.8 - 0.3 * y
        img -= 0.45 * ((x > 0.25) & (x < 0.75) & (y > 0.45) & (y < 0.9))
        img += 0.5 * ((y > 0.25 + np.abs(x - 0.5)) & (y < 0.45))  # roof
        for wx in (0.35, 0.6):
            img += 0.35 * ((np.abs(x - wx) < 0.05) & (np.abs(y - 0.62) < 0.07))
        img += 0.05 * _smooth_noise(rng, n)
    elif name == "barbara":  # the signature high-frequency stripes
        img = 0.5 + 0.25 * np.sin(60 * np.pi * (x + 0.5 * y))
        img = np.where(
            (x - 0.5) ** 2 + (y - 0.5) ** 2 < 0.1,
            0.5 + 0.25 * np.sin(80 * np.pi * (y - 0.3 * x)),
            img,
        )
        img += 0.2 * _smooth_noise(rng, n) - 0.1
    else:
        raise ValueError(f"unknown image {name!r}; have {IMAGE_NAMES}")
    img = (img - img.min()) / (img.max() - img.min() + 1e-12)
    return (img * 255.0).astype(np.float64)


def rgb_test_image(name: str = "peppers", n: int = _SIZE) -> np.ndarray:
    """(n, n, 3) RGB in [0,255] for the K-means quantization app."""
    base = test_image(name, n) / 255.0
    x, y = _grid(n)
    r = base
    g = 0.6 * base + 0.4 * (1 - x)
    b = 0.5 * base + 0.5 * y
    return (np.stack([r, g, b], axis=-1) * 255.0).astype(np.float64)
