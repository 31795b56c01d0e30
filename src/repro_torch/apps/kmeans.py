"""Paper §4.2: K-means colour quantisation (K=20) with approximate sqrt
(torch port of ``repro.apps.kmeans``).

Euclidean distances in Lloyd's algorithm run through the selected SqrtUnit.
Because the approximate sqrt is only piecewise-monotone, nearest-centroid
assignments can flip near decision boundaries: the error tolerance being
demonstrated.  Fidelity is PSNR/SSIM of the quantised image against the
original.

Two execution paths:

* ``fused=False``: the broadcast path (``ref_kmeans_assign``), which
  materialises an (N, K, 3) difference tensor and an (N, K) one-hot every
  iteration;
* ``fused=True``: every iteration is one call of the ``kmeans_assign``
  kernel (``repro_torch.kernels.kmeans``), which keeps distances, the E2AFS
  sqrt, the argmin and the per-centroid sums on chip.  It requires
  ``sqrt_unit="e2afs"``.

``kmeans_quantize_batch`` runs a stack of images with one kernel call per
Lloyd iteration over the whole (B, N, 3) stack.

Starting centroids are drawn with a CPU ``torch.Generator`` seeded from
``seed``, so a run picks the same ones on the card and on the CPU.  They are
not the reference's: ``jax.random.choice`` gives other pixels for the same
seed.  Parity with the reference is held at :func:`lloyd` from the same
starting centroids.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.apps.metrics_img import psnr, ssim
from repro_torch.device import resolve_device
from repro_torch.kernels.kmeans.ops import kmeans_assign
from repro_torch.kernels.kmeans.ref import ref_kmeans_assign

__all__ = [
    "evaluate_units",
    "init_centroids",
    "kmeans_quantize",
    "kmeans_quantize_batch",
    "lloyd",
    "update_centroids",
]


def init_centroids(pix: torch.Tensor, seed: int, k: int) -> torch.Tensor:
    """k distinct pixels of ``pix`` (N, 3), chosen without replacement by a
    CPU generator seeded from ``seed``."""
    gen = torch.Generator().manual_seed(int(seed))
    idx = torch.randperm(pix.shape[0], generator=gen)[:k]
    return pix[idx.to(pix.device)]


def update_centroids(cent, sums, counts):
    """Lloyd centroid update; empty clusters keep their previous centroid."""
    counts = counts[..., None]
    return torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), cent)


def lloyd(pix, cent, *, iters: int, sqrt_unit: str = "e2afs", fused: bool = False):
    """``iters`` Lloyd iterations from ``cent``, then a final assignment.
    pix (..., N, 3) and cent (..., K, 3) float32.  Returns (centroids,
    assignments)."""
    if fused:
        if sqrt_unit != "e2afs":
            raise ValueError(f"fused K-means requires sqrt_unit='e2afs', got {sqrt_unit!r}")
        pix, cent = pix.contiguous(), cent.contiguous()

        def assign(c):
            return kmeans_assign(pix, c)
    else:
        def assign(c):
            return ref_kmeans_assign(pix, c, sqrt_unit=sqrt_unit)

    for _ in range(iters):
        _, sums, counts = assign(cent)
        cent = update_centroids(cent, sums, counts)
    return cent, assign(cent)[0]


def _quantized(cent, assign, shape):
    quant = torch.gather(cent, -2, assign.long()[..., None].expand(*assign.shape, 3))
    return quant.reshape(shape).cpu().numpy().astype(np.float64), cent.cpu().numpy()


def kmeans_quantize(
    rgb: np.ndarray, *, k: int = 20, iters: int = 12, sqrt_unit: str = "e2afs",
    seed: int = 0, fused: bool = False, device=None,
):
    """rgb: (H, W, 3) [0,255].  Returns (quantised image float64, centroids
    (k, 3) float32)."""
    rgb = np.asarray(rgb)
    pix = torch.as_tensor(rgb.reshape(-1, 3)).to(resolve_device(device), torch.float32)
    cent = init_centroids(pix, seed, k)
    cent, assign = lloyd(pix, cent, iters=iters, sqrt_unit=sqrt_unit, fused=fused)
    return _quantized(cent, assign, rgb.shape)


def kmeans_quantize_batch(
    rgbs: np.ndarray, *, k: int = 20, iters: int = 12, sqrt_unit: str = "e2afs",
    seed: int = 0, fused: bool = True, device=None,
):
    """rgbs: (B, H, W, 3) [0,255] image stack, each image quantised on its
    own, all under one Lloyd solve.  Image i starts from the centroids that
    ``kmeans_quantize(rgbs[i], seed=seed + i)`` draws.  Returns (quantised
    stack float64, centroids (B, k, 3) float32).

    Unlike :func:`kmeans_quantize`, this serving-oriented entry point
    defaults to the fused kernel path, which requires ``sqrt_unit="e2afs"``;
    pass ``fused=False`` to batch any other unit over the broadcast path.
    """
    rgbs = np.asarray(rgbs)
    b = rgbs.shape[0]
    pix = torch.as_tensor(rgbs.reshape(b, -1, 3)).to(resolve_device(device), torch.float32)
    cent = torch.stack([init_centroids(pix[i], seed + i, k) for i in range(b)])
    cent, assign = lloyd(pix, cent, iters=iters, sqrt_unit=sqrt_unit, fused=fused)
    return _quantized(cent, assign, rgbs.shape)


def evaluate_units(rgb: np.ndarray, units=("esas", "cwaha4", "cwaha8", "e2afs"), k: int = 20,
                   *, device=None):
    out = {}
    for u in units + ("exact",):
        quant, _ = kmeans_quantize(rgb, k=k, sqrt_unit=u, device=device)
        gray_q = quant.mean(-1)
        gray_o = rgb.mean(-1)
        out[u] = {"psnr": psnr(gray_o, gray_q), "ssim": ssim(gray_o, gray_q)}
    return out
