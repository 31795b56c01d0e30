"""Public wrapper: one fused K-means (Lloyd) iteration over one image or a
stack of them.

A CUDA tensor goes to ``csrc/kmeans_assign.cu`` (one counted launch of its
assignment and reduction kernels), a CPU tensor to the plain version in
:mod:`.ref`.  The registry holds one tile, today's launch of 2048 pixels a
block: the tile sets the order of the per-tile partial sums
(``csrc/kmeans_assign.cu``), so another would change the sums' bits.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, dispatch
from repro_torch.kernels.kmeans.ref import ref_kmeans_assign

__all__ = ["kmeans_assign", "TILING"]

_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p)


@functools.cache
def _limits():
    """(pixels per block, largest K) of csrc/kmeans_assign.cu."""
    return (_build.constant("kmeans_assign", "kmeans_assign_tile"),
            _build.constant("kmeans_assign", "kmeans_assign_max_k"))


# pixels a block, the value of csrc/kmeans_assign.cu's kmeans_assign_tile()
TILING = dispatch.TilingSpec(default=(2048,), candidates=((2048,),))


def kmeans_assign(px: torch.Tensor, cent: torch.Tensor, *, block=None, tune=None):
    """px: (N, 3) or (B, N, 3) float32; cent: (K, 3) or (B, K, 3) float32.
    Returns (assign (..., N) int32, sums (..., K, 3) float32, counts (..., K)
    float32) for one Lloyd iteration with the E2AFS distance.  ``block``:
    None or :data:`TILING`'s one tile; ``tune`` has nothing to choose."""
    if block is not None and tuple(block) != TILING.default:
        raise ValueError(f"kmeans_assign takes only the tile {TILING.default}, got {block}")
    if not dispatch.use_kernel(px, cent):
        return ref_kmeans_assign(px, cent)
    batched = px.dim() == 3
    if px.dim() not in (2, 3) or cent.dim() != px.dim() or px.shape[-1] != 3 or cent.shape[-1] != 3:
        raise ValueError(f"kmeans kernel takes px (N, 3) or (B, N, 3) with cent (K, 3) or "
                         f"(B, K, 3); got {tuple(px.shape)} and {tuple(cent.shape)}")
    if batched and px.shape[0] != cent.shape[0]:
        raise ValueError(f"batch sizes differ: {px.shape[0]} and {cent.shape[0]}")
    if px.dtype != torch.float32 or cent.dtype != torch.float32:
        raise ValueError(f"kmeans kernel takes float32, got {px.dtype} and {cent.dtype}")
    if not (px.is_contiguous() and cent.is_contiguous()):
        raise ValueError("kmeans kernel needs contiguous px and cent")
    n, k = px.shape[-2], cent.shape[-2]
    b = px.shape[0] if batched else 1
    dev = px.device
    if dispatch.is_fake(px):  # the dry run: the outputs and the count, no library
        assign = torch.empty((b, n), dtype=torch.int32, device=dev)
        sums = torch.empty((b, k, 3), dtype=torch.float32, device=dev)
        counts = torch.empty((b, k), dtype=torch.float32, device=dev)
        dispatch.count_launch("kmeans_assign", reads=(px, cent), writes=(assign, sums, counts))
        return (assign, sums, counts) if batched else (assign[0], sums[0], counts[0])
    tile, max_k = _limits()
    if (tile,) != TILING.default:
        raise RuntimeError(f"csrc/kmeans_assign.cu's tile {tile} is not the registry's "
                           f"{TILING.default}")
    if not 1 <= k <= max_k:
        raise ValueError(f"kmeans kernel takes 1 <= K <= {max_k} centroids, got {k}")
    if n < 1 or not 1 <= b <= 65535:
        raise ValueError(f"kmeans kernel takes N >= 1 pixels and 1 <= B <= 65535 images, "
                         f"got {n}, {b}")
    assign = torch.empty((b, n), dtype=torch.int32, device=dev)
    partial = torch.empty((b, -(-n // tile), k, 4), dtype=torch.float32, device=dev)
    sums = torch.empty((b, k, 3), dtype=torch.float32, device=dev)
    counts = torch.empty((b, k), dtype=torch.float32, device=dev)
    fn = _build.function("kmeans_assign", "kmeans_assign_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        fn(px.data_ptr(), cent.data_ptr(), assign.data_ptr(), partial.data_ptr(), sums.data_ptr(),
           counts.data_ptr(), n, k, b, torch.cuda.current_stream(dev).cuda_stream)
    dispatch.count_launch("kmeans_assign", reads=(px, cent), writes=(assign, sums, counts),
                          block=TILING.default)
    if batched:
        return assign, sums, counts
    return assign[0], sums[0], counts[0]


dispatch.register(dispatch.KernelSpec(name="kmeans_assign", reference=ref_kmeans_assign,
                                      kernel=kmeans_assign, tiling=TILING))
