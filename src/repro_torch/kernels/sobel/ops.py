"""Public wrapper: Sobel magnitude of an (H, W) image of any size >= 3 x 3.

A CUDA tensor goes to ``csrc/sobel.cu`` (one launch, counted), a CPU tensor
to the plain version in :mod:`.ref`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, dispatch
from repro_torch.kernels.sobel.ref import ref_sobel

__all__ = ["sobel_magnitude"]

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


@functools.cache
def _max_rows() -> int:
    """The largest image height the grid of csrc/sobel.cu takes."""
    return _build.constant("sobel", "sobel_max_rows")


def sobel_magnitude(img: torch.Tensor) -> torch.Tensor:
    """img: (H, W) float32.  Returns the (H-2, W-2) E2AFS gradient magnitude."""
    if not dispatch.use_kernel(img):
        return ref_sobel(img.to(torch.float32))
    if img.dim() != 2 or img.shape[0] < 3 or img.shape[1] < 3:
        raise ValueError(f"sobel kernel takes an (H, W) image with H, W >= 3, "
                         f"got {tuple(img.shape)}")
    if img.dtype != torch.float32:
        raise ValueError(f"sobel kernel takes float32, got {img.dtype}")
    if not img.is_contiguous():
        raise ValueError("sobel kernel needs a contiguous image")
    h, w = img.shape
    if h > _max_rows() or h * w >= 2**31:
        raise ValueError(f"sobel kernel takes at most {_max_rows()} rows and 2^31 pixels, "
                         f"got {h} x {w}")
    out = torch.empty((h - 2, w - 2), dtype=torch.float32, device=img.device)
    fn = _build.function("sobel", "sobel_launch", _ARGTYPES)
    with torch.cuda.device(img.device):
        fn(img.data_ptr(), out.data_ptr(), h, w, torch.cuda.current_stream(img.device).cuda_stream)
    dispatch.count_launch("sobel")
    return out
