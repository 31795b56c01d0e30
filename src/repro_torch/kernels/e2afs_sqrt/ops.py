"""Public wrappers: elementwise E2AFS sqrt/rsqrt of a tensor of any shape.

A CUDA tensor goes to ``csrc/e2afs_sqrt.cu`` (one launch, counted), a CPU
tensor to the plain version in :mod:`.ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, dispatch
from repro_torch.kernels.e2afs_sqrt.ref import ref_rsqrt, ref_sqrt

__all__ = ["sqrt", "rsqrt", "sqrt_normal_mismatches"]

_DTYPE_CODE = {torch.float16: 0, torch.bfloat16: 1, torch.float32: 2}
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p)


def _launch(x: torch.Tensor, *, rsqrt: bool) -> torch.Tensor:
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"e2afs kernel takes float16/bfloat16/float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("e2afs kernel needs a contiguous tensor")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    fn = _build.function("e2afs_sqrt", "e2afs_sqrt_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        fn(x.data_ptr(), y.data_ptr(), x.numel(), _DTYPE_CODE[x.dtype], int(rsqrt),
           torch.cuda.current_stream(x.device).cuda_stream)
    dispatch.count_launch("e2afs_rsqrt" if rsqrt else "e2afs_sqrt")
    return y


def sqrt(x: torch.Tensor) -> torch.Tensor:
    if not dispatch.use_kernel(x):
        return ref_sqrt(x)
    return _launch(x, rsqrt=False)


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    if not dispatch.use_kernel(x):
        return ref_rsqrt(x)
    return _launch(x, rsqrt=True)


def sqrt_normal_mismatches(first: int, last: int, device) -> int:
    """The number of float32 bit patterns in [first, last) on which the lean
    E2AFS sqrt of the Sobel and K-means kernels (``csrc/e2afs.cuh``,
    ``sqrt_normal_f32``) differs from the general one (``sqrt_positive_f32``),
    counted on the card.  A check of the CUDA datapath: no plain version, no
    launch count."""
    if not 0 <= first <= last < 2**32:
        raise ValueError(f"patterns [{first}, {last}) are not float32 bit patterns")
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the check runs on the card, got {device}")
    out = torch.zeros((), dtype=torch.int64, device=device)
    fn = _build.function("e2afs_sqrt", "e2afs_sqrt_normal_check",
                         (ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p))
    with torch.cuda.device(device):
        fn(first, last, out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    return int(out)
