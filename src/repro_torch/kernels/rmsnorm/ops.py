"""Public wrapper: fused RMSNorm over the last axis with the E2AFS-R rsqrt.

A CUDA tensor goes to ``csrc/rmsnorm.cu`` (one launch, counted), a CPU
tensor to the plain version in :mod:`.ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, dispatch
from repro_torch.kernels.rmsnorm.ref import ref_rmsnorm

__all__ = ["rmsnorm"]

_DTYPE_CODE = {torch.bfloat16: 1, torch.float32: 2}
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_float, ctypes.c_int, ctypes.c_void_p)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d) bfloat16 or float32; scale: (d,) in x's dtype."""
    if not dispatch.use_kernel(x, scale):
        return ref_rmsnorm(x, scale, eps=eps)
    d = x.shape[-1]
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"rmsnorm kernel takes bfloat16/float32, got {x.dtype}")
    if scale.dtype != x.dtype or tuple(scale.shape) != (d,):
        raise ValueError(f"scale must be ({d},) {x.dtype}, got {tuple(scale.shape)} {scale.dtype}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm kernel needs contiguous x and scale")
    y = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return y
    fn = _build.function("rmsnorm", "rmsnorm_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        fn(x.data_ptr(), scale.data_ptr(), y.data_ptr(), rows, d, eps, _DTYPE_CODE[x.dtype],
           torch.cuda.current_stream(x.device).cuda_stream)
    dispatch.count_launch("rmsnorm")
    return y
