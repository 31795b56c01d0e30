"""Public wrapper: one fused AdamW-E2AFS step over a parameter tensor of any
shape, IN PLACE on p, m and v.

A CUDA tensor goes to ``csrc/adam.cu`` (one launch, counted), a CPU tensor
to the plain version in :mod:`.ref`, whose result is copied back into p, m
and v.  ``sched = [lr, b1c, b2c]`` is a (3,) float32 tensor on the
operands' device, so nothing is read back to the host between steps.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, dispatch
from repro_torch.kernels.adam.ref import ref_adam_update

__all__ = ["adam_update"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
             ctypes.c_float, ctypes.c_void_p)


@torch.no_grad()
def adam_update(p, g, m, v, sched, *, b1=0.9, b2=0.95, eps=1e-8, wd=0.1):
    """p, g: float32 or bfloat16; m, v: float32; all of one shape.  Updates
    p, m and v in place and returns them."""
    if not dispatch.use_kernel(p, g, m, v, sched):
        new_p, new_m, new_v = ref_adam_update(p, g, m, v, sched, b1=b1, b2=b2, eps=eps, wd=wd)
        p.copy_(new_p)
        m.copy_(new_m)
        v.copy_(new_v)
        return p, m, v
    if p.dtype not in _DTYPE_CODE or g.dtype not in _DTYPE_CODE:
        raise ValueError(f"adam kernel takes p and g in float32 or bfloat16, got {p.dtype}, "
                         f"{g.dtype}")
    if m.dtype != torch.float32 or v.dtype != torch.float32 or sched.dtype != torch.float32:
        raise ValueError(f"adam kernel takes float32 m, v and sched, got {m.dtype}, {v.dtype}, "
                         f"{sched.dtype}")
    if not all(t.shape == p.shape for t in (g, m, v)) or tuple(sched.shape) != (3,):
        raise ValueError(f"adam kernel takes p, g, m, v of one shape and sched (3,), got "
                         f"{[tuple(t.shape) for t in (p, g, m, v, sched)]}")
    if not all(t.is_contiguous() for t in (p, g, m, v, sched)):
        raise ValueError("adam kernel needs contiguous operands")
    if p.numel() == 0:
        return p, m, v
    fn = _build.function("adam", "adam_launch", _ARGTYPES)
    with torch.cuda.device(p.device):
        # 1 - b1 and 1 - b2 in double, rounded once to float32 by ctypes, as
        # the plain version's Python scalars are (1.0f - 0.9f is not 0.1f)
        fn(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), sched.data_ptr(), p.numel(),
           _DTYPE_CODE[p.dtype], _DTYPE_CODE[g.dtype], b1, 1 - b1, b2, 1 - b2, eps, wd,
           torch.cuda.current_stream(p.device).cuda_stream)
    dispatch.count_launch("adam")
    return p, m, v
