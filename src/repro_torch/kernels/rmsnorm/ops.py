"""Public wrapper: fused RMSNorm over the last axis with the E2AFS-R rsqrt.

A CUDA tensor goes to ``csrc/rmsnorm.cu`` (one launch, counted), a CPU
tensor to the plain version in :mod:`.ref`.  The launch's tile (rows a
group where several rows share a warp) is the registry's
(``dispatch.resolve_block``; :data:`TILING`), and every tile gives the same
bits: each row's reduction is the same.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.hw_model import cost
from repro_torch.kernels import _build, dispatch
from repro_torch.kernels.rmsnorm.ref import ref_rmsnorm

__all__ = ["rmsnorm", "TILING"]

_DTYPE_CODE = {torch.bfloat16: 1, torch.float32: 2}
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def _geometry(args) -> dict:
    """The roofline's geometry (it narrows a sweep): x's rows, ``block[0]``
    of them a group; the kernel stages no tile."""
    x = args[0]
    d = int(x.shape[-1])
    rows = x.numel() // max(d, 1)
    return {"rows": max(rows, 1), "row_elems": max(d, 1), "ops_per_elem": cost("e2afs")["depth"],
            "streams": 2, "staged": False}


# rows a group: (0,), the default, is csrc/rmsnorm.cu's own choice from the
# card's SM count (4 where one a group would still give eight blocks an SM,
# prefill, else 1), the launch it made before its tile became an argument
TILING = dispatch.TilingSpec(default=(0,), candidates=((0,), (1,), (2,), (4,)),
                             geometry=_geometry)


def _run(x, scale, y, eps, block) -> None:
    """One launch with tile ``block`` (rows a group); not counted."""
    fn = _build.function("rmsnorm", "rmsnorm_launch", _ARGTYPES)
    rows = x.numel() // x.shape[-1]
    with torch.cuda.device(x.device):
        fn(x.data_ptr(), scale.data_ptr(), y.data_ptr(), rows, x.shape[-1], eps,
           _DTYPE_CODE[x.dtype], block[0], torch.cuda.current_stream(x.device).cuda_stream)


def _sweep_run(x, scale, y, eps):
    """What a sweep times: a launch with a given tile."""
    return lambda block: _run(x, scale, y, eps, block)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6, block=None,
            tune=None) -> torch.Tensor:
    """x: (..., d) bfloat16 or float32; scale: (d,) in x's dtype.  ``block``:
    a tile of :data:`TILING` (None resolves one), ``tune`` as
    ``dispatch.resolve_block``'s."""
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
    if dispatch.is_fake(x):  # the dry run: the output and the count, no library
        dispatch.count_launch("rmsnorm", reads=(x, scale), writes=(y,))
        return y
    if block is None:
        block = dispatch.resolve_block("rmsnorm", (x, scale), _sweep_run, (x, scale, y, eps),
                                       tune=tune)
    _run(x, scale, y, eps, block)
    dispatch.count_launch("rmsnorm", reads=(x, scale), writes=(y,), block=block)
    return y


dispatch.register(dispatch.KernelSpec(name="rmsnorm", reference=ref_rmsnorm, kernel=rmsnorm,
                                      tiling=TILING))
