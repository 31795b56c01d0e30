"""Public wrapper: Sobel magnitude of an (H, W) image of any size >= 3 x 3.

A CUDA tensor goes to ``csrc/sobel.cu`` (one launch, counted), a CPU tensor
to the plain version in :mod:`.ref`.  The launch's tile (output rows down a
strip x threads a block) is the registry's (``dispatch.resolve_block``;
:data:`TILING`), and every tile gives the same bits.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, dispatch
from repro_torch.kernels.sobel.ref import ref_sobel

__all__ = ["sobel_magnitude", "TILING"]

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p)
# today's launch before the tile became an argument, and the default
_DEFAULT = (4, 128)
# 40 float and 14 integer operations an output (csrc/sobel.cu)
_OPS_PER_PIXEL = 54.0


def _geometry(args) -> dict:
    """The roofline's geometry (it narrows a sweep): the output rows,
    ``block[0]`` of them down a block's strip; the kernel stages no tile
    (csrc/sobel.cu reads its rows from device memory)."""
    img = args[0]
    h, w = int(img.shape[0]), int(img.shape[1])
    return {"rows": max(h - 2, 1), "row_elems": max(w - 2, 1), "ops_per_elem": _OPS_PER_PIXEL,
            "streams": 2, "staged": False}


# rows x threads
TILING = dispatch.TilingSpec(default=_DEFAULT,
                             candidates=((2, 512), (4, 128), (4, 256), (8, 64), (8, 128)),
                             geometry=_geometry)


@functools.cache
def _max_strips() -> int:
    """The most strips the grid of csrc/sobel.cu takes."""
    return _build.constant("sobel", "sobel_max_strips")


def _run(img, out, block) -> None:
    """One launch with tile ``block`` (rows, threads); not counted."""
    h, w = img.shape
    fn = _build.function("sobel", "sobel_launch", _ARGTYPES)
    with torch.cuda.device(img.device):
        fn(img.data_ptr(), out.data_ptr(), h, w, block[0], block[1],
           torch.cuda.current_stream(img.device).cuda_stream)


def _sweep_run(img, out):
    """What a sweep times: a launch with a given tile."""
    return lambda block: _run(img, out, block)


def sobel_magnitude(img: torch.Tensor, *, block=None, tune=None) -> torch.Tensor:
    """img: (H, W) float32.  Returns the (H-2, W-2) E2AFS gradient magnitude.
    ``block``: a tile of :data:`TILING` (None resolves one), ``tune`` as
    ``dispatch.resolve_block``'s."""
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
    out = torch.empty((h - 2, w - 2), dtype=torch.float32, device=img.device)
    if dispatch.is_fake(img):  # the dry run: the output and the count, no library
        dispatch.count_launch("sobel", reads=(img,), writes=(out,))
        return out
    if block is None:
        block = dispatch.resolve_block("sobel", (img,), _sweep_run, (img, out), tune=tune)
    if h - 2 > _max_strips() * block[0] or h * w >= 2**31:
        raise ValueError(f"sobel kernel takes at most {_max_strips()} strips of {block[0]} rows "
                         f"and 2^31 pixels, got {h} x {w}")
    _run(img, out, block)
    dispatch.count_launch("sobel", reads=(img,), writes=(out,), block=block)
    return out


dispatch.register(dispatch.KernelSpec(name="sobel", reference=ref_sobel, kernel=sobel_magnitude,
                                      tiling=TILING))
