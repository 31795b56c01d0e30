"""Public wrappers: elementwise E2AFS sqrt/rsqrt of a tensor of any shape.

A CUDA tensor goes to ``csrc/e2afs_sqrt.cu`` (one launch, counted), a CPU
tensor to the plain version in :mod:`.ref`.  The launch's tile (threads a
block x 16-byte loads in flight a thread) is the registry's
(``dispatch.resolve_block``; :data:`TILING`), and every tile gives the same
bits.  Both carry the reference's
gradient (``repro.kernels.e2afs_sqrt.ops``'s ``custom_jvp`` rules, taken at
the approximate value: ``dispatch.make_differentiable_sqrt/rsqrt``), whose
backward is plain elementwise torch and launches no kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.hw_model import cost
from repro_torch.kernels import _build, dispatch
from repro_torch.kernels.e2afs_sqrt.ref import ref_rsqrt, ref_sqrt

__all__ = ["sqrt", "rsqrt", "scalar_design", "sqrt_normal_mismatches", "unit_mismatches",
           "TILING"]

_DTYPE_CODE = {torch.float16: 0, torch.bfloat16: 1, torch.float32: 2}
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p)
_LAUNCH_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
# today's launch before the tile became an argument, and the default
_DEFAULT = (256, 4)


def _geometry(args) -> dict:
    """The roofline's geometry (it narrows a sweep): the 16-byte vectors of
    x are its rows (a thread moves one a pass), and a block takes
    ``block[0]`` (its threads) of them; the kernel stages no tile."""
    x = args[0]
    per = 16 // x.element_size()
    return {"rows": max(-(-x.numel() // per), 1), "row_elems": per,
            "ops_per_elem": cost("e2afs")["depth"], "streams": 2, "staged": False}


# threads x unroll
TILING = dispatch.TilingSpec(default=_DEFAULT,
                             candidates=((128, 16), (256, 4), (256, 8), (512, 2), (512, 4)),
                             geometry=_geometry)


def _check(x: torch.Tensor) -> None:
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"e2afs kernel takes float16/bfloat16/float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("e2afs kernel needs a contiguous tensor")


def _output_like(x: torch.Tensor) -> torch.Tensor:
    """An empty tensor of x's shape at the same address mod 16 as x, so the
    kernel reads and writes both in 16-byte vectors (x may be a view that
    starts between two 16-byte boundaries)."""
    y = torch.empty_like(x)
    if (x.data_ptr() - y.data_ptr()) % 16 == 0:
        return y
    size = x.element_size()
    buf = torch.empty(x.numel() + 16 // size, dtype=x.dtype, device=x.device)
    skip = (x.data_ptr() - buf.data_ptr()) % 16 // size
    return buf[skip:skip + x.numel()].view(x.shape)


def _run(x: torch.Tensor, y: torch.Tensor, rsqrt: bool, block) -> None:
    """One launch of the kernel with tile ``block`` (threads, unroll); not
    counted (a sweep's launches run here too)."""
    threads, unroll = block
    fn = _build.function("e2afs_sqrt", "e2afs_sqrt_launch", _LAUNCH_ARGTYPES)
    with torch.cuda.device(x.device):
        fn(x.data_ptr(), y.data_ptr(), x.numel(), _DTYPE_CODE[x.dtype], int(rsqrt), threads,
           unroll, torch.cuda.current_stream(x.device).cuda_stream)


def _sweep_run(x: torch.Tensor, y: torch.Tensor, rsqrt: bool):
    """What a sweep times: a launch with a given tile."""
    return lambda block: _run(x, y, rsqrt, block)


def _launch(x: torch.Tensor, *, rsqrt: bool, block=None, tune=None) -> torch.Tensor:
    _check(x)
    name = "e2afs_rsqrt" if rsqrt else "e2afs_sqrt"
    if dispatch.is_fake(x):  # the dry run: the output and the count, no library
        y = torch.empty_like(x)
        dispatch.count_launch(name, reads=(x,), writes=(y,))
        return y
    y = _output_like(x)
    if x.numel() == 0:
        return y
    if block is None:
        block = dispatch.resolve_block(name, (x,), _sweep_run, (x, y, rsqrt), tune=tune)
    _run(x, y, rsqrt, block)
    dispatch.count_launch(name, reads=(x,), writes=(y,), block=block)
    return y


def _sqrt(x: torch.Tensor, *, block=None, tune=None) -> torch.Tensor:
    if dispatch.use_kernel(x):
        return _launch(x, rsqrt=False, block=block, tune=tune)
    return ref_sqrt(x)


def _rsqrt(x: torch.Tensor, *, block=None, tune=None) -> torch.Tensor:
    if dispatch.use_kernel(x):
        return _launch(x, rsqrt=True, block=block, tune=tune)
    return ref_rsqrt(x)


dispatch.register(dispatch.KernelSpec(name="e2afs_sqrt", reference=ref_sqrt, kernel=_sqrt,
                                      tiling=TILING))
dispatch.register(dispatch.KernelSpec(name="e2afs_rsqrt", reference=ref_rsqrt, kernel=_rsqrt,
                                      tiling=TILING))


_differentiable_sqrt = dispatch.make_differentiable_sqrt(_sqrt)
_differentiable_rsqrt = dispatch.make_differentiable_rsqrt(_rsqrt)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    return _differentiable_sqrt(x)


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    return _differentiable_rsqrt(x)


def scalar_design(x: torch.Tensor, *, rsqrt: bool) -> torch.Tensor:
    """The kernel's first design (one element a thread, the general
    datapath), kept to be timed beside it: the same bits, on the card only,
    no gradient and no launch count."""
    _check(x)
    if x.device.type != "cuda":
        raise ValueError(f"the first design runs on the card, got {x.device}")
    y = torch.empty_like(x)
    fn = _build.function("e2afs_sqrt", "e2afs_sqrt_scalar_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        fn(x.data_ptr(), y.data_ptr(), x.numel(), _DTYPE_CODE[x.dtype], int(rsqrt),
           torch.cuda.current_stream(x.device).cuda_stream)
    return y


def _card(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the check runs on the card, got {device}")
    return device


def sqrt_normal_mismatches(first: int, last: int, device) -> int:
    """The number of float32 bit patterns in [first, last) on which the lean
    E2AFS sqrt of the Sobel and K-means kernels (``csrc/e2afs.cuh``,
    ``sqrt_normal_f32``) differs from the general one (``sqrt_positive_f32``),
    counted on the card.  A check of the CUDA datapath: no plain version, no
    launch count."""
    if not 0 <= first <= last < 2**32:
        raise ValueError(f"patterns [{first}, {last}) are not float32 bit patterns")
    device = _card(device)
    out = torch.zeros((), dtype=torch.int64, device=device)
    fn = _build.function("e2afs_sqrt", "e2afs_sqrt_normal_check",
                         (ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p))
    with torch.cuda.device(device):
        fn(first, last, out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    return int(out)


def unit_mismatches(dtype: torch.dtype, *, rsqrt: bool, device) -> int:
    """The number of ``dtype``'s bit patterns (all 2^16 or 2^32 of them) on
    which the elementwise kernel's datapath (``csrc/e2afs.cuh``,
    ``lean_unit_bits``, by 16-byte vectors as the kernel's body runs it and
    one value at a time as its head and tail do) differs from the general
    one (``unit_bits``), counted on the card.  A check of the CUDA datapath:
    no plain version, no launch count."""
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"e2afs kernel takes float16/bfloat16/float32, got {dtype}")
    device = _card(device)
    out = torch.zeros((), dtype=torch.int64, device=device)
    fn = _build.function("e2afs_sqrt", "e2afs_sqrt_unit_check",
                         (ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p))
    with torch.cuda.device(device):
        fn(_DTYPE_CODE[dtype], int(rsqrt), out.data_ptr(),
           torch.cuda.current_stream(device).cuda_stream)
    return int(out)
