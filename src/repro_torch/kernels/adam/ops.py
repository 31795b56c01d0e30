"""Public wrapper: one fused AdamW-E2AFS step over a parameter tensor of any
shape, IN PLACE on p, m and v.

A CUDA tensor goes to ``csrc/adam.cu`` (one launch, counted), a CPU tensor
to the plain version in :mod:`.ref`, whose result is copied back into p, m
and v.  ``sched = [lr, b1c, b2c]`` is a (3,) float32 tensor on the
operands' device, so nothing is read back to the host between steps.  The
launch's tile (threads a block x blocks an SM) is the registry's
(``dispatch.resolve_block``; :data:`TILING`), and every tile gives the same
bits.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, dispatch
from repro_torch.kernels.adam.ref import ref_adam_update

__all__ = ["adam_update", "TILING"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
             ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
# today's launch before the tile became an argument, and the default
_DEFAULT = (256, 8)
# about 15 float and 14 integer operations an element (csrc/adam.cu)
_OPS_PER_ELEM = 29.0


def _geometry(args) -> dict:
    """The roofline's geometry (it narrows a sweep): the parameter's
    elements are its rows (a thread takes one a pass), ``block[0]`` (the
    threads) of them a block, seven streams (p, g, m, v read; p, m, v
    written); the kernel stages no tile."""
    p = args[0]
    return {"rows": max(p.numel(), 1), "row_elems": 1, "ops_per_elem": _OPS_PER_ELEM,
            "streams": 7, "staged": False}


# threads x blocks an SM
TILING = dispatch.TilingSpec(default=_DEFAULT,
                             candidates=((128, 32), (256, 8), (256, 16), (512, 4), (1024, 2)),
                             geometry=_geometry)


def _run(p, g, m, v, sched, b1, b2, eps, wd, block) -> None:
    """One in-place launch with tile ``block``; not counted."""
    fn = _build.function("adam", "adam_launch", _ARGTYPES)
    with torch.cuda.device(p.device):
        # 1 - b1 and 1 - b2 in double, rounded once to float32 by ctypes, as
        # the plain version's Python scalars are (1.0f - 0.9f is not 0.1f)
        fn(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), sched.data_ptr(), p.numel(),
           _DTYPE_CODE[p.dtype], _DTYPE_CODE[g.dtype], b1, 1 - b1, b2, 1 - b2, eps, wd,
           block[0], block[1], torch.cuda.current_stream(p.device).cuda_stream)


def _sweep_run(p, g, m, v, sched, b1, b2, eps, wd):
    """What a sweep times: a launch with a given tile on copies of p, m and
    v, never the caller's."""
    cp, cm, cv = p.clone(), m.clone(), v.clone()
    return lambda block: _run(cp, g, cm, cv, sched, b1, b2, eps, wd, block)


@torch.no_grad()
def adam_update(p, g, m, v, sched, *, b1=0.9, b2=0.95, eps=1e-8, wd=0.1, block=None, tune=None):
    """p, g: float32 or bfloat16; m, v: float32; all of one shape.  Updates
    p, m and v in place and returns them.  ``block``: a tile of
    :data:`TILING` (None resolves one; a sweep times copies of p, m and v),
    ``tune`` as ``dispatch.resolve_block``'s."""
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
    if dispatch.is_fake(p):  # the dry run: the count, no library
        dispatch.count_launch("adam", reads=(p, g, m, v, sched), writes=(p, m, v))
        return p, m, v
    if block is None:
        block = dispatch.resolve_block("adam", (p, g, m, v, sched), _sweep_run,
                                       (p, g, m, v, sched, b1, b2, eps, wd), tune=tune)
    _run(p, g, m, v, sched, b1, b2, eps, wd, block)
    dispatch.count_launch("adam", reads=(p, g, m, v, sched), writes=(p, m, v), block=block)
    return p, m, v


dispatch.register(dispatch.KernelSpec(name="adam", reference=ref_adam_update,
                                      kernel=adam_update, tiling=TILING))
