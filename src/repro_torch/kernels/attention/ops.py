"""Public wrapper: fused per-slot decode attention.

A CUDA tensor goes to ``csrc/decode_attention.cu`` (one counted launch of
the kernel, which splits the cache length over blocks), a CPU tensor to the
plain version in :mod:`.ref`.  The kernel reads an int8 cache as stored; no
pre-cast copy of the cache is made.  The ``.cu`` file plans the split from
the shapes and the card (:func:`plan`, asked once a shape); the wrapper
allocates the float32 workspace the plan asks for.  The kernel takes the
reference kernel's whole shape domain: any number of query heads a KV head
(padded to an instantiated group, or in passes of at most 16 heads) and any
``head_dim`` up to 256 that is a multiple of the cache line's vector width
(8 elements of bf16 or int8, 4 of float32); other shapes raise before any
launch.  The registry holds one
tile, that planned split (``(0,)``): the split is part of the bit-identity of
a graph's replays and of speculative verify rows, which a tuned split would
break.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, dispatch
from repro_torch.kernels.attention.ref import ref_decode_attention

__all__ = ["decode_attention", "ref_decode_attention", "TILING"]

_DTYPE_CODE = {torch.bfloat16: 1, torch.float32: 2}
MAX_HEAD_DIM = 256  # decode_attention.cu's kMaxHeadDim

_PLAN_ARGTYPES = (ctypes.c_int,) * 7 + (ctypes.POINTER(ctypes.c_longlong),)
_ARGTYPES = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 5 + (
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def _check(q, k, v, pos, k_scale, v_scale):
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"decode attention takes bfloat16/float32 queries, got {q.dtype}")
    if q.ndim != 3 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (b, h, hd) and k/v (b, t, kv, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, hd = q.shape
    kb, t, kv, khd = k.shape
    if kb != b or khd != hd or h % kv:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if t < 1:
        raise ValueError("decode attention needs a cache of at least one line")
    vec = 4 if k.dtype == torch.float32 else 8  # elements per vector load
    if hd % vec or not vec <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} must be a multiple of {vec} no larger than "
                         f"{MAX_HEAD_DIM} for a {k.dtype} cache")
    quantized = k.dtype == torch.int8
    if not quantized and (k.dtype != q.dtype or v.dtype != q.dtype):
        raise ValueError(f"k/v must be int8 or {q.dtype}, got {k.dtype}, {v.dtype}")
    if quantized != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("int8 caches need k_scale and v_scale; float caches take none")
    if quantized:
        if v.dtype != torch.int8:
            raise ValueError(f"v must be int8 like k, got {v.dtype}")
        for s in (k_scale, v_scale):
            if s.dtype != torch.float32 or s.shape != k.shape[:3] or not s.is_contiguous():
                raise ValueError(f"scales must be contiguous float32 {tuple(k.shape[:3])}")
    if pos.dtype != torch.int32 or tuple(pos.shape) != (b,) or not pos.is_contiguous():
        raise ValueError(f"pos must be a contiguous ({b},) int32 tensor")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("decode attention needs contiguous q, k and v")
    if not dispatch.is_fake(k) and (k.data_ptr() % 16 or v.data_ptr() % 16):
        raise ValueError("the K/V caches must start on a 16-byte boundary (vector loads)")
    return quantized


@functools.lru_cache(maxsize=None)
def _plan(device: int, b: int, t: int, h: int, kv: int, hd: int, dtype_code: int,
          int8: int) -> tuple:
    out = (ctypes.c_longlong * 6)()
    fn = _build.function("decode_attention", "decode_attention_plan", _PLAN_ARGTYPES)
    with torch.cuda.device(device):
        fn(b, t, h, kv, hd, dtype_code, int8, out)
    return tuple(out)


def plan(q, k) -> dict:
    """How ``decode_attention.cu`` splits these shapes on q's card: the
    chunks a (slot, KV head) and the cache lines a chunk, the slots a
    launch, the float32 workspace elements, the passes over a (slot, KV
    head) (one launch each) and the instantiated group each pass runs as.
    Needs the built kernel; asked once a shape."""
    b, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    ws, chunks, lines, slots, passes, group = _plan(
        q.device.index, b, t, h, kv, hd, _DTYPE_CODE[q.dtype], int(k.dtype == torch.int8))
    return {"workspace": ws, "chunks": chunks, "chunk_lines": lines, "slots": slots,
            "passes": passes, "group": group}


# (0,): the split plan() computes from the shapes and the card, the one tile
TILING = dispatch.TilingSpec(default=(0,), candidates=((0,),))


def decode_attention(q, k, v, pos, k_scale=None, v_scale=None, *, scale: float,
                     wrap: bool = False, block=None, tune=None) -> torch.Tensor:
    """One fused decode-attention step.  q: (b, h, hd); k/v: (b, t, kv, hd)
    cache in q's dtype, or int8 with float32 scales (b, t, kv); pos: (b,)
    int32 per-row positions; ``wrap=True`` for ring caches.  Returns
    (b, h, hd) in q's dtype.  ``block``: None or :data:`TILING`'s one tile;
    ``tune`` has nothing to choose."""
    if block is not None and tuple(block) != TILING.default:
        raise ValueError(f"decode_attention takes only the tile {TILING.default}, got {block}")
    if not dispatch.use_kernel(q, k, v, pos, k_scale, v_scale):
        return ref_decode_attention(q, k, v, pos, k_scale, v_scale, scale=scale, wrap=wrap)
    quantized = _check(q, k, v, pos, k_scale, v_scale)
    b, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if b == 0:
        return out
    detail = "wrap" if wrap else "no wrap"
    reads = (q, k, v, pos, k_scale, v_scale)
    if dispatch.is_fake(q):  # the dry run: the output and the count, no library
        dispatch.count_launch("decode_attention", detail, reads=reads, writes=(out,))
        return out
    workspace = torch.empty(plan(q, k)["workspace"], dtype=torch.float32, device=q.device)
    fn = _build.function("decode_attention", "decode_attention_launch", _ARGTYPES)
    with torch.cuda.device(q.device):
        fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
           k_scale.data_ptr() if quantized else None,
           v_scale.data_ptr() if quantized else None,
           workspace.data_ptr(), out.data_ptr(), b, t, h, kv, hd, scale, int(wrap),
           _DTYPE_CODE[q.dtype], int(quantized),
           torch.cuda.current_stream(q.device).cuda_stream)
    dispatch.count_launch("decode_attention", detail, reads=reads, writes=(out,),
                          block=TILING.default)
    return out


dispatch.register(dispatch.KernelSpec(name="decode_attention", reference=ref_decode_attention,
                                      kernel=decode_attention, tiling=TILING))
