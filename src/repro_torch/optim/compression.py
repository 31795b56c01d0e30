"""Int8 gradient compression with error feedback (torch port of
``repro.optim.compression``).

Each gradient is quantised to int8 with a per-tensor scale, dequantised, and
the quantisation residual is carried to the next step (error feedback).  In
a data-parallel run the int8 tensor is what would cross the wire; here, on
one device, the round trip is what trains.  The port updates the gradients
and the residual IN PLACE.
"""
from __future__ import annotations

import torch

__all__ = ["compress_init", "compress_decompress"]


def compress_init(params) -> dict:
    named = dict(params.named_parameters()) if isinstance(params, torch.nn.Module) else params
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in named.items()}


def _quantize(g: torch.Tensor, sh=None):
    # true divisions, as the reference's (tensor / float multiplies by the
    # rounded reciprocal on CUDA)
    top = g.abs().amax()
    if sh is not None:  # a block of the tensor: the whole tensor's max
        from repro_torch.distributed.constraints import over_shards

        top = over_shards("max", top, sh)
    scale = top / g.new_full((), 127.0) + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)  # half to even
    return q, scale


@torch.no_grad()
def compress_decompress(grads: dict, residual: dict, shardings=None):
    """Replaces each gradient by its int8 round trip (with last step's
    residual added first) and the residual by the new quantisation error.
    Returns (grads, residual), the dicts passed in.  ``shardings`` (a
    sharded model's ``placement``): the tensors are each rank's blocks, and
    a block's scale is its whole tensor's (the max over the blocks)."""
    for name, g in grads.items():
        r = residual[name]
        g32 = g.to(torch.float32) + r
        q, scale = _quantize(g32, (shardings or {}).get(name))
        deq = q.to(torch.float32) * scale
        g.copy_(deq)
        r.copy_(g32 - deq)
    return grads, residual
