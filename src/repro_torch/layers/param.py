"""Parameter initialisation on an explicit ``torch.Generator``.

The same law as ``repro.layers.param.truncated_normal`` (a normal truncated
to [-2, 2], scaled by ``scale / sqrt(fan_in)`` with ``fan_in = shape[0]``),
drawn by inverse CDF from the generator's uniforms.  torch's generator does
not reproduce ``jax.random``'s numbers; parity tests carry JAX's parameters
across with :func:`repro_torch.models.convert.params_from_numpy`.
"""
from __future__ import annotations

import math

import torch

__all__ = ["truncated_normal", "parameter"]

_LO = math.erf(-2.0 / math.sqrt(2.0))
_HI = math.erf(2.0 / math.sqrt(2.0))


def truncated_normal(generator: torch.Generator, shape, dtype, scale: float = 1.0,
                     device=None) -> torch.Tensor:
    """Fan-in scaled truncated normal, drawn in float32, returned in dtype."""
    stddev = scale / math.sqrt(max(1, shape[0] if len(shape) > 1 else 1))
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    x = torch.special.erfinv(u.mul_(_HI - _LO).add_(_LO)).mul_(math.sqrt(2.0))
    return x.clamp_(-2.0, 2.0).mul_(stddev).to(dtype)


def parameter(shape, dtype, device) -> torch.nn.Parameter:
    """An uninitialised inference parameter (no gradient)."""
    return torch.nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)
