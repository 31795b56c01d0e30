"""Rotary position embeddings (RoPE), applied in float32."""
from __future__ import annotations

import torch

__all__ = ["apply_rope", "rope_tables", "rotate"]


def rope_tables(positions: torch.Tensor, d: int, *, theta: float = 10000.0):
    """(cos, sin) of the rotation angles, each (..., seq, 1, d // 2) float32,
    broadcasting over heads.  Built on the positions' device from Python
    scalars only: no host-to-device copy, so the caller's stream never
    waits on the host."""
    half = d // 2
    exponent = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freq = 1.0 / torch.pow(theta, exponent)
    ang = positions.to(torch.float32)[..., None] * freq  # (..., seq, half)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Apply the rotation tables of :func:`rope_tables` to x (..., seq, heads,
    head_dim); the products run in float32, the result in x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq), any numeric dtype."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta=theta))
