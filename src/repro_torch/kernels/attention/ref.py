"""Plain PyTorch version of the fused decode-attention kernel.

This is the inline decode path: the per-row validity mask that
``attention_decode`` builds, fed to the same
:func:`repro_torch.layers.attention._fold_masked_attention` block.
"""
from __future__ import annotations

import torch

from repro_torch.layers.attention import NEG_INF, _fold_masked_attention

__all__ = ["ref_decode_attention"]


def ref_decode_attention(q, k, v, pos, k_scale=None, v_scale=None, *, scale: float,
                         wrap: bool = False) -> torch.Tensor:
    """q: (b, h, hd), the single query token per row; k/v: (b, t, kv, hd) in
    q's dtype, or int8 with scales (b, t, kv) float32; pos: (b,) int32.
    Returns (b, h, hd)."""
    t = k.shape[1]
    if k.dtype == torch.int8:
        k, v = k.to(q.dtype), v.to(q.dtype)
    t_idx = torch.arange(t, device=q.device)
    valid = t_idx[None, :] <= pos[:, None]
    if wrap:
        valid = valid | (pos[:, None] >= t)
    mask = torch.where(valid, 0.0, NEG_INF).to(torch.float32)[:, None, :]  # (b, 1, t)
    out = _fold_masked_attention(q[:, None], k, v, mask, scale, k_scale, v_scale, q.dtype)
    return out[:, 0]
