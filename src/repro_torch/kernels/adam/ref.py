"""Plain PyTorch version of the fused AdamW-E2AFS kernel (torch copy of the
reference's ``ref_adam_update``), in the TPU kernel's order of operations."""
from __future__ import annotations

import torch

from repro_torch.core import get_unit

__all__ = ["ref_adam_update"]


def ref_adam_update(p, g, m, v, sched, *, b1, b2, eps, wd, sqrt_unit="e2afs"):
    """One AdamW step; returns new (p, m, v), p in its own dtype, m and v
    float32.  ``sched`` is the (3,) float32 tensor ``[lr, b1c, b2c]`` on the
    operands' device.  Every product and sum rounds on its own, in the
    kernel's order: ``((1 - b2) * g) * g``, with ``1 - b1`` and ``1 - b2``
    rounded once from double to float32, as the reference's Python floats
    are."""
    unit = get_unit(sqrt_unit)
    lr, b1c, b2c = sched[0], sched[1], sched[2]
    g32 = g.to(torch.float32)
    m = b1 * m + (1 - b1) * g32
    v = b2 * v + (1 - b2) * g32 * g32
    m_hat = m / b1c
    v_hat = v / b2c
    denom = unit.sqrt(v_hat) + eps
    p32 = p.to(torch.float32)
    new_p = p32 - lr * (m_hat / denom + wd * p32)
    return new_p.to(p.dtype), m, v
