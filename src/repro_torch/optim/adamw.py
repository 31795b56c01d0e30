"""AdamW with a pluggable sqrt unit (torch port of ``repro.optim.adamw``):
``m_hat / (sqrt(v_hat) + eps)`` runs through the configured unit ("e2afs" =
the paper's datapath on float32 bit patterns), as does the global-norm
gradient clip.

Parameters, gradients and moments are dicts ``{name: tensor}`` keyed by the
model's parameter names (a model may be passed for the parameters).  The
state is ``{"m", "v", "step"}`` on the parameters' device.
:func:`adamw_update` updates the parameters, m and v IN PLACE and scales
the gradients in place when it clips, the counterpart of the reference's
route that donates its buffers; the returned dicts are the ones passed in.

The schedule scalars (lr and the bias corrections) are float32 tensors on
the device, computed as the reference computes them; the fused route hands
them to the ``adam`` kernel as one (3,) tensor, so no step reads a scalar
back to the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core import get_unit

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm_clip", "cosine_lr",
           "opt_state_specs"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    sqrt_unit: str = "exact"
    # route every m/v/p update through the fused adam kernel (the CUDA
    # kernel on the card, its plain version on the CPU); requires
    # sqrt_unit="e2afs"
    fused: bool = False
    # the reference's opt-in buffer donation; the port always updates in
    # place, so this changes nothing here
    donate: bool = False


def _named(params) -> dict:
    return dict(params.named_parameters()) if isinstance(params, torch.nn.Module) else params


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` as a true division (on CUDA, ``tensor / float`` multiplies by
    the rounded reciprocal)."""
    return a / a.new_full((), b)


def adamw_init(params) -> dict:
    named = _named(params)
    dev = next(iter(named.values())).device

    def zeros():
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in named.items()}

    return {"m": zeros(), "v": zeros(), "step": torch.zeros((), dtype=torch.int32, device=dev)}


def opt_state_specs(param_specs):
    """The optimizer state's logical axes mirror the parameters' (a tree of
    spec tuples, e.g. ``lm.param_specs(cfg)``); the step is a scalar."""
    return {"m": param_specs, "v": param_specs, "step": ()}


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to 0 at ``total_steps``: a float32
    tensor on ``step``'s device."""
    step = step.to(torch.float32)
    warm = torch.clamp(_div(step + 1, max(1, cfg.warmup_steps)), max=1.0)
    frac = torch.clamp(_div(step - cfg.warmup_steps, max(1, cfg.total_steps - cfg.warmup_steps)),
                       0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * frac))


def bias_corrections(cfg: AdamWConfig, step: torch.Tensor):
    """``(1 - b1**step, 1 - b2**step)`` in float32 on ``step``'s device."""
    s = step.to(torch.float32)
    return (1.0 - torch.pow(s.new_full((), cfg.b1), s),
            1.0 - torch.pow(s.new_full((), cfg.b2), s))


def _summed_over_shards(sums: dict, shardings: dict) -> dict:
    """Each leaf's local sum summed over the mesh axes that shard it (a
    replicated copy counted once, ``constraints.over_shards``): one
    all-reduce a set of axes, of the leaves' sums stacked."""
    from repro_torch.distributed.constraints import over_shards, shard_axes

    by_axes = {}
    for n in sums:
        axes = shard_axes(shardings.get(n))
        if axes:
            by_axes.setdefault(axes, []).append(n)
    out = dict(sums)
    for names in by_axes.values():
        total = over_shards("sum", torch.stack([sums[n] for n in names]), shardings[names[0]])
        out.update(zip(names, total.unbind()))
    return out


@torch.no_grad()
def global_norm_clip(grads: dict, clip: float, sqrt_unit: str, shardings: Optional[dict] = None):
    """Scales every gradient IN PLACE by ``min(1, clip / (norm + 1e-6))``,
    the norm taken through the unit's sqrt.  Returns (grads, norm).
    ``shardings`` ({name: ``Sharding``}, a sharded model's ``placement``):
    the gradients are each rank's blocks, and each leaf's squares are
    summed over the mesh axes that shard it, and only those."""
    unit = get_unit(sqrt_unit)
    sums = {n: torch.sum(torch.square(g.to(torch.float32))) for n, g in grads.items()}
    if shardings:
        sums = _summed_over_shards(sums, shardings)
    sq = None
    for s in sums.values():
        sq = s if sq is None else sq + s
    norm = unit.sqrt(sq[None])[0]
    scale = torch.clamp(norm.new_full((), clip) / (norm + 1e-6), max=1.0)
    for g in grads.values():
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            g.copy_(g.to(torch.float32) * scale)
    return grads, norm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: dict, state: dict, params,
                 shardings: Optional[dict] = None):
    """One AdamW step over every parameter in ``grads``, in place.  Returns
    (params, state, metrics) with metrics ``lr`` and, when clipping,
    ``grad_norm``.  ``shardings`` (a sharded model's ``placement``): the
    tensors are each rank's blocks (the clip's norm sums over the blocks;
    the update is elementwise, on the rank's contiguous blocks)."""
    params = _named(params)
    unit = get_unit(cfg.sqrt_unit)
    metrics = {}
    if cfg.clip_norm is not None:
        grads, metrics["grad_norm"] = global_norm_clip(grads, cfg.clip_norm, cfg.sqrt_unit,
                                                       shardings)

    step = state["step"] + 1
    lr = cosine_lr(cfg, step)
    b1c, b2c = bias_corrections(cfg, step)

    if cfg.fused:
        if cfg.sqrt_unit != "e2afs":
            raise ValueError(f"fused AdamW requires sqrt_unit='e2afs', got {cfg.sqrt_unit!r}")
        from repro_torch.kernels.adam.ops import adam_update

        sched = torch.stack([lr, b1c, b2c])
        for name, g in grads.items():
            adam_update(params[name], g, state["m"][name], state["v"][name], sched,
                        b1=cfg.b1, b2=cfg.b2, eps=cfg.eps, wd=cfg.weight_decay)
    else:
        # the reference's unfused order: (1 - b2) * square(g)
        for name, g in grads.items():
            p, m, v = params[name], state["m"][name], state["v"][name]
            g32 = g.to(torch.float32)
            m.copy_(cfg.b1 * m + (1 - cfg.b1) * g32)
            v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g32))
            denom = unit.sqrt(v / b2c) + cfg.eps
            p32 = p.to(torch.float32)
            p.copy_(p32 - lr * ((m / b1c) / denom + cfg.weight_decay * p32))
    state["step"] = step
    metrics["lr"] = lr
    return params, state, metrics
