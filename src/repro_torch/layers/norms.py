"""Normalization layers with a pluggable sqrt unit (torch port of
``repro.layers.norms``): RMSNorm and LayerNorm, each with a per-row
accuracy-SLO ladder variant.

``x * rsqrt(ms + eps)`` is computed through the configured SqrtUnit; the
reduction is float32 whatever the activation dtype.  ``fused=True`` routes
the whole RMSNorm through the RMSNorm kernel (the CUDA kernel for a CUDA
tensor, its plain version for a CPU tensor); only "e2afs" has a fused
datapath, and it has no fault-injection hook.  Unfused, a clean "e2afs"
rsqrt takes the unit's kernel route (``get_unit("e2afs", kernel=True)``:
one ``e2afs_sqrt`` launch on a CUDA tensor, the plain datapath on a CPU
one, the same bits and gradient either way); a faulted one keeps the
datapath's in-field injection, and every other unit its plain datapath.
The fused and unfused routes compute the same function: in the reference
they are bit-identical, and here only the order of the float32 sum differs.
So a ladder's rung 0 takes the single-unit route itself (fused for a clean
"e2afs"): a row at level 0 is bit-identical to the norm without levels.

The model reaches every norm through :func:`norm_init` and :func:`norm_cfg`
(the reference's ``_norm_init`` and ``_norm``), which dispatch on
``cfg.norm``: an RMSNorm holds one parameter ``<name>`` (zeros, applied as
``1 + scale``), a LayerNorm two, ``<name>_scale`` (ones) and ``<name>_bias``
(zeros).  LayerNorm has no fused kernel: a clean "e2afs" LayerNorm is one
``e2afs_rsqrt`` launch on a CUDA tensor.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.core import get_unit, resolve_ladder
from repro_torch.distributed.constraints import fault_block, stream_param
from repro_torch.layers.param import parameter

__all__ = ["rmsnorm", "rmsnorm_select", "rmsnorm_cfg", "layernorm", "layernorm_select",
           "norm_init", "norm_cfg"]


def _rsqrt(unit, v: torch.Tensor) -> torch.Tensor:
    """The unit's rsqrt of ``v``, on the e2afs kernel route when clean."""
    return unit.rsqrt(v, kernel=unit.name == "e2afs" and not unit._fault_active())


def _pick(lv, values, first: int = 0):
    """Per row, ``values[lv - first]`` (``lv`` broadcast over the rows)."""
    out = values[-1]
    for j in range(len(values) - 2, -1, -1):
        out = torch.where(lv == first + j, values[j], out)
    return out


def _row_levels(levels, ndim):
    return levels.reshape((levels.shape[0],) + (1,) * (ndim - 1))


def _select_inv(v, levels, ladder, faults, ndim):
    """rsqrt of ``v`` through every ladder rung, selected per row by
    ``levels`` ((b,) over the leading axis).  A row at level 0 takes
    exactly rung 0's output, bit-identical to the single-unit route;
    faults ride rung 0 only."""
    units = resolve_ladder(ladder, faults=faults)
    return _pick(_row_levels(levels, ndim), [_rsqrt(u, v) for u in units])


def _mean_square(xf: torch.Tensor) -> torch.Tensor:
    """fp32 mean of x^2 over the last axis: a sum divided by d, as
    ``jnp.mean``."""
    return (xf * xf).sum(dim=-1, keepdim=True) / xf.shape[-1]


def _centred(xf: torch.Tensor):
    mu = xf.sum(dim=-1, keepdim=True) / xf.shape[-1]
    c = xf - mu
    return c, (c * c).sum(dim=-1, keepdim=True) / xf.shape[-1]


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, *, sqrt_unit: str = "exact",
            eps: float = 1e-6, fused: bool = False, faults=None) -> torch.Tensor:
    """Normalise the last axis of ``x``; ``scale`` (d,) is applied as
    ``1 + scale`` (zero-initialised, gemma convention).  Scale first, as in
    the reference.  ``faults`` threads a seeded sqrt-site
    :class:`~repro_torch.core.faults.FaultConfig` into the unit."""
    unit = get_unit(sqrt_unit, faults=faults)
    if fused:
        if sqrt_unit != "e2afs":
            raise ValueError(f"fused rmsnorm requires sqrt_unit='e2afs', got {sqrt_unit!r}")
        if unit._fault_active():
            raise ValueError("fused rmsnorm has no fault-injection hook; use fused=False")
        from repro_torch.kernels.rmsnorm.ops import rmsnorm as rmsnorm_kernel

        return rmsnorm_kernel(x, scale.to(x.dtype), eps=eps)
    xf = x.float()
    inv = _rsqrt(unit, _mean_square(xf) + eps)
    return (xf * inv).to(x.dtype) * (1.0 + scale.to(x.dtype))


def rmsnorm_select(scale: torch.Tensor, x: torch.Tensor, levels: torch.Tensor, *, ladder,
                   eps: float = 1e-6, faults=None, fused: bool = True) -> torch.Tensor:
    """Per-row ladder variant of :func:`rmsnorm` for accuracy-SLO decode: row
    ``i`` is normalised through ``ladder[levels[i]]``.  Rung 0 runs the
    route :func:`rmsnorm_cfg` takes for the single-unit config (the fused
    kernel for a clean "e2afs" where ``fused`` asks, else unfused with the
    faults), so a level-0 row is bit-identical to the norm without levels.
    The other rungs run unfused: the mean square once, one rsqrt a rung,
    selected per row."""
    units = resolve_ladder(ladder, faults=faults)
    first = rmsnorm(scale, x, sqrt_unit=ladder[0], eps=eps, faults=faults,
                    fused=fused and ladder[0] == "e2afs" and not units[0]._fault_active())
    lv = _row_levels(levels, x.ndim)
    xf = x.float()
    ms = _mean_square(xf) + eps
    inv = _pick(lv, [_rsqrt(u, ms) for u in units[1:]], first=1)
    rest = (xf * inv).to(x.dtype) * (1.0 + scale.to(x.dtype))
    return torch.where(lv == 0, first, rest)


def _site(cfg, x: torch.Tensor, axes, extents):
    """The fault block of a norm's rsqrt input (x's shape with the last dim
    1) on a mesh: x's logical ``axes`` (default: the residual stream's,
    ("batch", "seq", ..., "embed")) with the normalised dim reduced."""
    if cfg.sqrt_faults is None:
        return contextlib.nullcontext()
    if axes is None:
        axes = ("batch",) + ("seq",) * (x.ndim - 2) + ("embed",)
    return fault_block(tuple(axes[:-1]) + (None,), tuple(x.shape[:-1]) + (1,), extents)


def rmsnorm_cfg(scale: torch.Tensor, x: torch.Tensor, cfg, *, fused: bool = True,
                levels=None, axes=None, extents=None) -> torch.Tensor:
    """An RMSNorm of the model under its config: with ``levels`` ((b,),
    accuracy-SLO decode) each row through its rung of ``cfg.sqrt_ladder``
    (:func:`rmsnorm_select`); else through ``cfg.sqrt_unit`` and
    ``cfg.sqrt_faults``, on the fused kernel where ``fused`` asks and the
    kernel computes the norm ("e2afs", no sqrt fault active).  ``axes`` and
    ``extents``: x's logical axes and the global sizes of its sharded ones
    (a qk-norm's heads), for the fault hash on a mesh (:func:`_site`)."""
    with _site(cfg, x, axes, extents):
        if levels is not None:
            return rmsnorm_select(scale, x, levels, ladder=cfg.sqrt_ladder,
                                  faults=cfg.sqrt_faults, fused=fused)
        clean = not get_unit(cfg.sqrt_unit, faults=cfg.sqrt_faults)._fault_active()
        return rmsnorm(scale, x, sqrt_unit=cfg.sqrt_unit, faults=cfg.sqrt_faults,
                       fused=fused and cfg.sqrt_unit == "e2afs" and clean)


def layernorm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor, *,
              sqrt_unit: str = "exact", eps: float = 1e-5, faults=None) -> torch.Tensor:
    c, var = _centred(x.float())
    inv = _rsqrt(get_unit(sqrt_unit, faults=faults), var + eps)
    return (c * inv).to(x.dtype) * scale.to(x.dtype) + bias.to(x.dtype)


def layernorm_select(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
                     levels: torch.Tensor, *, ladder, eps: float = 1e-5,
                     faults=None) -> torch.Tensor:
    """Per-row ladder variant of :func:`layernorm` (see :func:`rmsnorm_select`)."""
    c, var = _centred(x.float())
    inv = _select_inv(var + eps, levels, ladder, faults, x.ndim)
    return (c * inv).to(x.dtype) * scale.to(x.dtype) + bias.to(x.dtype)


def norm_init(module: torch.nn.Module, name: str, cfg, *, dtype, device) -> None:
    """Register the config's norm parameters of width ``cfg.d_model`` on
    ``module``, uninitialised: ``<name>`` for an RMSNorm, ``<name>_scale``
    and ``<name>_bias`` for a LayerNorm (``lm.init`` fills them)."""
    names = (name,) if cfg.norm == "rmsnorm" else (f"{name}_scale", f"{name}_bias")
    for n in names:
        module.register_parameter(n, parameter((cfg.d_model,), dtype, device))


def norm_cfg(p: torch.nn.Module, name: str, x: torch.Tensor, cfg, *, fused: bool = True,
             levels=None, stream: bool = False) -> torch.Tensor:
    """The norm ``name`` of module ``p`` over ``x`` under the config: an
    RMSNorm through :func:`rmsnorm_cfg` (the fused kernel where ``fused``
    asks and it applies), a LayerNorm through :func:`layernorm`, or with
    ``levels`` ((b,), accuracy-SLO decode) :func:`layernorm_select`.
    ``stream``: x is the residual stream of a training forward, whose
    sequence a sequence-parallel scope splits, so the norm's parameters
    enter through ``constraints.stream_param``."""
    names = (name,) if cfg.norm == "rmsnorm" else (f"{name}_scale", f"{name}_bias")
    params = [stream_param(getattr(p, n)) if stream else getattr(p, n) for n in names]
    if cfg.norm == "rmsnorm":
        return rmsnorm_cfg(params[0], x, cfg, fused=fused, levels=levels)
    scale, bias = params
    with _site(cfg, x, None, None):
        if levels is not None:
            return layernorm_select(scale, bias, x, levels, ladder=cfg.sqrt_ladder,
                                    faults=cfg.sqrt_faults)
        return layernorm(scale, bias, x, sqrt_unit=cfg.sqrt_unit, faults=cfg.sqrt_faults)
