"""Dense MLP blocks: SwiGLU (llama-family default) and GELU (whisper)."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.distributed.constraints import mesh_axes, stream_param, tp_in, tp_out
from repro_torch.layers.param import parameter

__all__ = ["MLP", "mlp_apply"]


class MLP(nn.Module):
    """Weights in the reference's layout: wi_* (d, f), wo (f, d); the GELU
    variant also has biases bi (f,) and bo (d,); ``SPECS`` their logical
    axes."""

    SPECS = {"wi_gate": ("embed", "mlp"), "wi_up": ("embed", "mlp"), "bi": ("mlp",),
             "bo": ("embed",), "wo": ("mlp", "embed")}

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        if cfg.mlp_act == "swiglu":
            self.wi_gate = parameter((d, f), dtype, device)
            self.wi_up = parameter((d, f), dtype, device)
        else:
            self.wi_up = parameter((d, f), dtype, device)
            self.bi = parameter((f,), dtype, device)
            self.bo = parameter((d,), dtype, device)
        self.wo = parameter((f, d), dtype, device)


def _hidden_axes(cfg) -> tuple:
    """The mesh axes that shard the hidden units (a tensor-parallel scope;
    none elsewhere)."""
    return mesh_axes(MLP.SPECS["wo"], (cfg.d_ff, cfg.d_model), 0)


def _reduced(cfg, y: torch.Tensor) -> torch.Tensor:
    """The down projection's output, summed over the mesh axes that shard
    the hidden units (``constraints.tp_out``)."""
    return tp_out(y, _hidden_axes(cfg))


def mlp_apply(p: MLP, cfg, x: torch.Tensor, mm=torch.matmul) -> torch.Tensor:
    """The block over x (..., d); ``mm`` is the product (a speculative
    verify passes ``layers.rowwise.matmul``).  Under tensor parallelism a
    rank holds a block of the hidden units: x enters them through
    ``constraints.tp_in``, and the down projection's partial sums are
    reduced (``tp_out``) before the GELU variant's output bias, which is
    added to the stream (``constraints.stream_param``)."""
    dt = x.dtype
    x = tp_in(x, _hidden_axes(cfg))
    if cfg.mlp_act == "swiglu":
        g = mm(x, p.wi_gate.to(dt))
        u = mm(x, p.wi_up.to(dt))
        return _reduced(cfg, mm(torch.nn.functional.silu(g) * u, p.wo.to(dt)))
    h = mm(x, p.wi_up.to(dt)) + p.bi.to(dt)
    h = torch.nn.functional.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    return _reduced(cfg, mm(h, p.wo.to(dt))) + stream_param(p.bo).to(dt)
