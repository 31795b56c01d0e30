"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427; torch
port of ``repro.layers.rglru``).

x -> {gate: linear + gelu} * {linear -> causal conv (4) -> RG-LRU} -> linear.

    r_t = sigmoid(W_r x_t);  i_t = sigmoid(W_i x_t)
    a_t = exp(-8 * softplus(lam) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The input normaliser ``sqrt(max(1 - a_t^2, 1e-12))`` is a technique site: it
runs through the configured unit on the reference's shape, (b, s, d_rnn) in
training and prefill and (b, d_rnn) in a decode step (a faulted unit's
schedule hashes the flat element index).  A clean "e2afs" unit takes its
kernel route, one ``e2afs_sqrt`` launch on a CUDA tensor and the plain
datapath on a CPU one, the same bits either way (the rule
``layers.norms._rsqrt`` applies to the rsqrt); a faulted unit keeps its
in-field injection.

Training and prefill run the affine recurrence as the reference's
``jax.lax.associative_scan`` does, level by level over the sequence (pairs
combined, the odd positions scanned recursively, the even ones filled in):
about 2 log2(s) elementwise passes, no loop over positions.  XLA may fuse
the multiply-adds, so the states agree with the reference within a
tolerance, not bit for bit.  ``lam`` is kept in float32 whatever the
activation dtype (the reference reads its float32 master).

Tensor parallelism (a ``distributed.constraints`` scope with "mlp" over
'model'): a rank holds a block of the recurrence's channels (x_proj's and
gate_proj's columns, conv_w, lam, the state) and of w_r's, w_i's and
out_proj's rows.  The gate products contract over the sharded channels, so
``xr @ w_r`` is a partial sum: it is reduced over 'model' and the rank keeps
its channels' block; the recurrence and its sqrt run on the block (the
fault hash at the block's global channels), and out_proj's products are
reduced as the MLP's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import get_unit
from repro_torch.distributed.constraints import (fault_block, mesh_axes, reduce_scatter_dim,
                                                 tp_in, tp_out, whole_sequence)
from repro_torch.layers.param import parameter
from repro_torch.layers.ssd import CONV_W, causal_conv, conv_step, conv_tail, softplus

__all__ = ["RGLRU", "init_rglru_state", "linear_scan", "rglru_decode", "rglru_state_specs",
           "rglru_train"]

_C = 8.0  # Griffin's fixed gate temperature


class RGLRU(nn.Module):
    """The block's weights in the reference's layout: gate_proj and x_proj
    (d, dr), conv_w (4, dr), w_r and w_i (dr, dr), lam (dr,), out_proj
    (dr, d).  ``CONSTANT_START``: conv_w and lam start at zero (so a fresh
    block's recurrence input is zero); ``INIT_SCALE``: w_r and w_i are drawn
    at scale 0.5; ``SPECS`` their logical axes."""

    SPECS = {"gate_proj": ("embed", "mlp"), "x_proj": ("embed", "mlp"), "conv_w": (None, "mlp"),
             "w_r": ("mlp", None), "w_i": ("mlp", None), "lam": ("mlp",),
             "out_proj": ("mlp", "embed")}
    CONSTANT_START = {"conv_w": 0.0, "lam": 0.0}
    INIT_SCALE = {"w_r": 0.5, "w_i": 0.5}

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        d, dr = cfg.d_model, cfg.rglru.d_rnn
        self.gate_proj = parameter((d, dr), dtype, device)
        self.x_proj = parameter((d, dr), dtype, device)
        self.conv_w = parameter((CONV_W, dr), dtype, device)
        self.w_r = parameter((dr, dr), dtype, device)
        self.w_i = parameter((dr, dr), dtype, device)
        self.lam = parameter((dr,), torch.float32, device)
        self.out_proj = parameter((dr, d), dtype, device)


def _gate(p: RGLRU, cfg, xr: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``xr @ w`` for the rank's channels: the product over its block of
    the contraction, reduce-scattered over the mesh axes sharding it into
    its own block of the output channels (the whole product outside a
    scope); the backward all-gathers the blocks' gradients, since every
    rank's addend reached every channel."""
    dr = cfg.rglru.d_rnn
    return reduce_scatter_dim(xr @ w.to(xr.dtype), mesh_axes(RGLRU.SPECS["w_r"], (dr, dr), 0), -1)


def _gates(p: RGLRU, cfg, xr: torch.Tensor):
    """(a_t, the gated input) of the recurrence, float32, xr's shape."""
    r = torch.sigmoid(_gate(p, cfg, xr, p.w_r).float())
    i = torch.sigmoid(_gate(p, cfg, xr, p.w_i).float())
    log_a = r * (-_C * softplus(p.lam.float()))
    a = torch.exp(log_a)
    unit = get_unit(cfg.sqrt_unit, faults=cfg.sqrt_faults)
    kernel = unit.name == "e2afs" and not unit._fault_active()
    axes = ("batch",) + ("seq",) * (xr.ndim - 2) + ("mlp",)
    with fault_block(axes, xr.shape, {"mlp": cfg.rglru.d_rnn}):
        norm = unit.sqrt(torch.clamp_min(1.0 - a * a, 1e-12), kernel=kernel)
    return a, norm * i * xr.float()


def _out(p: RGLRU, cfg, y: torch.Tensor) -> torch.Tensor:
    """out_proj of y, its partial sums over the rank's channels reduced."""
    axes = mesh_axes(RGLRU.SPECS["out_proj"], (cfg.rglru.d_rnn, cfg.d_model), 0)
    return tp_out(y @ p.out_proj.to(y.dtype), axes)


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], ... along axis 1 (even as long as odd, or
    one longer)."""
    n = odd.shape[1]
    pairs = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([pairs, even[:, n:]], dim=1) if even.shape[1] > n else pairs


def linear_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t along axis 1 (h_{-1} = 0),
    in ``jax.lax.associative_scan``'s order of combines.  Returns (the
    products of a, h)."""
    n = a.shape[1]
    if n < 2:
        return a, b
    # combine adjacent pairs, scan those, then fill in the even positions
    ra = a[:, 0:-1:2] * a[:, 1::2]
    rb = b[:, 0:-1:2] * a[:, 1::2] + b[:, 1::2]
    oa, ob = linear_scan(ra, rb)
    la, lb = (oa[:, :-1], ob[:, :-1]) if n % 2 == 0 else (oa, ob)
    ea = torch.cat([a[:, :1], la * a[:, 2::2]], dim=1)
    eb = torch.cat([b[:, :1], lb * a[:, 2::2] + b[:, 2::2]], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def rglru_train(p: RGLRU, cfg, x: torch.Tensor, *, return_state: bool = False):
    """x: (b, s, d) -> (b, s, d).  With ``return_state`` also the decode
    state after the last token, ``{"conv": (b, 3, dr), "h": (b, dr)
    float32}``."""
    dt = x.dtype
    # x enters the rank's channels (its gradient summed over their axes)
    x = tp_in(x, mesh_axes(RGLRU.SPECS["x_proj"], (cfg.d_model, cfg.rglru.d_rnn), 1))
    with whole_sequence():  # the sequence is whole from here to the output's sum
        gate = F.gelu(x @ p.gate_proj.to(dt), approximate="tanh")  # jax.nn.gelu's default
        xr_raw = x @ p.x_proj.to(dt)
        xr = causal_conv(xr_raw, p.conv_w.to(dt))
        a, b_in = _gates(p, cfg, xr)
        _, h = linear_scan(a, b_in)
    out = _out(p, cfg, h.to(dt) * gate)
    if not return_state:
        return out
    return out, {"conv": conv_tail(xr_raw, x.shape[1]), "h": h[:, -1]}


def init_rglru_state(cfg, batch: int, dtype, *, device=None, layers=None) -> dict:
    """Zeroed decode state: ``conv`` (b, 3, dr) in the activation dtype and
    ``h`` (b, dr) float32, with ``layers=L`` stacked on a leading L axis."""
    dr = cfg.rglru.d_rnn
    lead = () if layers is None else (layers,)
    return {"conv": torch.zeros(lead + (batch, CONV_W - 1, dr), dtype=dtype, device=device),
            "h": torch.zeros(lead + (batch, dr), dtype=torch.float32, device=device)}


def rglru_state_specs() -> dict:
    """Logical axes of one layer's :func:`init_rglru_state`."""
    return {"conv": ("batch", None, "mlp"), "h": ("batch", "mlp")}


def rglru_decode(p: RGLRU, cfg, x: torch.Tensor, state: dict):
    """One token: x (b, 1, d).  Returns (y (b, 1, d), the new state);
    ``state`` is only read."""
    dt = x.dtype
    gate = F.gelu(x @ p.gate_proj.to(dt), approximate="tanh")
    conv_in = torch.cat([state["conv"], x @ p.x_proj.to(dt)], dim=1)
    xr = conv_step(conv_in, p.conv_w.to(dt))  # (b, dr)
    a, b_in = _gates(p, cfg, xr)
    h = a * state["h"] + b_in
    return _out(p, cfg, h[:, None].to(dt) * gate), {"conv": conv_in[:, 1:], "h": h}
