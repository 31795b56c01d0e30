"""Mixture of experts: top-k routing with the capacity-factor dense dispatch
(torch port of ``repro.layers.moe``).

Each batch row is a routing group with capacity ``C = max(k, int(cf * s * k
/ E))``, the reference's float expression: a (token, choice) pair's slot in
its expert's buffer is its rank among the row's choices of that expert in
token-major ``(s * k)`` order, and pairs at or past ``C`` are dropped.  One-
hot (b, s, E, C) dispatch and combine masks in the activation dtype gather
the tokens into (b, E, C, d) expert buffers, the SwiGLU expert FFN runs
batched over the expert axis, and the combine mask, weighted by the
renormalised gates, brings the outputs back.  The router runs in float32.

On a mesh (``distributed.constraints`` scope) the router stays replicated
and routes the full hidden state, each row on its own, as above.  Under
tensor parallelism ("mlp" over 'model') a rank holds a block of every
expert's hidden units, and the combined outputs are partial sums, reduced
over 'model'.  With "expert" over a mesh axis (qwen3-moe-235b-a22b's
``rules["expert"] = "data"``) a rank holds E/n experts: the dispatched
buffers of the rows that share the axis are gathered (every row of the data
group reaches the rank's experts), the rank's experts run on them, and the
outputs, summed over the axis, come back to each row's rank.  Capacity
stays per batch row.

In training (``train_rules``) experts go over 'model' where it divides
them, else their hidden units do (mixtral-8x22b's 8 experts on a 16-wide
axis): the buffers and combine weights enter the rank's share through
``constraints.tp_entry``, and the load-balance loss's means run over the
whole batch (the rows' sums and counts summed over the data axes: the
loss is a product of two means, so a mean of each rank's would be another
number).

The one-hots compare with an ``arange`` and the top-k is a stable
descending sort: no host read and no data-dependent shape, so the routing
can be captured in a CUDA graph, and ties go to the lower expert index as
``jax.lax.top_k`` breaks them, on the CPU and the card alike.  The products
are plain ``einsum`` s, as the reference's are XLA's; a gathered dispatch is
a speed item (ROADMAP B).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.distributed.constraints import (block_index, block_origin, constrain,
                                                 data_axes, gather_dim, mesh_axes, mesh_parts,
                                                 reduce_sum, tp_entry)
from repro_torch.layers.param import parameter

__all__ = ["MoE", "capacity", "moe_apply", "route"]


class MoE(nn.Module):
    """Weights in the reference's layout: router (d, E), wi_gate and wi_up
    (E, d, f), wo (E, f, d); ``SPECS`` their logical axes."""

    SPECS = {"router": ("embed", None), "wi_gate": ("expert", "embed", "mlp"),
             "wi_up": ("expert", "embed", "mlp"), "wo": ("expert", "mlp", "embed")}

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        d, f, e = cfg.d_model, cfg.moe.d_ff_expert, cfg.moe.n_experts
        self.router = parameter((d, e), dtype, device)
        self.wi_gate = parameter((e, d, f), dtype, device)
        self.wi_up = parameter((e, d, f), dtype, device)
        self.wo = parameter((e, f, d), dtype, device)


def capacity(cfg, s: int, capacity_factor: float) -> int:
    """Slots an expert has in a routing group (a batch row) of ``s`` tokens."""
    k = cfg.moe.top_k
    return max(k, int(capacity_factor * s * k / cfg.moe.n_experts))


def route(router: torch.Tensor, x: torch.Tensor, k: int, cap: int, choices=None):
    """The router's choices for x (b, s, d): (probs (b, s, E) float32, gates
    (b, s, k) float32 renormalised, experts (b, s, k), positions (b, s, k)
    in the experts' buffers, keep (b, s, k) bool: position < ``cap``).
    ``choices`` ((b, s, k) expert ids) takes the place of the top-k, the
    gates then those experts' probabilities: two routes of one model that
    round a hidden state one ulp apart can be held to one routing."""
    b, s, _ = x.shape
    e = router.shape[1]
    probs = torch.softmax(torch.einsum("bsd,de->bse", x.float(), router.float()), dim=-1)
    if choices is None:
        gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates, idx = gates[..., :k], idx[..., :k]
    else:
        idx = choices
        gates = probs.gather(-1, idx)
    gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-9)
    onehot = (idx[..., None] == torch.arange(e, device=x.device)).to(torch.int32)  # (b, s, k, E)
    flat = onehot.reshape(b, s * k, e)
    before = (torch.cumsum(flat, dim=1) - flat).reshape(b, s, k, e)
    pos = (before * onehot).sum(dim=-1)
    return probs, gates, idx, pos, pos < cap


def moe_apply(p: MoE, cfg, x: torch.Tensor, *, capacity_factor: float = 1.25,
              whole_batch_aux: bool = False):
    """x (b, s, d) -> (y (b, s, d), the Switch load-balance aux loss, a
    float32 scalar ``E * sum(me * ce)``).  ``whole_batch_aux`` (the training
    forward): in a scope whose data axes shard the batch, the aux's means
    run over the whole batch, its sums and counts all-reduced over those
    axes (serving leaves it unset: an admission runs on the ranks holding
    its slot only, and drops the aux)."""
    b, s, _ = x.shape
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    dt = x.dtype
    cap = capacity(cfg, s, capacity_factor)
    probs, gates, idx, pos, keep = route(p.router, x, k, cap)
    experts = torch.arange(e, device=x.device)
    slots = torch.arange(cap, device=x.device)
    dispatch = x.new_zeros((b, s, e, cap))
    combine = x.new_zeros((b, s, e, cap))
    for j in range(k):  # accumulated over the choices: no (k, E, C) tensor
        oh_e = (idx[..., j, None] == experts).to(dt)
        oh_c = (pos[..., j, None] == slots).to(dt)
        m = keep[..., j, None, None].to(dt) * oh_e[..., None] * oh_c[..., None, :]
        dispatch = dispatch + m
        combine = combine + m * gates[..., j, None, None].to(dt)
    dispatch = constrain(dispatch, ("batch", None, "expert", None))
    combine = constrain(combine, ("batch", None, "expert", None))
    xe = torch.einsum("bsec,bsd->becd", dispatch, x)
    xe = constrain(xe, ("batch", "expert", None, None))
    # on a mesh: the rank's experts (a block over ``ex``) and hidden units
    # (a block over ``hid``), and the rows that share ``ex`` gathered
    f = cfg.moe.d_ff_expert
    ex = mesh_axes(MoE.SPECS["wi_gate"], (e, cfg.d_model, f), 0)
    hid = mesh_axes(MoE.SPECS["wo"], (e, f, cfg.d_model), 1)
    # the buffers and the combine weights, replicated over the axes that
    # split the experts or their hidden units, enter the rank's share there
    split = ex + tuple(a for a in hid if a not in ex)
    xe, combine = tp_entry(xe, split), tp_entry(combine, split)
    rows = ()
    if ex:
        whole = block_origin(("batch",), (b,))[1][0]
        if whole != b:  # the rows are a block: gather the ones sharing ``ex``
            rows = tuple(a for a in mesh_axes(("batch",), (whole,), 0) if a in ex)
        e_l = p.wi_gate.shape[0]
        e0 = block_index(ex) * e_l
        xe = gather_dim(xe, rows, 0)[:, e0:e0 + e_l]
        combine = gather_dim(combine, rows, 0)[:, :, e0:e0 + e_l]
    g = torch.einsum("becd,edf->becf", xe, p.wi_gate.to(dt))
    u = torch.einsum("becd,edf->becf", xe, p.wi_up.to(dt))
    ye = torch.einsum("becf,efd->becd", torch.nn.functional.silu(g) * u, p.wo.to(dt))
    y = torch.einsum("becd,bsec->bsd", ye, combine)
    if split:  # the addends of the experts and hidden units the rank holds
        y = reduce_sum(y, split)
        if rows:
            r0 = block_index(rows) * b
            y = y[r0:r0 + b]
    chosen = (idx[..., None] == experts).any(dim=2).float()
    data = data_axes() if whole_batch_aux else ()
    if not data:
        me, ce = probs.mean(dim=(0, 1)), chosen.mean(dim=(0, 1))
    else:  # means over the whole batch: the rows' sums and counts over the data axes
        n = probs.new_full((), float(b * s * mesh_parts(data)))
        me = reduce_sum(probs.sum(dim=(0, 1)), data) / n
        ce = reduce_sum(chosen.sum(dim=(0, 1)), data) / n
    return y, e * torch.sum(me * ce)
