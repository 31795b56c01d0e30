"""Mamba-2 SSD (state-space duality) mixer, chunked (torch port of
``repro.layers.ssd``).

The chunked algorithm of the SSD paper (arXiv:2405.21060): the intra-chunk
terms are dense contractions, and the state between chunks is carried by a
short loop over chunks (the reference's ``lax.scan``).  The depthwise causal
conv (width 4) is shifted adds, in the reference's order.  Decode keeps
(conv tail, SSM state) a layer and takes the O(1) step.

The contractions are plain ``torch.einsum``/matmul, as the reference's are
plain XLA: no TPU kernel computes them.  They sum in another order than
XLA's, so prefill, stepping and the reference agree within a tolerance
(``tests/test_torch_recurrent.py`` states it), not bit for bit.  One
deliberate difference: the intra-chunk decay is masked before its exp, so
the gradient stays finite where the reference's is NaN (ROADMAP C.28).

Tensor parallelism (a ``distributed.constraints`` scope with "heads" and
"heads_mix" over 'model'): each placed weight is the rank's block of the
reference's layout, so a block of ``in_proj``'s packed [z | x | B | C | dt]
columns, and of ``conv_w``'s and the conv state's [x | B | C] channels, does
not line up with heads.  A rank gathers the projection and ``conv_w``
(and in a decode step the conv state) over 'model', runs the conv on every
channel, keeps its own heads' z, x and dt and all of B and C, steps its
heads' SSM state, and writes back its block of the conv state; the output
projection's rows are its heads' channels, so the products are partial
sums, reduced over 'model'.

The head count is ``d_inner // head_dim`` (80 at mamba2-2.7b's full width),
not ``cfg.n_heads``.  ``a_log``, ``d_skip`` and ``dt_bias`` are kept in
float32 whatever the activation dtype: the reference reads its float32
masters there without a cast.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.constraints import (block_index, gather_dim, mesh_axes, mesh_parts,
                                                 tp_entry, tp_in, tp_out)
from repro_torch.layers.param import parameter

__all__ = ["CONV_W", "SSD", "causal_conv", "conv_step", "conv_tail", "init_ssd_state",
           "softplus", "ssd_decode", "ssd_state_specs", "ssd_train"]

CONV_W = 4


class SSD(nn.Module):
    """The mixer's weights in the reference's layout: in_proj (d, 2 d_in +
    2 n + nh), conv_w (4, d_in + 2 n), a_log, d_skip, dt_bias (nh,) and
    out_proj (d_in, d).  ``CONSTANT_START`` gives the reference's constant
    starts (``ones``/``zeros`` ignore the ``scale=0.25`` of conv_w);
    ``SPECS`` their logical axes."""

    SPECS = {"in_proj": ("embed", "heads_mix"), "conv_w": (None, "heads_mix"),
             "a_log": ("heads",), "d_skip": ("heads",), "dt_bias": ("heads",),
             "out_proj": ("heads_mix", "embed")}
    CONSTANT_START = {"conv_w": 1.0, "a_log": 0.0, "d_skip": 1.0, "dt_bias": 0.0}

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        s = cfg.ssm
        d, d_in, n = cfg.d_model, s.d_inner, s.d_state
        nh = d_in // s.head_dim
        self.in_proj = parameter((d, 2 * d_in + 2 * n + nh), dtype, device)
        self.conv_w = parameter((CONV_W, d_in + 2 * n), dtype, device)
        self.a_log = parameter((nh,), torch.float32, device)
        self.d_skip = parameter((nh,), torch.float32, device)
        self.dt_bias = parameter((nh,), torch.float32, device)
        self.out_proj = parameter((d_in, d), dtype, device)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (torch's ``F.softplus``
    turns into the identity above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv as shifted adds, the reference's order.
    x: (b, s, c), w: (4, c)."""
    out = x * w[CONV_W - 1]
    s = x.shape[1]
    for i in range(1, CONV_W):
        shifted = F.pad(x, (0, 0, i, 0))[:, :s]
        out = out + shifted * w[CONV_W - 1 - i]
    return out


def conv_step(conv_in: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One output of the conv over the last 4 inputs: the reference's
    ``einsum("bwc,wc->bc")``, summed in float32 and rounded once."""
    return (conv_in.float() * w.float()).sum(dim=1).to(conv_in.dtype)


class _Shards:
    """A rank's share of the mixer in the current scope: its heads [h0, h0 +
    nh) and their channels, the mesh axes its in_proj columns, conv_w
    channels and conv-state channels are gathered over, and the output
    projection's rows it multiplies (``out``, the slice of its heads'
    channels) with the axes their partial sums are reduced over.  Outside a
    scope: every head, no axes."""

    def __init__(self, p: "SSD", cfg):
        s = cfg.ssm
        d, d_in, n, hp = cfg.d_model, s.d_inner, s.d_state, s.head_dim
        nh = d_in // hp
        heads = mesh_axes(SSD.SPECS["a_log"], (nh,), 0)
        self.heads = heads
        self.nh = p.a_log.shape[0]
        self.h0 = block_index(heads) * self.nh if heads else 0
        self.proj = mesh_axes(SSD.SPECS["in_proj"], (d, 2 * d_in + 2 * n + nh), 1)
        self.conv = mesh_axes(SSD.SPECS["conv_w"], (CONV_W, d_in + 2 * n), 1)
        self.state = mesh_axes(ssd_state_specs()["conv"], (1, CONV_W - 1, d_in + 2 * n), 2)
        self.width = (d_in + 2 * n) // mesh_parts(self.state)
        self.c0 = block_index(self.state) * self.width if self.state else 0
        rows = mesh_axes(SSD.SPECS["out_proj"], (d_in, d), 0)
        if heads and rows and heads != rows:
            raise NotImplementedError(f"{cfg.name}: SSD heads over {heads}, out_proj rows over "
                                      f"{rows}")
        ch = slice(self.h0 * hp, (self.h0 + self.nh) * hp)
        if rows and not heads:  # every head here, a block of the rows
            r_l = p.out_proj.shape[0]
            ch = slice(block_index(rows) * r_l, (block_index(rows) + 1) * r_l)
        self.ch, self.out = ch, slice(ch.start - self.h0 * hp, ch.stop - self.h0 * hp)
        self.sum = heads or rows

    def reduce(self, y):
        return tp_out(y, self.sum)


def _split_proj(cfg, proj):
    s = cfg.ssm
    d_in, n = s.d_inner, s.d_state
    z, xbc_dt = proj[..., :d_in], proj[..., d_in:]
    return z, xbc_dt[..., : d_in + 2 * n], xbc_dt[..., d_in + 2 * n:]


def conv_tail(raw: torch.Tensor, slen: int) -> torch.Tensor:
    """The decode conv state after a prompt: the last 3 pre-conv inputs; a
    prompt shorter than 3 keeps the zero start in front."""
    tail = raw[:, -(CONV_W - 1):]
    if slen < CONV_W - 1:
        tail = F.pad(tail, (0, 0, CONV_W - 1 - slen, 0))
    return tail


def ssd_train(p: SSD, cfg, x: torch.Tensor, *, chunk: int = 128, return_state: bool = False):
    """x: (b, s, d) -> (b, s, d), any s >= 1.  The prompt is front-padded to a
    chunk multiple: zero tokens project to xs = B = C = 0, so they add
    nothing to the outputs or the state.  With ``return_state`` also the
    decode state after the last token, ``{"conv": (b, 3, d_in + 2n),
    "ssm": (b, nh, n, hp) float32}``."""
    s_cfg = cfg.ssm
    d_in, n, hp = s_cfg.d_inner, s_cfg.d_state, s_cfg.head_dim
    nh = d_in // hp
    # in training on a mesh x enters the rank's projection columns (its
    # gradient summed over their axes; under sequence parallelism the
    # rank's block of the sequence gathered)
    sh = _Shards(p, cfg)
    x = tp_in(x, sh.proj)
    b, slen, _ = x.shape
    chunk = min(chunk, slen)
    pad = (-slen) % chunk
    if pad:
        x = F.pad(x, (0, 0, pad, 0))
    slen_p = slen + pad
    dt_act = x.dtype

    if sh.proj:  # the rank's columns, gathered (the gradient reduce-scattered)
        proj = gather_dim(x @ p.in_proj.to(dt_act), sh.proj, -1)
    else:  # the whole projection, used for the rank's heads only
        proj = tp_entry(x @ p.in_proj.to(dt_act), sh.heads)
    z, xbc, dt = _split_proj(cfg, proj)
    xbc_raw = xbc  # the decode conv state is the tail of the pre-conv inputs
    conv_w = (gather_dim(p.conv_w, sh.conv, 1) if sh.conv
              else tp_entry(p.conv_w, sh.heads))
    xbc = F.silu(causal_conv(xbc, conv_w.to(dt_act)))
    hs = slice(sh.h0 * hp, (sh.h0 + sh.nh) * hp)
    xs, B, C = xbc[..., :d_in][..., hs], xbc[..., d_in: d_in + n], xbc[..., d_in + n:]
    z, dt, nh = z[..., hs], dt[..., sh.h0:sh.h0 + sh.nh], sh.nh

    dt = softplus(dt.float() + p.dt_bias.float())  # (b, s, nh)
    a = -torch.exp(p.a_log.float())
    log_decay = dt * a  # log a_t

    nc = slen_p // chunk
    xh = xs.reshape(b, nc, chunk, nh, hp)
    Bc = B.reshape(b, nc, chunk, n)
    Cc = C.reshape(b, nc, chunk, n)
    dtc = dt.reshape(b, nc, chunk, nh)
    cum = torch.cumsum(log_decay.reshape(b, nc, chunk, nh), dim=2)
    # intra-chunk: y[i] = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc).float()
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (b, nc, q, k, nh)
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    # masked before the exp (the reference masks after it): the upper
    # triangle's seg is a sum of -log decays, which passes exp's float32
    # range at full width, and exp's gradient there is 0 * inf = NaN in the
    # reference (ROADMAP C.28); the forward is the same bits either way
    L = torch.exp(torch.where(causal[None, None, :, :, None], seg, float("-inf")))
    W = scores[..., None] * L
    dtx = dtc[..., None] * xh.float()  # (b, nc, k, nh, hp)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", W, dtx)

    # chunk states: S_c = sum_j exp(cum_end - cum_j) dt_j B_j (x) x_j
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
    Sc = torch.einsum("bckn,bckhp->bchnp", Bc.float(), (dtc * decay_to_end)[..., None] * xh.float())

    # between chunks: the state entering each chunk
    total_decay = torch.exp(cum[:, :, -1, :])  # (b, nc, nh)
    state = torch.zeros((b, nh, n, hp), dtype=torch.float32, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * total_decay[:, c, :, None, None] + Sc[:, c]
    S_in = torch.stack(entering, dim=1)  # (b, nc, nh, n, hp)

    # y[i] += C_i . (exp(cum_i) S_in)
    y_inter = torch.einsum("bcqn,bchnp->bcqhp", Cc.float(), S_in) * torch.exp(cum)[..., None]

    y = (y_intra + y_inter).reshape(b, slen_p, nh, hp)
    y = y + p.d_skip.float()[None, None, :, None] * xs.reshape(b, slen_p, nh, hp).float()
    y = y.reshape(b, slen_p, nh * hp).to(dt_act) * F.silu(z)
    out = sh.reduce((y[..., sh.out] @ p.out_proj.to(dt_act))[:, pad:])
    if not return_state:
        return out
    tail = conv_tail(xbc_raw, slen)[..., sh.c0:sh.c0 + sh.width]
    return out, {"conv": tail, "ssm": state}


def init_ssd_state(cfg, batch: int, dtype, *, device=None, layers=None) -> dict:
    """Zeroed decode state: ``conv`` (b, 3, d_in + 2n) in the activation
    dtype and ``ssm`` (b, nh, n, hp) float32, with ``layers=L`` stacked on a
    leading L axis."""
    s = cfg.ssm
    nh = s.d_inner // s.head_dim
    lead = () if layers is None else (layers,)
    return {
        "conv": torch.zeros(lead + (batch, CONV_W - 1, s.d_inner + 2 * s.d_state), dtype=dtype,
                            device=device),
        "ssm": torch.zeros(lead + (batch, nh, s.d_state, s.head_dim), dtype=torch.float32,
                           device=device),
    }


def ssd_state_specs() -> dict:
    """Logical axes of one layer's :func:`init_ssd_state`."""
    return {"conv": ("batch", None, "heads_mix"), "ssm": ("batch", "heads", None, None)}


def ssd_decode(p: SSD, cfg, x: torch.Tensor, state: dict):
    """One token: x (b, 1, d), ``state`` as :func:`init_ssd_state` gives one
    layer's.  Returns (y (b, 1, d), the new state); ``state`` is only read."""
    s_cfg = cfg.ssm
    d_in, n, hp = s_cfg.d_inner, s_cfg.d_state, s_cfg.head_dim
    nh = d_in // hp
    b = x.shape[0]
    dt_act = x.dtype

    sh = _Shards(p, cfg)
    proj = gather_dim(x @ p.in_proj.to(dt_act), sh.proj, -1)
    z, xbc, dt = _split_proj(cfg, proj)
    conv_in = torch.cat([gather_dim(state["conv"], sh.state, -1), xbc], dim=1)  # (b, 4, c)
    conv_out = F.silu(conv_step(conv_in, gather_dim(p.conv_w, sh.conv, 1).to(dt_act)))

    hs, nh = slice(sh.h0 * hp, (sh.h0 + sh.nh) * hp), sh.nh
    xs = conv_out[:, :d_in][:, hs].reshape(b, nh, hp).float()
    B = conv_out[:, d_in: d_in + n].float()
    C = conv_out[:, d_in + n:].float()
    dtv = softplus(dt[:, 0, sh.h0:sh.h0 + nh].float() + p.dt_bias.float())  # (b, nh)
    a = torch.exp(dtv * -torch.exp(p.a_log.float()))

    h = state["ssm"] * a[..., None, None] + B[:, None, :, None] * (dtv[..., None] * xs)[:, :, None]
    y = torch.einsum("bn,bhnp->bhp", C, h)
    y = y + p.d_skip.float()[None, :, None] * xs
    y = y.reshape(b, 1, nh * hp).to(dt_act) * F.silu(z[..., hs])
    return (sh.reduce(y[..., sh.out] @ p.out_proj.to(dt_act)),
            {"conv": conv_in[:, 1:, sh.c0:sh.c0 + sh.width], "ssm": h})
