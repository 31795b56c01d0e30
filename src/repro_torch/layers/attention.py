"""Grouped-query attention with QK-norm (through the configured sqrt unit),
RoPE, a differentiable full-sequence path for training in the causal,
sliding-window, bidirectional and cross modes, a decode path over a float or
int8 KV cache, and the encoder-decoder's cross-attention over precomputed
encoder K/V (torch port of ``repro.layers.attention``).

Shapes follow the reference's (batch, seq, heads, head_dim) convention.  The
cache is a dict of tensors; with ``layer_idx`` each tensor carries a leading
stacked-layers axis ``(L, b, t, kv, hd)``.  Unlike the functional reference,
cache writes here happen IN PLACE on the given tensors (one token line per
decode step, tokens [0, s) at prefill); the functions still return the
cache dict so call sites read the same as the reference's.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.constraints import (block_index, constrain, current_rules,
                                                 mesh_axes, mesh_parts, tp_entry, tp_in, tp_out)
from repro_torch.layers.norms import rmsnorm_cfg
from repro_torch.layers.param import parameter
from repro_torch.layers.rope import rope_tables, rotate

__all__ = [
    "Attention",
    "attention_train",
    "attention_prefill",
    "attention_decode",
    "attention_verify",
    "cross_attention_decode",
    "gather_verify_lines",
    "init_kv_cache",
    "kv_cache_specs",
    "precompute_cross_kv",
    "verify_cache_commit",
]

NEG_INF = -2.0e38


class Attention(nn.Module):
    """wq (d, h, hd), wk/wv (d, kv, hd), wo (h, hd, d), and with qk-norm the
    (hd,) scales q_norm/k_norm, as in the reference; ``SPECS`` their
    logical axes."""

    SPECS = {"wq": ("embed", "heads", None), "wk": ("embed", "kv_heads", None),
             "wv": ("embed", "kv_heads", None), "wo": ("heads", None, "embed"),
             "q_norm": (None,), "k_norm": (None,)}

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        self.wq = parameter((d, h, hd), dtype, device)
        self.wk = parameter((d, kv, hd), dtype, device)
        self.wv = parameter((d, kv, hd), dtype, device)
        self.wo = parameter((h, hd, d), dtype, device)
        if cfg.qk_norm:
            self.q_norm = parameter((hd,), dtype, device)
            self.k_norm = parameter((hd,), dtype, device)


def _Q_SITE(cfg) -> dict:
    """A query qk-norm's logical axes and heads, for its fault hash on a
    mesh."""
    return {"axes": ("batch", "seq", "heads", None), "extents": {"heads": cfg.n_heads}}


def _K_SITE(cfg) -> dict:
    return {"axes": ("batch", "seq", "kv_heads", None), "extents": {"kv_heads": cfg.n_kv_heads}}


def local_kv_heads(cfg, q_parts: int, q_index: int, kv_parts: int,
                   kv_index: Optional[int] = None):
    """(first, count) of the KV heads, within the rank's block of them, that
    the query heads of block ``q_index`` of ``q_parts`` read, when the KV
    heads are in ``kv_parts`` blocks (the rank's block ``kv_index``; default:
    the block those query heads read); None when they read the rank's whole
    block (q and KV heads sharded alike, or neither).  Query head ``j``
    reads KV head ``j // G``: a block of ``h / q_parts`` query heads reads
    ``h / (q_parts G)`` whole KV heads, or one KV head when its group is
    wider than the block (G = 10 over two ranks: 5 query heads a rank, the
    local group 5; G = 4 over query heads in 16 blocks and KV heads in 8, the
    reference's (kv, qg) decode mesh: the rank's one KV head).  A block that
    straddles KV heads unevenly, or reads KV heads outside the rank's block,
    raises."""
    if q_parts == kv_parts:
        return None
    h, kv = cfg.n_heads, cfg.n_kv_heads
    g, h_l, kv_l = h // kv, h // q_parts, kv // kv_parts
    h0 = q_index * h_l
    if h_l % g == 0:
        first, count = h0 // g, h_l // g
    elif g % h_l == 0:
        first, count = h0 // g, 1
    else:
        raise NotImplementedError(
            f"{cfg.name}: {h_l} query heads a rank straddle the KV heads ({h} query heads over "
            f"{kv} KV heads, {g} a KV head)")
    if kv_index is None:
        kv_index = first // kv_l
    first -= kv_index * kv_l
    if first < 0 or first + count > kv_l:
        raise NotImplementedError(f"{cfg.name}: query heads in {q_parts} blocks read KV heads "
                                  f"outside the rank's block of {kv_parts}")
    if kv_parts > 1 and (first, count) == (0, kv_l):
        return None
    return first, count


def rank_kv_heads(cfg, q_index=None):
    """(q_parts, kv_parts, selection) in the current scope: the blocks the
    rules cut the query heads and the KV heads into, and
    :func:`local_kv_heads` of block ``q_index`` of query heads (default:
    this rank's, over this rank's block of KV heads); (1, 1, None) outside a
    scope."""
    if current_rules() is None:
        return 1, 1, None
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    qa = mesh_axes(Attention.SPECS["wq"], (d, h, hd), 1)
    ka = mesh_axes(Attention.SPECS["wk"], (d, kv, hd), 1)
    q_parts, kv_parts = mesh_parts(qa), mesh_parts(ka)
    kv_index = None
    if q_index is None:
        q_index, kv_index = block_index(qa), block_index(ka)
    return q_parts, kv_parts, local_kv_heads(cfg, q_parts, q_index, kv_parts, kv_index)


def _rank_kv(cfg, *tensors):
    """The KV heads (dim 2) of ``tensors`` that this rank's query heads
    read, in a scope that shards the query heads and replicates the KV
    heads (gemma3-1b's and recurrentgemma-2b's one KV head over 'model');
    the tensors themselves elsewhere.  A strict subset is copied contiguous
    (the kernel takes contiguous planes)."""
    sel = rank_kv_heads(cfg)[2]
    if sel is None or sel == (0, cfg.n_kv_heads):
        return tensors
    k0, n = sel
    return tuple(None if t is None else t[:, :, k0:k0 + n].contiguous() for t in tensors)


def _project(x: torch.Tensor, w: torch.Tensor, mm=torch.matmul) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one contiguous matmul (``mm``)."""
    b, s, d = x.shape
    return mm(x, w.to(x.dtype).reshape(d, -1)).view(b, s, w.shape[1], w.shape[2])


def _project_qkv(p: Attention, cfg, xq, xkv, q_positions, kv_positions, *, use_rope,
                 fused_norm=True, norm_levels=None, mm=torch.matmul, split=(), kv_split=()):
    """q, k and v of the query and K/V inputs, qk-normed and rotated.  In
    training, ``split``: the mesh axes that split the query heads, over
    which the replicated qk-norm scales, used for the rank's heads only,
    have their gradients summed; ``kv_split``: those of them that do not
    split the KV heads, over which wk and wv, replicated and used for the
    rank's query heads only, have theirs summed."""
    q = _project(xq, p.wq, mm)
    k = _project(xkv, tp_entry(p.wk, kv_split), mm)
    v = _project(xkv, tp_entry(p.wv, kv_split), mm)
    if cfg.qk_norm:
        q = rmsnorm_cfg(tp_entry(p.q_norm, split), q, cfg, fused=fused_norm, levels=norm_levels,
                        **_Q_SITE(cfg))
        k = rmsnorm_cfg(tp_entry(p.k_norm, split), k, cfg, fused=fused_norm,
                        levels=norm_levels, **_K_SITE(cfg))
    if use_rope:
        q_tables = rope_tables(q_positions, q.shape[-1], theta=cfg.rope_theta)
        kv_tables = q_tables if kv_positions is q_positions else rope_tables(
            kv_positions, k.shape[-1], theta=cfg.rope_theta)
        q = rotate(q, *q_tables)
        k = rotate(k, *kv_tables)
    return q, k, v


def _out_proj(out: torch.Tensor, wo: torch.Tensor, mm=torch.matmul, cfg=None) -> torch.Tensor:
    """einsum("bshk,hkd->bsd").  With ``cfg`` in a tensor-parallel scope,
    where a rank holds a block of the heads, its partial sums are reduced
    over the mesh axes that shard them."""
    b, s, h, hd = out.shape
    y = mm(out.reshape(b, s, h * hd), wo.to(out.dtype).reshape(h * hd, -1))
    if cfg is None:
        return y
    return tp_out(y, mesh_axes(Attention.SPECS["wo"], (cfg.n_heads, cfg.d_head, cfg.d_model), 0))


def _constrain_qkv(q, k, v):
    return (constrain(q, ("batch", "seq", "heads", None)),
            constrain(k, ("batch", "seq", "kv_heads", None)),
            constrain(v, ("batch", "seq", "kv_heads", None)))


def _mask(mode, q_pos, kv_pos, window):
    """(q, kv) additive float32 mask from position vectors."""
    d = q_pos[:, None] - kv_pos[None, :]
    if mode == "causal":
        ok = d >= 0
    elif mode == "window":  # causal sliding window
        ok = (d >= 0) & (d < window)
    elif mode in ("bidir", "cross"):
        ok = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    else:
        raise ValueError(mode)
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def _expand_kv(k, h):
    """Broadcast kv heads up to h query heads (``jnp.repeat`` on axis 2)."""
    g = h // k.shape[2]
    return k if g == 1 else k.repeat_interleave(g, dim=2)


def _softmax(x):
    """jax.nn.softmax's order: exp(x - max) / sum."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


class _Softmax(torch.autograd.Function):
    """``jax.nn.softmax`` on float32 scores: the forward of :func:`_softmax`,
    and the reference's derivative ``y * t - y * sum(y * t)`` (its
    ``custom_jvp``, transposed).  Saves only y."""

    @staticmethod
    def forward(ctx, x):
        y = _softmax(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, t):
        (y,) = ctx.saved_tensors
        c = y * t
        return c - y * c.sum(dim=-1, keepdim=True)


def _scores(q, k, mask, scale, sdt):
    """Attention scores in ``sdt`` times the exact ``scale``, plus the mask
    (the tensor the reference names "attn_scores")."""
    scores = torch.einsum("bshk,bthk->bhst", q, _expand_kv(k, q.shape[2])).to(sdt) * scale
    return scores + mask.to(sdt)[None, None]


def _scored_attention(q, k, v, mask, scale, sdt, out_dtype, *, remat_scores=False):
    """The training block (the reference's ``_gqa_scores`` ->
    ``_softmax_scores`` -> ``_gqa_out``): :func:`_scores`, softmax, weights
    cast to ``out_dtype`` before the V product.  q: (b, sq, h, hd); k/v:
    (b, t, kv, hd); mask: (sq, t).  ``remat_scores`` (selective remat,
    ``remat="minimal"``) recomputes the scores in the backward pass instead
    of keeping what their computation saves, as the reference's policy
    keeps every residual but "attn_scores"."""
    if remat_scores:
        scores = checkpoint(_scores, q, k, mask, scale, sdt, use_reentrant=False)
    else:
        scores = _scores(q, k, mask, scale, sdt)
    w = _Softmax.apply(scores).to(out_dtype)
    return torch.einsum("bhst,bthk->bshk", w, _expand_kv(v, q.shape[2]))


def attention_train(p: Attention, cfg, x, *, mode: str = "causal",
                    window: Optional[int] = None, kv_x=None, positions=None, kv_positions=None,
                    q_chunk: int = 1024):
    """Full-sequence attention for training (the reference's
    ``attention_train``), differentiable; writes no cache.  x: (b, s, d);
    mode "causal", "window", "bidir" (the encoder's) or "cross" (``kv_x``
    (b, t, d), the encoder's output, gives K/V, and RoPE is not applied);
    positions (s,) and kv_positions (t,), default ``arange``.  QK-norm runs
    unfused through the unit's differentiable datapath.  Sequences longer
    than ``q_chunk`` (and a multiple of it) process queries in chunks, as the
    reference's ``_chunked_attention``: each chunk against the whole K/V, or
    in "window" mode against a band of ``window + q_chunk`` lines (K/V
    left-padded by ``window`` lines at position ``-10**9``, which the mask
    drops), so the scores are ``(b, h, q_chunk, window + q_chunk)``; other
    lengths (whisper's 1500 frames) take one block of (b, h, s, t) scores.

    In training on a mesh x enters the rank's heads through
    ``constraints.tp_in`` (its gradient summed over the axes that split
    them; under sequence parallelism the rank's block of the sequence is
    gathered), ``kv_x`` (the encoder's output, whole on every rank) through
    ``tp_entry``, and the output leaves through ``tp_out``.  K/V heads
    replicated over an axis that splits the query heads are computed whole
    on every rank and read by the rank's query heads only: their weights'
    gradients are summed over that axis."""
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    split = mesh_axes(Attention.SPECS["wq"], (d, h, hd), 1)
    kv_split = tuple(a for a in split
                     if a not in mesh_axes(Attention.SPECS["wk"], (d, kvh, hd), 1))
    x = tp_in(x, split)
    xkv = x if kv_x is None else tp_entry(kv_x, split)
    s = x.shape[1]
    pos = positions if positions is not None else torch.arange(s, device=x.device)
    kp = kv_positions if kv_positions is not None else (
        pos if kv_x is None else torch.arange(xkv.shape[1], device=x.device))
    q, k, v = _project_qkv(p, cfg, x, xkv, pos, kp,
                           use_rope=cfg.pos == "rope" and mode != "cross", fused_norm=False,
                           split=split, kv_split=kv_split)
    k, v = _rank_kv(cfg, k, v)
    scale = cfg.d_head**-0.5
    sdt = getattr(torch, cfg.scores_dtype)
    remat = cfg.remat == "minimal"
    if s <= q_chunk or s % q_chunk:
        return _out_proj(_scored_attention(q, k, v, _mask(mode, pos, kp, window), scale, sdt,
                                           x.dtype, remat_scores=remat), p.wo, cfg=cfg)
    banded = mode == "window" and window is not None
    if banded:  # in padded coordinates chunk i's band is [i * q_chunk, i * q_chunk + band)
        band = window + q_chunk
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, window, 0))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, window, 0))
        kp = torch.cat([kp.new_full((window,), -(10**9)), kp])
    chunks = []
    for i in range(s // q_chunk):
        sl = slice(i * q_chunk, (i + 1) * q_chunk)
        kv_sl = slice(i * q_chunk, i * q_chunk + band) if banded else slice(None)
        chunks.append(_scored_attention(q[:, sl], k[:, kv_sl], v[:, kv_sl],
                                        _mask(mode, pos[sl], kp[kv_sl], window), scale, sdt,
                                        x.dtype, remat_scores=remat))
    return _out_proj(torch.cat(chunks, dim=1), p.wo, cfg=cfg)


def _fold_masked_attention(q, k, v, mask, scale, k_scale, v_scale, out_dtype):
    """The decode-contract scored-attention block, shared by
    :func:`attention_decode` and :func:`attention_prefill`: float32 scores,
    int8 cache scales FOLDED into scores / weights, additive float32 mask,
    float32 softmax, weights cast to ``out_dtype`` before the V product.

    q: (b, sq, h, hd); k/v: (b, t, kv, hd) in ``out_dtype``; mask: (sq, t),
    or (b, sq, t) when validity is per batch row; scales: (b, t, kv) or None.
    Returns (b, sq, h, hd).
    """
    h = q.shape[2]
    g = h // k.shape[2]
    scores = torch.einsum("bshk,bthk->bhst", q, _expand_kv(k, h)).float() * scale
    if k_scale is not None:
        ks = k_scale.transpose(1, 2).repeat_interleave(g, dim=1)  # (b, h, t)
        scores = scores * ks[:, :, None, :]
    scores = scores + (mask[None, None] if mask.ndim == 2 else mask[:, None])
    w = _softmax(scores).to(out_dtype)
    if v_scale is not None:
        vs = v_scale.transpose(1, 2).repeat_interleave(g, dim=1)
        w = w * vs[:, :, None, :].to(w.dtype)
    return torch.einsum("bhst,bthk->bshk", w, _expand_kv(v, h))


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def init_kv_cache(cfg, batch, cache_len, dtype, *, quantized: bool = False, device=None,
                  layers: Optional[int] = None):
    """One layer's cache, or with ``layers=L`` the stacked (L, ...) cache.
    quantized=True stores int8 K/V plus per (b, t, kv) float32 scales."""
    lead = () if layers is None else (layers,)
    shape = lead + (batch, cache_len, cfg.n_kv_heads, cfg.d_head)
    if quantized:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            "v_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        }
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def kv_cache_specs(quantized: bool = False) -> dict:
    """Logical axes of one layer's :func:`init_kv_cache`."""
    base = {"k": ("batch", "kv_seq", "kv_heads", "kv_dim"),
            "v": ("batch", "kv_seq", "kv_heads", "kv_dim")}
    if quantized:
        base["k_scale"] = ("batch", "kv_seq", "kv_heads")
        base["v_scale"] = ("batch", "kv_seq", "kv_heads")
    return base


def _quantize_kv(x):
    """Per (…, head) absmax int8 quantisation over head_dim.  The rounded
    values are clamped to int8's range, the saturating conversion of the
    reference's ``astype(int8)``."""
    scale = x.abs().amax(dim=-1) / 127.0 + 1e-8
    q = torch.round(x / scale[..., None]).clamp(-128, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _plane(buf, layer_idx):
    return buf if layer_idx is None else buf[layer_idx]


def _write_line(buf, new, slot, layer_idx):
    """Write one token line in place: ``slot`` an int (every row) or a (b,)
    tensor (row ``i`` at ``slot[i]``)."""
    plane = _plane(buf, layer_idx)
    if isinstance(slot, int):
        plane[:, slot] = new.to(buf.dtype)
    else:
        plane[torch.arange(new.shape[0], device=new.device), slot] = new.to(buf.dtype)


def _prefill_write_entries(cache, entries, *, layer_idx, ring):
    """Land per-buffer (b, s, ...) prompt tensors at tokens [0, s).  Only ring
    buffers may be shorter than the prompt: there the last ``cache_len``
    tokens survive, rolled so token ``pos`` sits at slot ``pos % cache_len``."""
    cache_len = _plane(cache["k"], layer_idx).shape[1]
    s = entries["k"].shape[1]
    if s > cache_len:
        if not ring:
            raise ValueError(
                f"prompt ({s} tokens) does not fit a non-ring cache of "
                f"length {cache_len}; allocate >= prompt_len + gen_len slots"
            )
        shift = s % cache_len  # slot of the oldest surviving token
        entries = {name: torch.roll(a[:, -cache_len:], shift, dims=1)
                   for name, a in entries.items()}
    for name, a in entries.items():
        _plane(cache[name], layer_idx)[:, : a.shape[1]] = a.to(cache[name].dtype)
    return cache


def _quantized_entries(k_new, v_new):
    kq, ks = _quantize_kv(k_new)
    vq, vs = _quantize_kv(v_new)
    return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------


def attention_prefill(p: Attention, cfg, x, cache, positions, *, window: Optional[int] = None,
                      layer_idx=None, q_chunk: int = 1024):
    """Full-sequence causal (or sliding-window) attention over the prompt that
    also writes tokens [0, s) of the KV cache.  x: (b, s, d); positions: (s,).
    Attention runs over the in-flight K/V through the same scored-attention
    block as :func:`attention_decode`.  Prompts longer than ``q_chunk`` (and a
    multiple of it) process queries in chunks.  Returns (out, cache)."""
    s = x.shape[1]
    use_rope = cfg.pos == "rope"
    q, k, v = _constrain_qkv(*_project_qkv(p, cfg, x, x, positions, positions,
                                           use_rope=use_rope))
    ring = window is not None
    k_scale = v_scale = None
    if cache["k"].dtype == torch.int8:
        # quantize ONCE: the written entries and the scoring K/V share it
        entries = _quantized_entries(k, v)
        _prefill_write_entries(cache, entries, layer_idx=layer_idx, ring=ring)
        k, v = entries["k"].to(x.dtype), entries["v"].to(x.dtype)
        k_scale, v_scale = entries["k_scale"], entries["v_scale"]
    else:
        _prefill_write_entries(cache, {"k": k, "v": v}, layer_idx=layer_idx, ring=ring)

    k, v, k_scale, v_scale = _rank_kv(cfg, k, v, k_scale, v_scale)
    scale = cfg.d_head**-0.5
    mode = "window" if window else "causal"
    if s <= q_chunk or s % q_chunk:
        mask = _mask(mode, positions, positions, window)
        out = _fold_masked_attention(q, k, v, mask, scale, k_scale, v_scale, x.dtype)
    else:
        chunks = []
        for i in range(s // q_chunk):
            sl = slice(i * q_chunk, (i + 1) * q_chunk)
            m = _mask(mode, positions[sl], positions, window)
            chunks.append(_fold_masked_attention(q[:, sl], k, v, m, scale, k_scale, v_scale,
                                                 x.dtype))
        out = torch.cat(chunks, dim=1)
    return _out_proj(out, p.wo, cfg=cfg), cache


def attention_decode(p: Attention, cfg, x, cache, pos, *, window: Optional[int] = None,
                     layer_idx=None, kernel: Optional[str] = None, norm_levels=None):
    """Single-token decode.  x: (b, 1, d); the cache holds ``cache_len`` slots
    and is written in place.

    ``pos`` is an int (lock-step batch, every row at one position; a 0-dim
    tensor is read to the host) or a (b,) int tensor (each row its own
    position: RoPE, the ring-buffer write index and the validity mask follow
    per row).

    ``kernel`` routes the scored-attention block (defaults to
    ``cfg.decode_kernel``): "fused" runs the decode-attention kernel through
    the dispatch layer (the CUDA kernel for CUDA tensors); None (the inline
    path) and "reference" run its plain version.  ``norm_levels`` ((b,)
    int32, accuracy-SLO decode): each row's qk-norm rsqrt through its rung of
    ``cfg.sqrt_ladder``.  Returns (out, cache).
    """
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"attention_decode takes one token per row, got {s}")
    cache_len = _plane(cache["k"], layer_idx).shape[1]
    if isinstance(pos, torch.Tensor) and pos.ndim == 0:
        pos = int(pos)
    per_slot = isinstance(pos, torch.Tensor)

    if per_slot:
        pos = pos.to(device=x.device, dtype=torch.int32)
        rope_pos = pos[:, None]
        slot = (pos % cache_len).long()
    else:
        rope_pos = torch.full((1,), pos, dtype=torch.int32, device=x.device)
        slot = pos % cache_len
    q, k_new, v_new = _constrain_qkv(*_project_qkv(p, cfg, x, x, rope_pos, rope_pos,
                                                   use_rope=cfg.pos == "rope",
                                                   norm_levels=norm_levels))

    pos_b = pos if per_slot else torch.full((b,), pos, dtype=torch.int32, device=x.device)
    out = _write_and_attend(cfg, cache, q[:, 0], k_new[:, 0], v_new[:, 0], pos_b, slot,
                            window=window, layer_idx=layer_idx, kernel=kernel)
    return _out_proj(out[:, None], p.wo, cfg=cfg), cache


def _write_and_attend(cfg, cache, q, k_new, v_new, pos_b, slot, *, window, layer_idx, kernel):
    """One decode step's cache write and attention: land each row's token
    line (k_new/v_new (b, kv, hd); an int8 cache quantizes it first) at
    ``slot`` in place, then attend q (b, h, hd) over the cache at the
    per-row positions ``pos_b`` ((b,) int32).  ``kernel`` as in
    :func:`attention_decode`.  Returns (b, h, hd)."""
    k_scale = v_scale = None
    if cache["k"].dtype == torch.int8:
        kq, ks = _quantize_kv(k_new)
        vq, vs = _quantize_kv(v_new)
        for name, new in (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs)):
            _write_line(cache[name], new, slot, layer_idx)
        k_scale = _plane(cache["k_scale"], layer_idx)  # (b, t, kv)
        v_scale = _plane(cache["v_scale"], layer_idx)
    else:
        _write_line(cache["k"], k_new, slot, layer_idx)
        _write_line(cache["v"], v_new, slot, layer_idx)
    k = _plane(cache["k"], layer_idx)
    v = _plane(cache["v"], layer_idx)
    k, v, k_scale, v_scale = _rank_kv(cfg, k, v, k_scale, v_scale)

    from repro_torch.kernels.attention import ops as attn_kernel

    kernel = kernel if kernel is not None else cfg.decode_kernel
    if kernel not in (None, "fused", "reference"):
        raise ValueError(f"unknown decode kernel {kernel!r}; expected 'fused' or 'reference'")
    # None (inline) and "reference" are the same plain block: the per-row
    # validity mask from pos fed to _fold_masked_attention
    fn = attn_kernel.decode_attention if kernel == "fused" else attn_kernel.ref_decode_attention
    return fn(q, k, v, pos_b, k_scale, v_scale, scale=cfg.d_head**-0.5, wrap=bool(window))


# ---------------------------------------------------------------------------
# Speculative decode: a verify block of k+1 rows, then commit or roll back
# ---------------------------------------------------------------------------


def _verify_slots(pos, sq, cache_len):
    """(b, sq) ring slots ``(pos + j) % cache_len`` of a verify block's rows."""
    offs = torch.arange(sq, dtype=torch.int32, device=pos.device)
    return ((pos.to(torch.int32)[:, None] + offs[None, :]) % cache_len).long()


def gather_verify_lines(cache, pos, sq: int, *, stacked: bool = False) -> dict:
    """The lines (and int8 scales) a verify block of ``sq`` rows will
    overwrite, copied out before anything of the step writes: per buffer
    ``(b, sq, ...)`` at the ring slots ``(pos + j) % cache_len``, or
    ``(L, b, sq, ...)`` for a stacked cache (every layer plane in one
    gather).  :func:`verify_cache_commit` writes them back over the
    rejected rows.  pos: (b,) int tensor."""
    t_axis = 2 if stacked else 1
    cache_len = cache["k"].shape[t_axis]
    slots = _verify_slots(pos, sq, cache_len)
    rows = torch.arange(slots.shape[0], device=slots.device)[:, None]
    return {name: buf[:, rows, slots] if stacked else buf[rows, slots]
            for name, buf in cache.items()}


def attention_verify(p: Attention, cfg, x, cache, pos, *, window: Optional[int] = None,
                     layer_idx=None, kernel: Optional[str] = None, norm_levels=None, mm=None):
    """Draft-verify attention over a block of ``sq`` rows a slot (the
    reference's ``attention_verify``), written IN PLACE as the sequential
    steps would write it.

    x: (b, sq, d), row ``j`` the token a slot feeds at ``pos[b] + j``; pos:
    (b,) int tensor.  The projections, qk-norms and RoPE run once over all
    ``b * sq`` rows (``mm`` the projection product, default ``@``; see
    ``layers.rowwise``); RoPE's tables are built a row at a time, at the
    sequential step's shape.  Then for ``j = 0..sq-1`` in turn row ``j``'s
    line lands at its ring slot ``(pos + j) % cache_len`` and query row
    ``j`` attends through :func:`_write_and_attend`, the sequential step's
    own write and decode-attention launch (at the pool's ``b``).  So row
    ``j`` reads exactly the cache the sequential step at ``pos + j`` reads
    after feeding rows ``0..j-1``, and its output is that step's, bit for
    bit, wherever the batched projections give each row the bits of the
    ``b``-row product.  Every row's line stays written: copy the old lines
    out first (:func:`gather_verify_lines`) and roll back the rejected rows
    with :func:`verify_cache_commit`.  Needs ``sq <= cache_len`` (distinct
    slots in a block).  Returns (out (b, sq, d), cache)."""
    mm = torch.matmul if mm is None else mm
    b, sq, _ = x.shape
    cache_len = _plane(cache["k"], layer_idx).shape[1]
    if sq > cache_len:
        raise ValueError(f"verify block of {sq} rows exceeds cache_len {cache_len}; "
                         f"speculation needs k+1 <= window for sliding-window layers")
    pos = pos.to(device=x.device, dtype=torch.int32)
    posr = pos[:, None] + torch.arange(sq, dtype=torch.int32, device=x.device)[None, :]
    q, k_new, v_new = _project_qkv(p, cfg, x, x, None, None, use_rope=False,
                                   norm_levels=norm_levels, mm=mm)
    if cfg.pos == "rope":
        tables = [rope_tables(posr[:, j:j + 1], q.shape[-1], theta=cfg.rope_theta)
                  for j in range(sq)]
        cos = torch.cat([c for c, _ in tables], dim=1)
        sin = torch.cat([s for _, s in tables], dim=1)
        q, k_new = rotate(q, cos, sin), rotate(k_new, cos, sin)
    q, k_new, v_new = _constrain_qkv(q, k_new, v_new)
    outs = []
    for j in range(sq):
        pj = posr[:, j].contiguous()
        outs.append(_write_and_attend(cfg, cache, q[:, j].contiguous(), k_new[:, j], v_new[:, j],
                                      pj, (pj % cache_len).long(), window=window,
                                      layer_idx=layer_idx, kernel=kernel))
    return _out_proj(torch.stack(outs, dim=1), p.wo, mm, cfg=cfg), cache


def verify_cache_commit(cache, old: dict, pos, n_commit, *, stacked: bool = False):
    """Commit the accepted prefix of a verify block (the reference's
    ``verify_cache_commit``): rows ``j < n_commit[b]`` keep the lines
    :func:`attention_verify` wrote, the rejected rows get the lines ``old``
    held (from :func:`gather_verify_lines`, taken before the step wrote),
    bit for bit, in place.  The cache then equals the sequential loop's fed
    only the accepted tokens; ``n_commit = 0`` restores the pre-step cache.
    pos, n_commit: (b,) int tensors.  Returns ``cache``."""
    t_axis = 2 if stacked else 1
    cache_len = cache["k"].shape[t_axis]
    b, sq = old["k"].shape[t_axis - 1], old["k"].shape[t_axis]
    slots = _verify_slots(pos, sq, cache_len)
    rows = torch.arange(b, device=slots.device)[:, None]
    offs = torch.arange(sq, dtype=torch.int32, device=slots.device)
    keep = offs[None, :] < n_commit.to(torch.int32)[:, None]  # (b, sq)
    for name, o in old.items():
        buf = cache[name]
        lead = (1,) if stacked else ()
        kb = keep.reshape(lead + (b, sq) + (1,) * (o.ndim - 2 - len(lead)))
        if stacked:
            buf[:, rows, slots] = torch.where(kb, buf[:, rows, slots], o)
        else:
            buf[rows, slots] = torch.where(kb, buf[rows, slots], o)
    return cache


# ---------------------------------------------------------------------------
# Cross-attention decode (encoder-decoder): the encoder's K/V once a request
# ---------------------------------------------------------------------------


def precompute_cross_kv(p: Attention, cfg, enc_out: torch.Tensor) -> dict:
    """One decoder layer's cross-attention K/V over the encoder output
    (b, t, d): ``{"ck", "cv"}`` of (b, t, kv, hd), K through the layer's
    qk-norm when the config has one."""
    k = _project(enc_out, p.wk)
    v = _project(enc_out, p.wv)
    if cfg.qk_norm:
        k = rmsnorm_cfg(p.k_norm, k, cfg, **_K_SITE(cfg))
    return {"ck": k, "cv": v}


def cross_attention_decode(p: Attention, cfg, x: torch.Tensor, cross_kv: dict) -> torch.Tensor:
    """The decoder's cross-attention of x (b, s, d) over one layer's
    precomputed encoder K/V (:func:`precompute_cross_kv`), every frame
    visible: the reference's plain einsums with float32 scores times the
    exact scale and a float32 softmax, no mask, the weights cast to x's
    dtype before the V product (prefill and decode alike; the training
    path's "cross" mode folds in its mask instead).  Returns (b, s, d)."""
    q = _project(x, p.wq)
    if cfg.qk_norm:
        q = rmsnorm_cfg(p.q_norm, q, cfg, **_Q_SITE(cfg))
    h = q.shape[2]
    ck, cv = _rank_kv(cfg, cross_kv["ck"], cross_kv["cv"])
    scores = torch.einsum("bshk,bthk->bhst", q, _expand_kv(ck, h)).float()
    w = _softmax(scores * cfg.d_head**-0.5).to(x.dtype)
    out = torch.einsum("bhst,bthk->bshk", w, _expand_kv(cv, h))
    return _out_proj(out, p.wo, cfg=cfg)
