"""Config-driven LMs: init, training forward, prefill, decode step and
greedy decode (torch port of ``repro.models.lm``: uniform stacks, and
stacks that mix "global", "window", "ssd" and "rglru" blocks; RMSNorm or
LayerNorm, a SwiGLU or GELU MLP or a mixture of experts, the vision stub's
tokens in the training forward, the recurrent blocks: the SSD mixer of
mamba2-2.7b and the RG-LRU block of recurrentgemma-2b; and the
encoder-decoder of whisper-small: a bidirectional encoder over
``batch["audio"]`` frames, cross-attention in every decoder layer,
sinusoidal positions on both sides).

Entry points:
    init(cfg, generator, device, trainable=)     -> LM
    forward(model, cfg, batch, return_hidden=)   -> (logits | (x, unembed), aux)
    init_cache(cfg, batch, cache_len, device=)   -> cache dict, or list of dicts
    decode_step(model, cfg, cache, tokens, pos)  -> (logits, cache)
    prefill(model, cfg, cache, tokens)           -> (logits, cache)
    generate_scan(model, cfg, cache, tok, start_pos, gen_len)
                                                 -> (tokens, next_tok, cache)
    precompute_cross(model, cfg, audio)          -> (cross_kv, enc_out)

An encoder-decoder's decode entry points (``decode_step``, ``prefill``,
``generate_scan``, ``prefill_into_slots``, ``decode_slots_step``,
``decode_slots_scan``) take ``cross_kv=``: the stacked ``{"ck", "cv"}`` of
(L, b, frames, kv, hd) that :func:`precompute_cross` returns, for the batch's
rows (the pool's rows in the slot path; ``prefill_into_slots`` writes the
admitted rows' into ``pool_cross_kv`` in place).  Without it a decoder
layer skips its cross step, as the reference's does.

Slot-pool serving (the continuous-batching engine's primitives):
    init_pool_state(cfg, num_slots, cache_len)   -> pool dict
    slot_rows_like / insert_cache_slots / prefill_into_slots
    sample_tokens(logits, pos, keys, temperature, top_k)
    decode_slots_step / decode_slots_scan (health latches, shadow-exact canaries)

Speculative decoding over the slot pool (greedy draft-and-verify):
    gather_verify_lines / decode_verify_step / commit_verify_cache
    draft_ngram(hist, tok, pos, k)
    decode_slots_spec_step / decode_slots_spec_scan

As in the reference, a uniform stack's cache is one dict of stacked
``(L, b, t, kv, hd)`` tensors, and a mixed stack's is a list of per-layer
dicts ``(b, t, kv, hd)``, each layer's ``t`` its own (a window layer's ring
of the window).  A recurrent layer's share is its state, as the
reference's ``_layer_cache`` has it: ``{"conv": (b, 3, c), "ssm": (b, nh,
n, hp)}`` for "ssd" and ``{"conv": (b, 3, dr), "h": (b, dr)}`` for "rglru"
(``conv`` in the activation dtype, the rest float32, never int8), stacked
on a leading L axis in a uniform stack.  Prefill and decode update it IN
PLACE (the reference is functional and returns a new cache; here the
returned cache is the one passed in, and a layer's new state is
``copy_``-ed into its tensors, which a captured graph holds).

Serving runs every norm through ``layers.norms.norm_cfg``: an RMSNorm with
``sqrt_unit="e2afs"`` and no sqrt fault active on its fused route (the
RMSNorm kernel on CUDA, its plain version on the CPU; the reference's
unfused call computes the same function), otherwise, and every LayerNorm,
unfused through the configured unit (``cfg.sqrt_faults`` struck into its
datapath; a clean "e2afs" rsqrt is one ``e2afs_rsqrt`` launch on CUDA).
Decode entry points take ``unit_levels`` ((b,) int32, with
``cfg.sqrt_ladder``): every norm rsqrt of row ``i`` then runs through
``ladder[unit_levels[i]]`` (``layers.norms.rmsnorm_select`` /
``layernorm_select``).  The training forward runs every norm unfused,
through the unit's differentiable route, as the reference's does (the
RMSNorm kernel has no backward in either package).

A mixture-of-experts layer (``cfg.moe``) routes each batch row as one group
(``layers.moe.moe_apply``): prefill routes the whole prompt, so its drops
follow the prompt length, and a decode step routes one token a row, which
never drops.  As in the reference, speculation refuses MoE models.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.faults import _M32, _mix32
from repro_torch.distributed.constraints import (block_index, constrain, fault_block, gathered,
                                                 maybe_axis_rules, mesh_axes, reduce_sum,
                                                 shard_of, tp_in, tp_out, whole_sequence)
from repro_torch.device import resolve_device
from repro_torch.layers import attention as attn
from repro_torch.layers import rglru, rowwise, ssd
from repro_torch.layers.mlp import MLP, mlp_apply
from repro_torch.layers.moe import MoE, moe_apply
from repro_torch.layers.norms import norm_cfg as _norm
from repro_torch.layers.norms import norm_init
from repro_torch.layers.param import parameter, truncated_normal
from repro_torch.models.config import ModelConfig

__all__ = ["LM", "init", "init_cache", "forward", "decode_step", "prefill", "generate_scan",
           "param_count", "init_pool_state", "pool_tensors", "slot_rows_like",
           "insert_cache_slots", "prefill_into_slots", "sample_tokens", "decode_slots_step",
           "decode_slots_scan", "canary_steps", "exact_twin", "gather_verify_lines",
           "decode_verify_step", "commit_verify_cache", "draft_ngram", "decode_slots_spec_step",
           "decode_slots_spec_scan", "precompute_cross", "param_specs", "named_param_specs",
           "cache_specs", "cross_kv_specs"]


def act_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.act_dtype)


def exact_twin(cfg: ModelConfig) -> ModelConfig:
    """The exact-datapath, fault-free twin of a config: the bottom rung of
    the approximate -> exact degradation ladder."""
    if cfg.sqrt_unit == "exact" and cfg.sqrt_faults is None and cfg.sqrt_ladder is None:
        return cfg
    return cfg.replace(sqrt_unit="exact", sqrt_faults=None, sqrt_ladder=None)


class Block(nn.Module):
    """One layer in the reference's layout, by its block: "global" and
    "window" hold ln1, ``attn``, ln2 and ``mlp`` (or, with ``cfg.moe``,
    ``moe``), and in an encoder-decoder (``cross``) also ``xattn`` and lnx;
    "ssd" holds ln1 and ``mixer`` (:class:`~repro_torch.layers.ssd.SSD`);
    "rglru" holds ln1, ``mixer`` (:class:`~repro_torch.layers.rglru.RGLRU`),
    ln2 and ``mlp``.  Norms in the config's layout."""

    def __init__(self, cfg, block: str, *, dtype, device, cross: bool = False):
        super().__init__()
        norm_init(self, "ln1", cfg, dtype=dtype, device=device)
        if block == "ssd":
            self.mixer = ssd.SSD(cfg, dtype=dtype, device=device)
            return
        if block == "rglru":
            self.mixer = rglru.RGLRU(cfg, dtype=dtype, device=device)
        else:
            self.attn = attn.Attention(cfg, dtype=dtype, device=device)
        norm_init(self, "ln2", cfg, dtype=dtype, device=device)
        if cfg.moe is not None and block != "rglru":
            self.moe = MoE(cfg, dtype=dtype, device=device)
        else:
            self.mlp = MLP(cfg, dtype=dtype, device=device)
        if cross and block in ("global", "window"):
            self.xattn = attn.Attention(cfg, dtype=dtype, device=device)
            norm_init(self, "lnx", cfg, dtype=dtype, device=device)


class EncoderLayer(nn.Module):
    """One encoder layer (the reference's ``_enc_layer_init``): ln1, ``attn``
    (bidirectional), ln2 and ``mlp``."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        norm_init(self, "ln1", cfg, dtype=dtype, device=device)
        self.attn = attn.Attention(cfg, dtype=dtype, device=device)
        norm_init(self, "ln2", cfg, dtype=dtype, device=device)
        self.mlp = MLP(cfg, dtype=dtype, device=device)


class LM(nn.Module):
    """Parameters in the reference's layout: embed (vp, d), unembed (d, vp),
    ln_f (d,) (or ln_f_scale and ln_f_bias), with vision tokens
    vision_proj (d, d), and one Block per layer (the reference stacks a uniform
    model's on a leading L axis and keeps a mixed model's as a list:
    ``stacked`` records which); an encoder-decoder also holds ``encoder``,
    one :class:`EncoderLayer` per encoder layer (stacked in the reference),
    and ``enc_extra`` with the encoder's final norm ``enc_ln_f``.  For
    serving each is stored once in the
    activation dtype, without gradient; ``trainable=True`` keeps float32
    masters that require gradients, as the reference always does, cast at
    every use.  ``SPECS``: the logical axes of the model's own leaves (the
    layers' classes carry theirs; every norm is ("embed",))."""

    SPECS = {"embed": ("vocab", "embed"), "unembed": ("embed", "vocab"),
             "vision_proj": ("embed", None)}

    def __init__(self, cfg: ModelConfig, *, device, trainable: bool = False):
        super().__init__()
        cfg.validate()
        self.stacked = cfg.uniform
        dtype = torch.float32 if trainable else act_dtype(cfg)
        vp, d = cfg.padded_vocab, cfg.d_model
        self.embed = parameter((vp, d), dtype, device)
        if not cfg.tie_embeddings:
            self.unembed = parameter((d, vp), dtype, device)
        norm_init(self, "ln_f", cfg, dtype=dtype, device=device)
        if cfg.vision_tokens:
            self.vision_proj = parameter((d, d), dtype, device)
        cross = cfg.kind == "encdec"
        self.layers = nn.ModuleList(Block(cfg, block, dtype=dtype, device=device, cross=cross)
                                    for block in cfg.blocks)
        if cross:
            self.encoder = nn.ModuleList(EncoderLayer(cfg, dtype=dtype, device=device)
                                         for _ in range(cfg.encoder.n_layers))
            self.enc_extra = nn.Module()
            norm_init(self.enc_extra, "enc_ln_f", cfg, dtype=dtype, device=device)
        self.requires_grad_(trainable)

    def unembed_matrix(self) -> torch.Tensor:
        return self.embed.T if not hasattr(self, "unembed") else self.unembed


# RMSNorm scales (applied as 1 + scale), LayerNorm biases (``*_bias``) and
# the GELU MLP's biases start at zero and LayerNorm scales (``*_scale``) at
# one; a recurrent mixer's constant leaves start where its class's
# ``CONSTANT_START`` says (the same name means ones in one mixer and zeros in
# the other: SSD's conv_w, RG-LRU's); every other weight is a fan-in truncated
# normal with the reference's scale (sqrt(d) for the embedding, 0.1 for a
# router, a mixer's ``INIT_SCALE``, else 1)
_ZERO_INIT = ("ln1", "ln2", "ln_f", "lnx", "enc_ln_f", "q_norm", "k_norm", "bi", "bo")


@torch.no_grad()
def init(cfg: ModelConfig, generator: torch.Generator = None, *, device=None,
         trainable: bool = False) -> LM:
    """A model with random weights drawn from ``generator`` on ``device``
    (the card unless ``device="cpu"``).  The generator must live on that
    device; None seeds a fresh one with 0.  ``trainable`` builds float32
    masters that require gradients (see :class:`LM`)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model = LM(cfg, device=dev, trainable=trainable)
    for name, p in model.named_parameters():
        start = _constant_start(model, name)
        if start is not None:
            p.fill_(start)
        else:
            owner, _, leaf = name.rpartition(".")
            scale = (float(cfg.d_model) ** 0.5 if name == "embed" else 0.1 if leaf == "router"
                     else getattr(model.get_submodule(owner), "INIT_SCALE", {}).get(leaf, 1.0))
            p.copy_(truncated_normal(generator, tuple(p.shape), p.dtype, scale, device=dev))
    return model


def _constant_start(model: LM, name: str):
    """The constant :func:`init` starts parameter ``name`` at, or None for a
    drawn one."""
    owner, _, leaf = name.rpartition(".")
    start = getattr(model.get_submodule(owner), "CONSTANT_START", {})
    if leaf in start:
        return start[leaf]
    if leaf in _ZERO_INIT or leaf.endswith("_bias"):
        return 0.0
    return 1.0 if leaf.endswith("_scale") else None


def constant_start_parameters(model: LM) -> list:
    """``(name, parameter)`` for every parameter :func:`init` starts at a
    constant, in ``named_parameters`` order.  Comparisons move these off
    their starts first: a fresh RG-LRU block (conv_w at zero) computes
    nothing, and a check on it would hold whatever ran."""
    return [(n, p) for n, p in model.named_parameters() if _constant_start(model, n) is not None]


_NORMS = ("ln1", "ln2", "ln_f", "lnx", "enc_ln_f")


def named_param_specs(cfg: ModelConfig) -> dict:
    """{parameter name: its logical axes}, one entry a dim of the port's own
    tensor (a layer's tensors carry no 'layers' axis: each Block holds one
    layer), from the ``SPECS`` of the module that owns it; every norm's
    scale and bias is ("embed",)."""
    model = LM(cfg, device=torch.device("meta"))
    specs = {}
    for name, _ in model.named_parameters():
        owner, _, leaf = name.rpartition(".")
        table = getattr(model.get_submodule(owner), "SPECS", {})
        if leaf in table:
            specs[name] = table[leaf]
        elif leaf in _NORMS or leaf.rsplit("_", 1)[0] in _NORMS:
            specs[name] = ("embed",)
        else:
            raise KeyError(f"no logical axes for parameter {name}")
    return specs


def param_specs(cfg: ModelConfig) -> dict:
    """The parameters' logical axes in the reference's tree (the second
    value of its ``lm.init``), under the leaf names ``models/convert.py``
    maps: a uniform stack's layer leaves stacked, ``("layers", *axes)``,
    a mixed stack's a list of per-layer dicts, the encoder's always
    stacked."""
    from repro_torch.models.convert import _put

    tree, stacked_layers = {}, {}
    layers = None if cfg.uniform else [{} for _ in range(cfg.n_layers)]
    for name, axes in named_param_specs(cfg).items():
        parts = name.split(".")
        if parts[0] == "layers" and layers is not None:
            _put(layers[int(parts[1])], parts[2:], axes)
        elif parts[0] in ("layers", "encoder"):
            _put(stacked_layers.setdefault(parts[0], {}), parts[2:], ("layers", *axes))
        else:
            _put(tree, parts, axes)
    tree.update(stacked_layers)
    if layers is not None:
        tree["layers"] = layers
    return tree


def _block_specs(block, quantized):
    if block == "ssd":
        return ssd.ssd_state_specs()
    if block == "rglru":
        return rglru.rglru_state_specs()
    return attn.kv_cache_specs(quantized)


def cache_specs(cfg: ModelConfig, *, quantized: bool = False):
    """The logical axes of :func:`init_cache`'s tree (the second value of
    the reference's ``init_cache``): a uniform stack's leaves with a leading
    'layers' axis, a mixed stack's a list of per-layer dicts."""
    if cfg.uniform:
        return {k: ("layers", *axes) for k, axes in _block_specs(cfg.blocks[0], quantized).items()}
    return [_block_specs(block, quantized) for block in cfg.blocks]


def cross_kv_specs() -> dict:
    """Logical axes of :func:`precompute_cross`'s stacked cross K/V."""
    return {"ck": ("layers", "batch", "kv_seq", "kv_heads", None),
            "cv": ("layers", "batch", "kv_seq", "kv_heads", None)}


def _mesh_scope(cfg, mesh, rules, extents=None):
    """The ``axis_rules`` scope of a mesh-optional entry point: ``rules``
    default to ``serve_rules(cfg, mesh)``; no mesh, no scope."""
    if mesh is not None and rules is None:
        from repro_torch.distributed.sharding import serve_rules

        rules = serve_rules(cfg, mesh)
    return maybe_axis_rules(mesh, rules, extents)


def _cache_lines(cfg, block, cache_len):
    """The reference's ``_layer_cache``: a window block keeps a ring of
    ``min(cache_len, cfg.window)`` lines, a global block ``cache_len``."""
    return min(cache_len, cfg.window) if block == "window" else cache_len


def _block_cache(cfg, block, batch, cache_len, dt, *, quantized, device, layers=None) -> dict:
    if block == "ssd":
        return ssd.init_ssd_state(cfg, batch, dt, device=device, layers=layers)
    if block == "rglru":
        return rglru.init_rglru_state(cfg, batch, dt, device=device, layers=layers)
    return attn.init_kv_cache(cfg, batch, _cache_lines(cfg, block, cache_len), dt,
                              quantized=quantized, device=device, layers=layers)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *, quantized: bool = False,
               device=None, abstract: bool = False):
    """Zeroed cache on ``device`` (the card unless ``device="cpu"``), in the
    reference's two forms: for a uniform stack one dict of tensors stacked
    on a leading L axis, for a mixed stack a list of per-layer dicts.  An
    attention layer holds ``(batch, lines, kv, hd)`` K/V (int8 plus float32
    scales when ``quantized``), ``lines`` being ``cache_len``, or for a
    window layer ``min(cache_len, cfg.window)``, a ring of its window; a
    recurrent layer holds its state (see the module docstring), which
    ``quantized`` leaves as it is.  ``abstract=True`` gives meta tensors
    (shapes and dtypes, no storage), as the reference's ShapeDtypeStructs."""
    dev = torch.device("meta") if abstract else resolve_device(device)
    dt = act_dtype(cfg)
    if cfg.uniform:
        return _block_cache(cfg, cfg.blocks[0], batch, cache_len, dt, quantized=quantized,
                            device=dev, layers=cfg.n_layers)
    return [_block_cache(cfg, block, batch, cache_len, dt, quantized=quantized, device=dev)
            for block in cfg.blocks]


def _layer_cache(cache, i):
    """Layer ``i``'s share of the cache, as ``(cache, layer_idx)`` for the
    attention layer: the stacked dict with ``i``, or the list's own dict."""
    return (cache[i], None) if isinstance(cache, list) else (cache, i)


def _layer_state(cache, i) -> dict:
    """Layer ``i``'s recurrent state as views into the cache's tensors."""
    return cache[i] if isinstance(cache, list) else {k: t[i] for k, t in cache.items()}


def _write_state(state: dict, new: dict) -> None:
    """A layer's new state into its tensors, in place (never rebound: a
    captured graph holds the pool's addresses)."""
    for k, t in state.items():
        t.copy_(new[k])


def _ffn(layer: Block, cfg, h, mm=torch.matmul, train: bool = False):
    """The block's MLP over h, or its mixture of experts (one routing group
    a batch row): (output, the router's aux loss, or None for an MLP).
    ``train``: the training forward's aux, over the whole batch."""
    if cfg.moe is not None:
        if not train:
            return moe_apply(layer.moe, cfg, h, capacity_factor=cfg.moe.capacity_factor)
        # the experts see whole sequences: sequence parallelism ends here
        y, aux = moe_apply(layer.moe, cfg, tp_in(h, ()),
                           capacity_factor=cfg.moe.capacity_factor, whole_batch_aux=True)
        return tp_out(y, ()), aux
    return mlp_apply(layer.mlp, cfg, h, mm=mm), None


def _layer_train(layer: Block, cfg, block, x, positions, enc_out=None):
    """One block of the training forward (the reference's ``_layer_train``):
    unfused norms, full-sequence causal attention ("global") or causal
    sliding-window attention ("window"), with ``enc_out`` the cross step
    (lnx, then "cross" attention over the encoder's output), the MLP or the
    experts; or the chunked SSD mixer ("ssd"), or the RG-LRU block and its
    MLP ("rglru").  Returns (x, the layer's float32 aux loss, 0 without
    experts)."""
    x = constrain(x, ("batch", "seq", "embed"))
    h = _norm(layer, "ln1", x, cfg, fused=False, stream=True)
    if block in ("ssd", "rglru"):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if block == "ssd":
            return x + ssd.ssd_train(layer.mixer, cfg, h), aux
        x = x + rglru.rglru_train(layer.mixer, cfg, h)
        return x + mlp_apply(layer.mlp, cfg, _norm(layer, "ln2", x, cfg, fused=False,
                                                        stream=True)), aux
    mode = "causal" if block == "global" else "window"
    x = x + attn.attention_train(layer.attn, cfg, h, mode=mode, window=cfg.window,
                                 positions=positions)
    if enc_out is not None:
        h = _norm(layer, "lnx", x, cfg, fused=False, stream=True)
        x = x + attn.attention_train(layer.xattn, cfg, h, mode="cross", kv_x=enc_out)
    h, aux = _ffn(layer, cfg, _norm(layer, "ln2", x, cfg, fused=False, stream=True), train=True)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return constrain(x + h, ("batch", "seq", "embed")), aux


def _layer_train_fsdp(layer: Block, prefix, placement, cfg, block, x, positions, enc_out=None):
    """:func:`_layer_train` on the layer's weights gathered over the
    data-parallel axes (``placement``: a training model's ``Sharding`` a
    parameter name, ``sharding.place_train_state``; None off a mesh).  Under
    block remat the recompute gathers again; the backward reduce-scatters
    each weight's gradient (``constraints.fsdp_param``)."""
    with gathered(layer, placement, prefix):
        return _layer_train(layer, cfg, block, x, positions, enc_out)


def _sinusoidal(n: int, d: int, device) -> torch.Tensor:
    """The reference's absolute position table (n, d): sines then cosines of
    ``pos / 10000^(2i / d)``, computed in float64 (numpy) and rounded to
    float32."""
    pos = np.arange(n)[:, None]
    i = np.arange(d // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / d)
    table = np.concatenate([np.sin(angle), np.cos(angle)], -1).astype(np.float32)
    return torch.from_numpy(table).to(device)


def _step_sinusoid(pos, d: int, device) -> torch.Tensor:
    """The reference's decode-step sinusoid in float32 on the device: (d,)
    for an int (or 0-dim) position, (b, d) for a (b,) tensor.  No host read,
    so a captured step keeps it; divisions by device tensors (a CUDA tensor
    divided by a Python number is multiplied by its rounded reciprocal)."""
    if isinstance(pos, torch.Tensor):
        p = pos.to(device=device, dtype=torch.float32)
    else:
        p = torch.full((), float(pos), dtype=torch.float32, device=device)
    i = torch.arange(d // 2, dtype=torch.float32, device=device)
    exponent = 2 * i / torch.full((), float(d), dtype=torch.float32, device=device)
    ang = p[..., None] / torch.pow(10000.0, exponent)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _enc_layer(layer: EncoderLayer, cfg, x, fused: bool):
    """One encoder layer (the reference's ``_enc_layer``): bidirectional
    attention and the MLP, each after its norm."""
    h = _norm(layer, "ln1", x, cfg, fused=fused)
    x = x + attn.attention_train(layer.attn, cfg, h, mode="bidir")
    return x + mlp_apply(layer.mlp, cfg, _norm(layer, "ln2", x, cfg, fused=fused))


def _enc_layer_fsdp(layer: EncoderLayer, prefix, placement, cfg, x, fused: bool):
    """:func:`_enc_layer` on the layer's FSDP-gathered weights (a training
    model placed on a mesh, see :func:`_layer_train_fsdp`), over whole
    frame sequences (no sequence parallelism in the encoder)."""
    with whole_sequence(), gathered(layer, placement, prefix):
        return _enc_layer(layer, cfg, x, fused)


def _run_encoder(model: LM, cfg, audio: torch.Tensor, *, fused: bool) -> torch.Tensor:
    """The encoder over the audio frames (b, frames, d) (the reference's
    ``_run_encoder``): the sinusoidal table added, each layer rematerialised
    in the backward under ``remat="block"``, the final norm ``enc_ln_f``.
    ``fused``: the serving norm route (:func:`precompute_cross`), else the
    training one."""
    dt = act_dtype(cfg)
    x = audio.to(dt)
    x = x + _sinusoidal(x.shape[1], cfg.d_model, x.device).to(dt)[None]
    placement = getattr(model, "placement", None)
    for i, layer in enumerate(model.encoder):
        args = (layer, f"encoder.{i}.", placement, cfg, x, fused)
        if cfg.remat == "block":
            x = checkpoint(_enc_layer_fsdp, *args, use_reentrant=False)
        else:
            x = _enc_layer_fsdp(*args)
    with whole_sequence(), gathered(model.enc_extra, placement, "enc_extra."):
        return _norm(model.enc_extra, "enc_ln_f", x, cfg, fused=fused)


def _audio(cfg, batch: dict, b: int) -> torch.Tensor:
    """``batch["audio"]``, the encoder's frames (b, frames, d), checked."""
    a = batch.get("audio")
    if a is None or a.ndim != 3 or a.shape[0] != b or a.shape[2] != cfg.d_model:
        want = (b, cfg.encoder.n_ctx, cfg.d_model)
        raise ValueError(f"{cfg.name} takes batch['audio'] of shape {want}, got "
                         f"{None if a is None else tuple(a.shape)}")
    return a


def _embed_inputs(model: LM, cfg, batch: dict) -> torch.Tensor:
    """The reference's ``_embed_inputs``: the token embeddings, after the
    vision stub's tokens ``batch["vision"] @ vision_proj`` when the config
    has them, plus the sinusoidal table when the config has sinusoidal
    positions."""
    dt = act_dtype(cfg)
    tokens = batch["tokens"]
    x = _embed(model, cfg, tokens, dt)
    if cfg.vision_tokens:
        v = batch.get("vision")
        want = (tokens.shape[0], cfg.vision_tokens, cfg.d_model)
        if v is None or tuple(v.shape) != want:
            raise ValueError(f"{cfg.name} takes batch['vision'] of shape {want}, got "
                             f"{None if v is None else tuple(v.shape)}")
        x = torch.cat([v.to(dt) @ model.vision_proj.to(dt), x], dim=1)
    if cfg.pos == "sinusoidal":
        x = x + _sinusoidal(x.shape[1], cfg.d_model, x.device).to(dt)[None]
    return x


def forward(model: LM, cfg: ModelConfig, batch: dict, *, return_hidden: bool = False):
    """Training forward over ``batch["tokens"]`` (b, s), differentiable.

    Returns (logits over the padded vocab (b, s, vp), aux) as the reference
    does; with ``return_hidden`` the unembed product is left to the caller
    (the loss computes it in sequence chunks): ((x, unembed), aux).
    ``cfg.remat == "block"`` recomputes each layer's forward in the backward
    pass (``torch.utils.checkpoint``), keeping only the layer inputs;
    ``"minimal"`` recomputes only the attention scores (the reference keeps
    every residual but "attn_scores"; see ``attention._scored_attention``).
    ``aux["moe_aux"]`` is the layers' router loss summed and divided by the
    number of layers (0 without experts).

    With ``cfg.vision_tokens``, ``batch["vision"]`` (b, vision_tokens, d)
    goes through ``vision_proj`` in front of the tokens, the positions run
    over both, and the text positions are sliced out after the final norm:
    logits (and ``return_hidden``'s x) cover the tokens only.  An
    encoder-decoder runs the encoder over ``batch["audio"]`` (b, frames, d)
    first, and every decoder layer attends to its output.

    In a training scope on a mesh (``launch.steps.make_train_step(mesh=)``,
    a model placed by ``sharding.place_train_state``) ``batch`` is the
    rank's rows, each layer runs on its weights gathered over the data axes
    (:func:`_layer_train_fsdp`), and the hidden state returned has entered
    the unembedding's vocabulary blocks; under sequence parallelism the
    residual stream between the embedding and the final norm is the rank's
    block of the sequence."""
    placement = getattr(model, "placement", None)
    # embed, unembed, ln_f (and vision_proj)
    with gathered(model, placement, recurse=False):
        x = _embed_inputs(model, cfg, batch)
        positions = torch.arange(x.shape[1], device=x.device)
        x = tp_out(x, ())  # sequence parallelism: the rank's block of the sequence
        enc_out = None
        if cfg.kind == "encdec":
            enc_out = _run_encoder(model, cfg, _audio(cfg, batch, x.shape[0]), fused=False)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, (layer, block) in enumerate(zip(model.layers, cfg.blocks)):
            args = (layer, f"layers.{i}.", placement, cfg, block, x, positions, enc_out)
            if cfg.remat == "block":
                x, a = checkpoint(_layer_train_fsdp, *args, use_reentrant=False)
            else:
                x, a = _layer_train_fsdp(*args)
            aux_total = aux_total + a
        x = _norm(model, "ln_f", x, cfg, fused=False, stream=True)
        # x enters the unembedding's vocabulary blocks (whole sequences)
        x = tp_in(x, unembed_axes(cfg))
        if cfg.vision_tokens:
            x = x[:, cfg.vision_tokens:]
        aux = {"moe_aux": aux_total / max(1, cfg.n_layers)}
        unembed = model.unembed_matrix().to(x.dtype)
    if return_hidden:
        return (x, unembed), aux
    return constrain(x @ unembed, ("batch", "seq", "vocab")), aux


def _window(cfg, block):
    return cfg.window if block == "window" else None


def _vocab_axes(cfg) -> tuple:
    """The mesh axes that shard the vocabulary of the embedding table (and
    so of a tied unembedding) in the current scope."""
    return mesh_axes(LM.SPECS["embed"], (cfg.padded_vocab, cfg.d_model), 0)


def unembed_axes(cfg) -> tuple:
    """The mesh axes that shard the vocabulary of the unembedding (the
    embedding table's, tied) in the current scope."""
    if cfg.tie_embeddings:
        return _vocab_axes(cfg)
    return mesh_axes(LM.SPECS["unembed"], (cfg.d_model, cfg.padded_vocab), 1)


def _embed(model: LM, cfg, tokens: torch.Tensor, dtype=None) -> torch.Tensor:
    """The token embeddings ``embed[tokens]`` (the table cast to ``dtype``
    first, if given).  Where the rules shard the vocabulary, a rank holds a
    block of the table's rows: it looks up the ids in its block, zeros
    elsewhere, and the blocks are summed over the mesh (one addend nonzero,
    so the sum is exact; every rank then has the whole gradient)."""
    table = model.embed if dtype is None else model.embed.to(dtype)
    axes = _vocab_axes(cfg)
    if not axes:
        return constrain(table[tokens], ("batch", "seq", "embed"))
    n = table.shape[0]
    local = tokens.long() - block_index(axes) * n
    hit = (local >= 0) & (local < n)
    return reduce_sum(torch.where(hit[..., None], table[local.clamp(0, n - 1)], 0), axes)


def _logits(model: LM, cfg, x, levels=None, mm=torch.matmul):
    """The final norm and the unembedding, over the real vocabulary.  Where
    the rules shard the vocabulary a rank computes a block of each row;
    sampling reads whole rows, so the blocks are gathered."""
    x = _norm(model, "ln_f", x, cfg, levels=levels)
    logits = mm(x, model.unembed_matrix().to(x.dtype))
    logits = constrain(shard_of(logits, unembed_axes(cfg), -1), ("batch", "seq", None))
    return logits[..., : cfg.vocab]


def _levels(cfg, unit_levels, device):
    """``unit_levels`` as a (b,) int32 tensor on ``device``, checked against
    the config as the reference checks it; None stays None."""
    if unit_levels is None:
        return None
    if cfg.sqrt_ladder is None:
        raise ValueError("unit_levels requires cfg.sqrt_ladder to be set")
    return torch.as_tensor(unit_levels, dtype=torch.int32, device=device)


def _recurrent_decode(layer: Block, cfg, block, x, state, levels, write_state):
    """One recurrent layer's decode step (the reference's ``_layer_decode``
    for "ssd" and "rglru"): the new state goes into ``state`` in place, or
    with ``write_state`` False nowhere."""
    step = ssd.ssd_decode if block == "ssd" else rglru.rglru_decode
    h, new = step(layer.mixer, cfg, _norm(layer, "ln1", x, cfg, levels=levels), state)
    if write_state:
        _write_state(state, new)
    x = x + h
    if block == "rglru":
        x = x + mlp_apply(layer.mlp, cfg, _norm(layer, "ln2", x, cfg, levels=levels))
    return x


def _cross_layer(cross_kv, i) -> Optional[dict]:
    """Layer ``i``'s share of the stacked cross K/V, or None."""
    return None if cross_kv is None else {k: t[i] for k, t in cross_kv.items()}


def _cross_step(layer: Block, cfg, x, cross_kv, levels=None):
    """x plus the decoder layer's cross-attention (after lnx) over its
    encoder K/V; x itself without them."""
    if cross_kv is None:
        return x
    h = _norm(layer, "lnx", x, cfg, levels=levels)
    return x + attn.cross_attention_decode(layer.xattn, cfg, h, cross_kv)


@torch.no_grad()
def decode_step(model: LM, cfg: ModelConfig, cache, tokens: torch.Tensor, pos, *,
                cross_kv=None, unit_levels=None, write_state: bool = True):
    """One decode forward (a single token per batch row) over the cache (a
    stacked dict or a per-layer list, as :func:`init_cache` gives it).

    tokens: (b, 1) integer; pos: the position of this token, an int
    (lock-step batch) or a (b,) tensor (one position per row).  Writes one
    token line per attention layer into ``cache`` in place (a window layer
    writes its ring at ``pos % window`` and attends with ``wrap``), and
    each recurrent layer's new state over its old one.  ``write_state=False``
    drops the recurrent layers' new states instead (the canary's shadow
    step: a state is read-modify-write, so the served step must read the
    state as it was; the attention lines it writes are the served step's
    to overwrite).  ``unit_levels`` ((b,) int32, requires
    ``cfg.sqrt_ladder``): every norm rsqrt of row ``i``, qk-norm and final
    norm included, through ladder rung ``unit_levels[i]`` (the RG-LRU's
    sqrt stays on ``cfg.sqrt_unit``, as in the reference).  ``cross_kv``
    (an encoder-decoder's, from :func:`precompute_cross`, for these rows):
    each decoder layer's cross step over its encoder K/V.  Sinusoidal
    positions are computed on the device from ``pos``.  Returns (logits
    (b, 1, vocab), cache).
    """
    levels = _levels(cfg, unit_levels, tokens.device)
    x = _embed(model, cfg, tokens)
    if cfg.pos == "sinusoidal":
        pe = _step_sinusoid(pos, cfg.d_model, x.device)
        x = x + (pe[:, None] if pe.ndim == 2 else pe).to(x.dtype)
    for i, (layer, block) in enumerate(zip(model.layers, cfg.blocks)):
        if block in ("ssd", "rglru"):
            x = _recurrent_decode(layer, cfg, block, x, _layer_state(cache, i), levels,
                                  write_state)
            continue
        c, idx = _layer_cache(cache, i)
        h = _norm(layer, "ln1", x, cfg, levels=levels)
        h, _ = attn.attention_decode(layer.attn, cfg, h, c, pos, window=_window(cfg, block),
                                     layer_idx=idx, norm_levels=levels)
        x = _cross_step(layer, cfg, x + h, _cross_layer(cross_kv, i), levels)
        x = x + _ffn(layer, cfg, _norm(layer, "ln2", x, cfg, levels=levels))[0]
    return constrain(_logits(model, cfg, x, levels), ("batch", "seq", "vocab")), cache


@torch.no_grad()
def prefill(model: LM, cfg: ModelConfig, cache, tokens: torch.Tensor, *, cross_kv=None,
            last_logit_only: bool = False, mesh=None, rules=None):
    """One-shot batched prefill over the prompt, writing positions [0, s) of
    every attention layer's cache in place (a window layer's ring shorter
    than the prompt keeps the last lines), and each recurrent layer's state
    after the last token (the chunked SSD, or the RG-LRU's scan).  tokens:
    (b, s) with s >= 1 into a fresh cache.  Returns (logits (b, s, vocab),
    cache); ``last_logit_only`` keeps only the last position's row, (b, 1,
    vocab).  ``cross_kv`` as in :func:`decode_step`: each decoder layer's
    cross step over the whole prompt.

    ``mesh=`` (with an optional ``rules=`` table, default
    ``serve_rules(cfg, mesh)``) runs the forward inside an ``axis_rules``
    scope: ``model``, ``cache`` and ``tokens`` are this rank's blocks
    (``distributed.sharding.place_model`` and ``place``), and the
    constraints reduce or gather across ranks where the rules shard a
    contraction or the vocabulary.  Without a mesh every constraint is a
    no-op."""
    if mesh is not None:
        with _mesh_scope(cfg, mesh, rules):
            return prefill(model, cfg, cache, tokens, cross_kv=cross_kv,
                           last_logit_only=last_logit_only)
    s = tokens.shape[1]
    if s < 1:
        raise ValueError(f"prefill needs at least one prompt token, got tokens shape "
                         f"{tuple(tokens.shape)}")
    x = _embed(model, cfg, tokens)
    if cfg.pos == "sinusoidal":
        x = x + _sinusoidal(s, cfg.d_model, x.device).to(x.dtype)[None]
    positions = torch.arange(s, device=tokens.device)
    for i, (layer, block) in enumerate(zip(model.layers, cfg.blocks)):
        if block in ("ssd", "rglru"):
            train = ssd.ssd_train if block == "ssd" else rglru.rglru_train
            h, new = train(layer.mixer, cfg, _norm(layer, "ln1", x, cfg), return_state=True)
            _write_state(_layer_state(cache, i), new)
            x = x + h
            if block == "rglru":
                x = x + mlp_apply(layer.mlp, cfg, _norm(layer, "ln2", x, cfg))
            continue
        c, idx = _layer_cache(cache, i)
        h = _norm(layer, "ln1", x, cfg)
        h, _ = attn.attention_prefill(layer.attn, cfg, h, c, positions,
                                      window=_window(cfg, block), layer_idx=idx)
        x = _cross_step(layer, cfg, x + h, _cross_layer(cross_kv, i))
        x = x + _ffn(layer, cfg, _norm(layer, "ln2", x, cfg))[0]
    if last_logit_only:
        x = x[:, -1:].contiguous()  # the norm kernel takes contiguous rows
    return constrain(_logits(model, cfg, x), ("batch", "seq", "vocab")), cache


@torch.no_grad()
def generate_scan(model: LM, cfg: ModelConfig, cache, tok: torch.Tensor, start_pos: int,
                  gen_len: int, *, cross_kv=None, mesh=None, rules=None):
    """Greedy decode of ``gen_len`` steps: a Python loop over
    :func:`decode_step` with the argmax on the device and no host
    synchronisation per token.

    tok: (b, 1), the first token to feed (usually the prefill argmax);
    start_pos: its position, an int.  Returns (tokens (b, gen_len), next_tok
    (b, 1), cache) with tokens[:, 0] == tok, as the reference: each emitted
    token is the one fed at that step, and ``next_tok`` is the argmax after
    the last step.  ``cross_kv`` as in :func:`decode_step`; ``mesh=`` /
    ``rules=`` as in :func:`prefill`, every step inside the scope.
    """
    if mesh is not None:
        with _mesh_scope(cfg, mesh, rules):
            return generate_scan(model, cfg, cache, tok, start_pos, gen_len, cross_kv=cross_kv)
    start_pos = int(start_pos)
    out = []
    for i in range(gen_len):
        out.append(tok[:, 0])
        logits, cache = decode_step(model, cfg, cache, tok, start_pos + i, cross_kv=cross_kv)
        tok = logits[:, -1:].argmax(dim=-1).to(tok.dtype)
    toks = torch.stack(out, dim=1) if out else tok.new_zeros((tok.shape[0], 0))
    return toks, tok, cache


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


@torch.no_grad()
def precompute_cross(model: LM, cfg: ModelConfig, audio: torch.Tensor, *, mesh=None, rules=None):
    """An encoder-decoder's serving start: the encoder once over ``audio``
    (b, frames, d), on the serving norm route, then every decoder layer's
    cross K/V over its output, stacked as the reference's ``{"ck", "cv"}``
    of (L, b, frames, kv, hd).  Returns (cross_kv, enc_out).  ``mesh=`` /
    ``rules=`` as in :func:`prefill`: ``audio`` is this rank's rows, the
    encoder's attention and MLP reduce their partial sums over 'model', and
    ``cross_kv`` is the rank's block of :func:`cross_kv_specs` (its KV heads
    where the rules shard them)."""
    if mesh is not None:
        with _mesh_scope(cfg, mesh, rules):
            return precompute_cross(model, cfg, audio)
    enc_out = _run_encoder(model, cfg, audio, fused=True)
    per_layer = [attn.precompute_cross_kv(layer.xattn, cfg, enc_out) for layer in model.layers]
    return {k: torch.stack([c[k] for c in per_layer]) for k in ("ck", "cv")}, enc_out


# ---------------------------------------------------------------------------
# Slot-scheduled serving: continuous batching over a KV-cache slot pool
# ---------------------------------------------------------------------------


def _slot_batch_axis(cfg) -> int:
    """Axis of the batch dim in cache leaves: a uniform stack carries a
    leading stacked-layers axis, so batch is axis 1; a mixed stack's
    per-layer dicts put it at 0."""
    return 1 if cfg.uniform else 0


def _cache_leaves(cache) -> list:
    layers = cache if isinstance(cache, list) else [cache]
    return [layer[name] for layer in layers for name in sorted(layer)]


def init_pool_state(cfg: ModelConfig, num_slots: int, cache_len: int, *,
                    quantized: bool = False, device=None, abstract: bool = False) -> dict:
    """The engine's device-side slot-pool state, on ``device`` (the card
    unless ``device="cpu"``), in the reference's layout::

        {"cache":     init_cache(cfg, num_slots, cache_len, quantized=),
         "tok":       (b, 1) int32   next token each slot feeds,
         "pos":       (b,)   int32   per-slot position counters,
         "active":    (b,)   bool    slot liveness,
         "remaining": (b,)   int32   per-slot generation budgets,
         "keys":      (b, 2) uint32  per-slot sampling stream (seed, uid)}

    Every tensor is updated in place from then on and never reallocated (a
    CUDA graph of the decode chunk holds their addresses).  The reference
    fills ``keys`` from a split PRNG key; here admission writes each slot's
    (seed, request id) words, and the keys start zero.  ``abstract=True``:
    meta tensors."""
    dev = torch.device("meta") if abstract else resolve_device(device)
    b = num_slots
    return {
        "cache": init_cache(cfg, b, cache_len, quantized=quantized, device=dev,
                            abstract=abstract),
        "tok": torch.zeros((b, 1), dtype=torch.int32, device=dev),
        "pos": torch.zeros((b,), dtype=torch.int32, device=dev),
        "active": torch.zeros((b,), dtype=torch.bool, device=dev),
        "remaining": torch.zeros((b,), dtype=torch.int32, device=dev),
        "keys": torch.zeros((b, 2), dtype=torch.uint32, device=dev),
    }


def pool_tensors(pool: dict) -> list:
    """Every tensor of a pool state, the cache's leaves first, in a fixed
    order (to zero, copy or compare a pool in place)."""
    return _cache_leaves(pool["cache"]) + [pool[k] for k in ("tok", "pos", "active",
                                                              "remaining", "keys")]


def slot_rows_like(cfg: ModelConfig, cache, k: int):
    """A fresh zeroed cache for ``k`` requests, shaped like ``cache`` with
    the batch axis resized: the staging rows a new request prefills into
    before they land in the live pool."""
    ax = _slot_batch_axis(cfg)

    def rows(a):
        return torch.zeros(a.shape[:ax] + (k,) + a.shape[ax + 1:], dtype=a.dtype, device=a.device)

    if isinstance(cache, list):
        return [{name: rows(a) for name, a in layer.items()} for layer in cache]
    return {name: rows(a) for name, a in cache.items()}


def insert_cache_slots(cfg: ModelConfig, cache, rows, slots: torch.Tensor):
    """Land per-request cache rows in the live pool IN PLACE: row ``i`` of
    every leaf of ``rows`` overwrites batch row ``slots[i]`` of ``cache``
    (``index_copy_``).  Whole-row writes, so the slot's previous occupant's
    KV is cleared wholesale, and the pool's tensors keep their addresses.
    slots: (k,) integer tensor on the cache's device.  Returns ``cache``."""
    ax = _slot_batch_axis(cfg)
    slots = slots.to(torch.long)
    for buf, r in zip(_cache_leaves(cache), _cache_leaves(rows)):
        buf.index_copy_(ax, slots, r.to(buf.dtype))
    return cache


@torch.no_grad()
def prefill_into_slots(model: LM, cfg: ModelConfig, cache, tokens: torch.Tensor,
                       slots: torch.Tensor, *, cross_kv=None, pool_cross_kv=None, mesh=None,
                       rules=None):
    """Admit requests into a live slot pool: a batch-k :func:`prefill` into
    fresh staging rows (the same math and cache layout as a solo prefill),
    then one whole-row write a cache tensor into ``slots`` of the live
    cache, in place.  Lines the prompt does not reach stay zero and are
    masked by the per-slot validity mask until the new occupant writes them.

    tokens: (k, s) prompts of one length; slots: (k,) integer tensor.
    ``cross_kv``: the admitted rows' (an encoder-decoder's, (L, k, ...)),
    which the prefill attends to and, with ``pool_cross_kv`` (the pool's
    rows, (L, b, ...)), lands at ``slots`` of it in place (``index_copy_``:
    a graph captured over the pool's rows keeps their addresses).  Returns
    (last-token logits (k, 1, vocab), cache).  ``mesh=`` / ``rules=`` as in
    :func:`prefill`: ``cache`` is this rank's block of the pool and
    ``slots`` index it locally; the admitted rows are the rank's own (not a
    block of a batch), as the fault hash reads them."""
    if mesh is not None:
        with _mesh_scope(cfg, mesh, rules, {"batch": tokens.shape[0]}):
            return prefill_into_slots(model, cfg, cache, tokens, slots, cross_kv=cross_kv,
                                      pool_cross_kv=pool_cross_kv)
    rows = slot_rows_like(cfg, cache, tokens.shape[0])
    logits, rows = prefill(model, cfg, rows, tokens, cross_kv=cross_kv, last_logit_only=True)
    if pool_cross_kv is not None:
        for name, buf in pool_cross_kv.items():
            buf.index_copy_(1, slots.to(torch.long), cross_kv[name].to(buf.dtype))
    return logits, insert_cache_slots(cfg, cache, rows, slots)


def _stream_bits(keys: torch.Tensor, pos: torch.Tensor, vocab: int) -> torch.Tensor:
    """(b, vocab) 32-bit words (in int64) of a counter-based hash of (seed,
    request id, position, vocab index): integer ops only, so the same bits
    on the CPU and the card, and capturable in a CUDA graph.  A row's words
    depend on its request and token index, never on its slot."""
    k = keys.to(torch.int64)
    row = _mix32(_mix32(_mix32(k[:, 0]) ^ k[:, 1]) ^ (pos.to(torch.int64) & _M32))[:, None]
    idx = torch.arange(vocab, dtype=torch.int64, device=keys.device)
    return _mix32((_mix32(row ^ idx) + row) & _M32)


def _gumbel(keys: torch.Tensor, pos: torch.Tensor, vocab: int) -> torch.Tensor:
    """Standard Gumbel noise (b, vocab) float32 from :func:`_stream_bits`."""
    u = ((_stream_bits(keys, pos, vocab) >> 8).to(torch.float32) + 0.5) * 2.0**-24  # (0, 1)
    return -torch.log(-torch.log(u))


def sample_tokens(logits: torch.Tensor, pos: torch.Tensor, keys: Optional[torch.Tensor],
                  temperature: float, top_k: int) -> torch.Tensor:
    """Per-slot next token from (b, v) float32 logits, as (b,) int32.

    Greedy when ``temperature`` is 0: the argmax, first index on ties (as
    ``jnp.argmax``).  Otherwise Gumbel-max over ``logits / temperature``
    (the law of ``jax.random.categorical``), with ``top_k`` keeping the
    logits ``>=`` the k-th largest; the noise comes from each row's (seed,
    request id) key words and its position ``pos`` (:func:`_gumbel`), so a
    request's samples depend only on its key and token index.  The bits
    are not ``jax.random``'s (ROADMAP C.15)."""
    if not temperature:
        return logits.argmax(dim=-1).to(torch.int32)
    lg = logits.float() / logits.new_full((), temperature, dtype=torch.float32)
    if top_k:
        kth = torch.topk(lg, top_k, dim=-1).values[:, -1:]
        lg = torch.where(lg >= kth, lg, float("-inf"))
    return (lg + _gumbel(keys, pos, lg.shape[-1])).argmax(dim=-1).to(torch.int32)


def _canary_update(served: torch.Tensor, exact: torch.Tensor, active: torch.Tensor,
                   stats) -> None:
    """Fold one canary into the per-slot stats ``(cc, cd, cmr, crs)`` in
    place, over the active rows: checks, argmax divergences, the max
    relative logit error max|served - exact| / max|exact| and the sum of the
    mean relative error |served - exact| / |exact| (a NaN served row makes
    ``cmr`` NaN; the health latch is the signal there)."""
    cc, cd, cmr, crs = stats
    agree = served.argmax(dim=-1) == exact.argmax(dim=-1)
    err = (served - exact).abs()
    ref = exact.abs()
    rel = err.amax(dim=-1) / ref.amax(dim=-1).clamp_min(1e-20)
    red = (err / ref.clamp_min(1e-20)).mean(dim=-1)
    cc += active.to(torch.int32)
    cd += (active & ~agree).to(torch.int32)
    torch.maximum(cmr, torch.where(active, rel, 0.0), out=cmr)
    crs += torch.where(active, red, 0.0)


@torch.no_grad()
def decode_slots_step(model: LM, cfg: ModelConfig, pool: dict, toks: torch.Tensor,
                      emitted: torch.Tensor, i: int, *, eos_id: Optional[int] = None,
                      temperature: float = 0.0, top_k: int = 0, unit_levels=None,
                      logits_hook=None, health=None, canary: bool = False,
                      canary_stats=None, cross_kv=None) -> None:
    """One slot-scheduled decode step over ``pool`` (an
    :func:`init_pool_state` dict), every row an independent request.

    Each active slot emits the token it FEEDS (the :func:`generate_scan`
    convention) into ``toks[:, i]`` and its liveness into ``emitted[:, i]``,
    advances ``pos``, spends one of ``remaining``, and goes inactive once its
    budget is spent or the token it just emitted is ``eos_id`` (the EOS is
    emitted).  Inactive slots re-feed their last token at a frozen position:
    their logits are discarded and row-wise math keeps them from touching
    live rows.  ``unit_levels`` as in :func:`decode_step` (a (b,) int32
    tensor on the pool's device); ``logits_hook`` (float32 logits -> float32
    logits, e.g. ``core.faults.logits_hook``) is applied to each step's
    last-position logits before sampling.  ``health`` ((b,) bool ``bad``,
    (b,) float32 ``mx``, owned by the caller) latches the reference's two
    per-slot health signals in place over the logits sampling sees: ``bad
    |= active & ~isfinite(lg).all(-1)`` and ``mx = max(mx, where(active,
    max |lg|, 0))`` (a NaN row makes ``mx`` NaN; ``bad`` has latched then).

    ``canary`` (a Python bool, fixed when a chunk is built) runs the
    shadow-exact canary of this step: the same step through
    :func:`exact_twin` (no hook, no levels) from the pre-step cache, its
    logits compared with the served ones after the hook, folded into
    ``canary_stats`` ((b,) int32 ``cc``, ``cd``, (b,) float32 ``cmr``,
    ``crs``, owned by the caller; see :func:`_canary_update`).  The shadow
    runs first and writes the K/V lines (and int8 scales) the served step
    then overwrites; its recurrent layers read the pool's states and drop
    their new ones (``decode_step(write_state=False)``), so only the served
    step advances them and no shadow state survives the step.  ``cross_kv``
    (an encoder-decoder's, the pool's rows) as in :func:`decode_step`, for
    both.

    Updates the pool in place and reads nothing back to the host, so a run
    of steps can be captured in a CUDA graph."""
    tok, pos, active, remaining = pool["tok"], pool["pos"], pool["active"], pool["remaining"]
    if canary:
        exact, _ = decode_step(model, exact_twin(cfg), pool["cache"], tok, pos, cross_kv=cross_kv,
                               write_state=False)
    logits, _ = decode_step(model, cfg, pool["cache"], tok, pos, cross_kv=cross_kv,
                            unit_levels=unit_levels)
    lg = logits[:, -1].float()
    if logits_hook is not None:
        with fault_block(("batch", None), lg.shape):  # the rows' global indices on a mesh
            lg = logits_hook(lg)
    if canary:
        _canary_update(lg, exact[:, -1].float(), active, canary_stats)
    if health is not None:
        bad, mx = health
        bad |= active & ~torch.isfinite(lg).all(dim=-1)
        torch.maximum(mx, torch.where(active, lg.abs().amax(dim=-1), 0.0), out=mx)
    nxt = sample_tokens(lg, pos, pool["keys"], temperature, top_k)
    fed = tok[:, 0]
    toks[:, i] = fed
    emitted[:, i] = active
    live = active.to(torch.int32)
    remaining.sub_(live)
    still = active & (remaining > 0)
    if eos_id is not None:
        still &= fed != eos_id
    pos.add_(live)
    tok.copy_(torch.where(active[:, None], nxt[:, None], tok))
    active.copy_(still)


def canary_steps(n_steps: int, stride: Optional[int], offset: int = 0) -> tuple:
    """The steps of a run of ``n_steps`` that fire a canary: those whose
    lifetime index ``offset + i`` is a multiple of ``stride`` (none when
    ``stride`` is 0 or None)."""
    if not stride:
        return ()
    return tuple(i for i in range(n_steps) if (offset + i) % stride == 0)


@torch.no_grad()
def decode_slots_scan(model: LM, cfg: ModelConfig, cache, tok, pos, active, remaining,
                      n_steps: int, *, eos_id: Optional[int] = None, temperature: float = 0.0,
                      top_k: int = 0, keys: Optional[torch.Tensor] = None, unit_levels=None,
                      logits_hook=None, with_health: bool = False,
                      canary_stride: Optional[int] = None, canary_offset: int = 0,
                      cross_kv=None, mesh=None, rules=None):
    """``n_steps`` of :func:`decode_slots_step`: a Python loop with no host
    synchronisation (the reference's ``lax.scan``).

    tok (b, 1) int32, pos (b,) int32, active (b,) bool, remaining (b,) int32
    and the cache are updated IN PLACE; keys (b, 2) uint32 request-derived
    stream words, required when ``temperature`` > 0.  ``unit_levels`` ((b,),
    requires ``cfg.sqrt_ladder``) and ``logits_hook`` as in
    :func:`decode_slots_step`.  Returns (toks (b, n_steps) int32, emitted
    (b, n_steps) bool, tok, pos, active, remaining, cache), the reference's
    order; ``with_health`` appends the chunk's health signals (bad (b,)
    bool, mx (b,) float32; see :func:`decode_slots_step`).

    ``canary_stride=N`` (0 or None: off) runs the shadow-exact canary on
    every step whose lifetime index ``canary_offset + i`` is a multiple of
    N (:func:`canary_steps`; a step that does not fire computes nothing for
    it) and appends the four per-slot stats: canary checks (b,) int32,
    argmax divergences (b,) int32, the max relative logit error (b,)
    float32 and the sum of the mean relative errors (b,) float32.
    ``cross_kv``: an encoder-decoder's, the pool's rows (see
    :func:`prefill_into_slots`).  ``mesh=`` / ``rules=`` as in
    :func:`prefill`, every step inside the scope, on this rank's block of
    the pool."""
    if mesh is not None:
        with _mesh_scope(cfg, mesh, rules):
            return decode_slots_scan(model, cfg, cache, tok, pos, active, remaining, n_steps,
                                     eos_id=eos_id, temperature=temperature, top_k=top_k,
                                     keys=keys, unit_levels=unit_levels,
                                     logits_hook=logits_hook, with_health=with_health,
                                     canary_stride=canary_stride,
                                     canary_offset=canary_offset, cross_kv=cross_kv)
    if temperature and keys is None:
        raise ValueError(
            "temperature sampling needs per-request keys (a (b, 2) keys tensor); "
            "slot-index defaults would tie a request's samples to its slot"
        )
    levels = _levels(cfg, unit_levels, tok.device)
    pool = {"cache": cache, "tok": tok, "pos": pos, "active": active,
            "remaining": remaining, "keys": keys}
    b, dev = tok.shape[0], tok.device
    toks = torch.zeros((b, n_steps), dtype=torch.int32, device=dev)
    emitted = torch.zeros((b, n_steps), dtype=torch.bool, device=dev)
    health = ((torch.zeros(b, dtype=torch.bool, device=dev),
               torch.zeros(b, dtype=torch.float32, device=dev)) if with_health else None)
    stats = (tuple(torch.zeros(b, dtype=dt, device=dev) for dt in (torch.int32, torch.int32,
                                                                   torch.float32, torch.float32))
             if canary_stride else None)
    fire = canary_steps(n_steps, canary_stride, int(canary_offset))
    for i in range(n_steps):
        decode_slots_step(model, cfg, pool, toks, emitted, i, eos_id=eos_id,
                          temperature=temperature, top_k=top_k, unit_levels=levels,
                          logits_hook=logits_hook, health=health, canary=i in fire,
                          canary_stats=stats, cross_kv=cross_kv)
    return (toks, emitted, tok, pos, active, remaining, cache) + (health or ()) + (stats or ())


# ---------------------------------------------------------------------------
# Speculative decoding: draft-and-verify over the slot pool
# ---------------------------------------------------------------------------


def _validate_spec_cfg(cfg: ModelConfig, *, what: str = "speculative decode"):
    """Speculation covers the cache families whose verify rows are exact
    (dense, ring and int8 KV): attention-only decoder stacks, no MoE routing
    (sequence-level capacity couples the rows) and no recurrent state (an
    SSM or RG-LRU step cannot be verified position-parallel)."""
    bad = [b for b in cfg.blocks if b not in ("global", "window")]
    if bad or cfg.moe is not None or cfg.kind != "decoder":
        raise ValueError(f"{what} supports attention-only decoder LMs (dense/ring/int8 KV "
                         f"caches); got kind={cfg.kind!r}, blocks={tuple(cfg.blocks)!r}, "
                         f"moe={cfg.moe is not None}")


def _validate_spec_k(cfg: ModelConfig, k: int) -> None:
    """k >= 1, and a verify block of k+1 rows within every ring."""
    if k < 1:
        raise ValueError(f"speculation needs k >= 1 draft tokens, got k={k}")
    if "window" in cfg.blocks and k + 1 > cfg.window:
        raise ValueError(f"verify block k+1={k + 1} exceeds the sliding window ({cfg.window}); "
                         f"pick k <= window - 1")


def gather_verify_lines(cfg: ModelConfig, cache, pos: torch.Tensor, sq: int):
    """Every layer's lines at the ring slots of a verify block of ``sq``
    rows (``attention.gather_verify_lines``), taken before anything of the
    step writes: a stacked dict for a uniform stack, a per-layer list for a
    mixed one.  The rollback source of :func:`commit_verify_cache`."""
    if isinstance(cache, list):
        return [attn.gather_verify_lines(c, pos, sq) for c in cache]
    return attn.gather_verify_lines(cache, pos, sq, stacked=True)


@torch.no_grad()
def decode_verify_step(model: LM, cfg: ModelConfig, cache, tokens: torch.Tensor,
                       pos: torch.Tensor, *, unit_levels=None, old=None):
    """One draft-verify forward over ``sq = k+1`` rows a slot (the
    reference's ``decode_verify_step``).

    tokens: (b, sq) integer, column 0 the token each slot feeds at ``pos``
    ((b,) int tensor), the rest its drafts.  The embedding, norms, projections,
    MLP and unembed run once over the ``b * sq`` rows (the projections
    through ``layers.rowwise.matmul``); the attention runs row by row in
    every layer (``attention.attention_verify``), so row ``j``'s logits are
    the sequential :func:`decode_step`'s at ``pos + j`` after feeding rows
    ``0..j-1``, bit for bit.  Unlike the reference, which leaves the cache
    untouched, every row's line is written in place; ``old`` holds the lines
    the rows overwrote (:func:`gather_verify_lines`, taken here unless the
    caller took them earlier), and :func:`commit_verify_cache` rolls the
    rejected rows back.  ``unit_levels`` as in :func:`decode_step`, for every
    row of a slot.  Returns (logits (b, sq, vocab), old)."""
    _validate_spec_cfg(cfg, what="decode_verify_step")
    pos = pos.to(device=tokens.device, dtype=torch.int32)
    if old is None:
        old = gather_verify_lines(cfg, cache, pos, tokens.shape[1])
    levels = _levels(cfg, unit_levels, tokens.device)
    mm = rowwise.matmul
    x = _embed(model, cfg, tokens)
    if cfg.pos == "sinusoidal":  # a row at a time, at the sequential step's shape
        pe = torch.stack([_step_sinusoid(pos + j, cfg.d_model, x.device)
                          for j in range(tokens.shape[1])], dim=1)
        x = x + pe.to(x.dtype)
    for i, (layer, block) in enumerate(zip(model.layers, cfg.blocks)):
        c, idx = _layer_cache(cache, i)
        h = _norm(layer, "ln1", x, cfg, levels=levels)
        h, _ = attn.attention_verify(layer.attn, cfg, h, c, pos, window=_window(cfg, block),
                                     layer_idx=idx, norm_levels=levels, mm=mm)
        x = x + h
        x = x + _ffn(layer, cfg, _norm(layer, "ln2", x, cfg, levels=levels), mm=mm)[0]
    return constrain(_logits(model, cfg, x, levels, mm=mm), ("batch", "seq", "vocab")), old


def commit_verify_cache(cfg: ModelConfig, cache, old, pos: torch.Tensor, n_commit: torch.Tensor):
    """Commit the accepted prefix of a verify block in every layer, in place:
    rows ``j < n_commit[b]`` keep their lines, the rest get ``old``'s back
    (``attention.verify_cache_commit``).  Returns ``cache``."""
    if isinstance(cache, list):
        for c, o in zip(cache, old):
            attn.verify_cache_commit(c, o, pos, n_commit)
        return cache
    return attn.verify_cache_commit(cache, old, pos, n_commit, stacked=True)


def draft_ngram(hist: torch.Tensor, tok: torch.Tensor, pos: torch.Tensor, k: int) -> torch.Tensor:
    """Self-drafting by prompt lookup: the ``k`` tokens that followed the
    most recent earlier occurrence of ``tok`` in the slot's fed history.
    hist: (b, H) int32, ``hist[p]`` the token fed at position ``p`` for
    ``p < pos``; tok: (b,) the token about to be fed at ``pos``.  Draft
    positions past the written history, and slots with no match, repeat
    ``tok``.  Device ops only.  Returns (b, k) int32."""
    b, H = hist.shape
    idx = torch.arange(H, device=hist.device)
    cand = (hist == tok[:, None]) & (idx[None, :] < pos[:, None])
    p_star = torch.where(cand, idx[None, :], -1).amax(dim=1)  # (b,), -1: none
    didx = p_star[:, None] + torch.arange(1, k + 1, device=hist.device)[None, :]
    drafts = hist.gather(1, didx.clamp(0, H - 1))
    usable = (p_star[:, None] >= 0) & (didx < pos[:, None])
    return torch.where(usable, drafts, tok[:, None]).to(torch.int32)


@torch.no_grad()
def decode_slots_spec_step(model: LM, cfg: ModelConfig, pool: dict, hist: torch.Tensor,
                           toks: torch.Tensor, emitted: torch.Tensor, i: int, *, k: int,
                           counts, eos_id: Optional[int] = None, unit_levels=None,
                           spec_disable=None, logits_hook=None, health=None,
                           canary: bool = False, canary_stats=None, draft=None) -> None:
    """One draft-and-verify step over ``pool`` (an :func:`init_pool_state`
    dict), committing 1..k+1 tokens an active slot, greedy.

    Each slot drafts ``k`` tokens (:func:`draft_ngram` over ``hist``, or
    ``draft = (model, cfg, cache)``: k greedy :func:`decode_step` s of a
    draft model), verifies the block ``[tok, drafts]`` in one
    :func:`decode_verify_step`, accepts the longest prefix of drafts equal
    to the verify's argmaxes (cumprod), truncated by the budget and by the
    first EOS, and commits those rows (:func:`commit_verify_cache`).  The
    block goes to ``toks[:, i*(k+1):(i+1)*(k+1)]`` and the commit mask to
    the same columns of ``emitted``: the tokens FED, the sequential
    convention.  ``hist`` gets the committed tokens (writes past its width
    go to a dump column and are dropped); ``counts = (accepted, steps)``
    ((b,) int32) add the drafts accepted and the active steps.

    ``spec_disable`` ((b,) bool, demoted slots) clamps acceptance to 0: row
    0 is the sequential step.  ``health`` latches over the committed rows
    only; the canary (``canary``, as in :func:`decode_slots_step`) runs on
    row 0 from the pre-step cache.  The rollback lines are gathered before
    the canary's shadow and the drafting write, so a slot that commits
    nothing (an inactive one) gets its pre-step lines back.  The draft
    model drafts in place from lines it then restores, and lands the
    committed rows through its own verify and commit.  In place, no host
    read: a run of steps can be captured in a CUDA graph."""
    tok, pos, active, remaining = pool["tok"], pool["pos"], pool["active"], pool["remaining"]
    accepted, steps = counts
    sq = k + 1
    dev = tok.device
    offs = torch.arange(sq, dtype=torch.int32, device=dev)
    old = gather_verify_lines(cfg, pool["cache"], pos, sq)
    if draft is not None:
        dmodel, dcfg, dcache = draft
        dold = gather_verify_lines(dcfg, dcache, pos, sq)
        t, cols = tok, []
        for j in range(k):
            dlg, _ = decode_step(dmodel, dcfg, dcache, t, pos + j)
            t = dlg[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
            cols.append(t)
        drafts = torch.cat(cols, dim=1)
        commit_verify_cache(dcfg, dcache, dold, pos, torch.zeros_like(pos))
    else:
        drafts = draft_ngram(hist, tok[:, 0], pos, k)
    block = torch.cat([tok, drafts], dim=1)  # (b, sq)
    if canary:
        exact, _ = decode_step(model, exact_twin(cfg), pool["cache"], tok, pos)
    logits, _ = decode_verify_step(model, cfg, pool["cache"], block, pos,
                                   unit_levels=unit_levels, old=old)
    lg = logits.float()
    if logits_hook is not None:  # a row at a time, as the sequential steps see it
        lg = torch.stack([logits_hook(lg[:, j].contiguous()) for j in range(sq)], dim=1)
    out_tok = lg.argmax(dim=-1).to(torch.int32)  # (b, sq)

    agree = (drafts == out_tok[:, :-1]).to(torch.int32)
    acc = agree.cumprod(dim=1).sum(dim=1).to(torch.int32)
    if spec_disable is not None:
        acc = torch.where(spec_disable, 0, acc)
    n_flow = torch.minimum(acc + 1, remaining.clamp_min(1))
    if eos_id is not None:
        is_eos = block == eos_id
        first = is_eos.to(torch.int32).argmax(dim=1).to(torch.int32)
        n_flow = torch.where(is_eos.any(dim=1), torch.minimum(n_flow, first + 1), n_flow)
    n_commit = torch.where(active, n_flow, 0).to(torch.int32)
    commit = offs[None, :] < n_commit[:, None]  # (b, sq)

    if canary:
        _canary_update(lg[:, 0], exact[:, -1].float(), active, canary_stats)
    if health is not None:
        bad, mx = health
        bad |= (commit & ~torch.isfinite(lg).all(dim=-1)).any(dim=1)
        row_mx = torch.where(commit, lg.abs().amax(dim=-1), 0.0).amax(dim=1)
        torch.maximum(mx, row_mx, out=mx)

    commit_verify_cache(cfg, pool["cache"], old, pos, n_commit)
    if draft is not None:
        decode_verify_step(dmodel, dcfg, dcache, block, pos, old=dold)
        commit_verify_cache(dcfg, dcache, dold, pos, n_commit)
    H = hist.shape[1]
    hidx = torch.where(commit, pos[:, None] + offs[None, :], H).clamp(max=H).long()
    landed = torch.cat([hist, hist.new_zeros((hist.shape[0], 1))], dim=1)
    landed.scatter_(1, hidx, block)  # the dump column H takes the uncommitted rows
    hist.copy_(landed[:, :H])

    last = (n_commit - 1).clamp(0, k).long()[:, None]
    nxt = out_tok.gather(1, last)
    fed_last = block.gather(1, last)[:, 0]
    toks[:, i * sq:(i + 1) * sq] = block
    emitted[:, i * sq:(i + 1) * sq] = commit
    remaining.sub_(n_commit)
    still = active & (remaining > 0)
    if eos_id is not None:
        still &= fed_last != eos_id
    pos.add_(n_commit)
    tok.copy_(torch.where(active[:, None], nxt, tok))
    accepted.add_((n_commit - 1).clamp_min(0))
    steps.add_(active.to(torch.int32))
    active.copy_(still)


@torch.no_grad()
def decode_slots_spec_scan(model: LM, cfg: ModelConfig, cache, tok, pos, active, remaining,
                           hist, n_steps: int, *, k: int, eos_id: Optional[int] = None,
                           with_health: bool = False, logits_hook=None, unit_levels=None,
                           spec_disable=None, canary_stride: Optional[int] = None,
                           canary_offset: int = 0, draft_model: Optional[LM] = None,
                           draft_cfg: Optional[ModelConfig] = None, draft_cache=None):
    """``n_steps`` of :func:`decode_slots_spec_step` (the reference's
    ``decode_slots_spec_scan``): a Python loop with no host read.

    tok (b, 1), pos, active, remaining, hist (b, H) int32 and the cache (and
    ``draft_cache``) are updated IN PLACE.  Drafting is the n-gram lookup
    unless ``draft_model``, ``draft_cfg`` and ``draft_cache`` are given
    together.  ``spec_disable`` ((b,) bool) clamps acceptance to 0 for its
    slots; ``unit_levels``, ``logits_hook``, ``with_health`` and the canary
    (on row 0, at the spec steps whose lifetime index ``canary_offset + i``
    is a multiple of ``canary_stride``) as in :func:`decode_slots_scan`.
    Greedy only: acceptance compares argmaxes, so the emitted stream is
    :func:`decode_slots_scan`'s, token for token.

    Returns (toks (b, n_steps*(k+1)), emitted (b, n_steps*(k+1)) bool, tok,
    pos, active, remaining, cache, hist, accepted (b,) int32 drafts
    accepted, spec_steps (b,) int32 active steps), then ``draft_cache`` when
    drafting with a model, then the health and canary extras of
    :func:`decode_slots_scan`: the reference's order."""
    _validate_spec_cfg(cfg)
    _validate_spec_k(cfg, k)
    use_draft = draft_model is not None
    if use_draft:
        if draft_cfg is None or draft_cache is None:
            raise ValueError("draft-model speculation needs draft_model, draft_cfg and "
                             "draft_cache together")
        _validate_spec_cfg(draft_cfg, what="draft model")
        if draft_cfg.vocab != cfg.vocab:
            raise ValueError(f"draft vocab {draft_cfg.vocab} != target vocab {cfg.vocab}")
    levels = _levels(cfg, unit_levels, tok.device)
    pool = {"cache": cache, "tok": tok, "pos": pos, "active": active, "remaining": remaining}
    b, dev, sq = tok.shape[0], tok.device, k + 1
    toks = torch.zeros((b, n_steps * sq), dtype=torch.int32, device=dev)
    emitted = torch.zeros((b, n_steps * sq), dtype=torch.bool, device=dev)
    counts = tuple(torch.zeros(b, dtype=torch.int32, device=dev) for _ in range(2))
    health = ((torch.zeros(b, dtype=torch.bool, device=dev),
               torch.zeros(b, dtype=torch.float32, device=dev)) if with_health else None)
    stats = (tuple(torch.zeros(b, dtype=dt, device=dev) for dt in (torch.int32, torch.int32,
                                                                   torch.float32, torch.float32))
             if canary_stride else None)
    fire = canary_steps(n_steps, canary_stride, int(canary_offset))
    draft = (draft_model, draft_cfg, draft_cache) if use_draft else None
    for i in range(n_steps):
        decode_slots_spec_step(model, cfg, pool, hist, toks, emitted, i, k=k, counts=counts,
                               eos_id=eos_id, unit_levels=levels, spec_disable=spec_disable,
                               logits_hook=logits_hook, health=health, canary=i in fire,
                               canary_stats=stats, draft=draft)
    out = (toks, emitted, tok, pos, active, remaining, cache, hist) + counts
    return out + ((draft_cache,) if use_draft else ()) + (health or ()) + (stats or ())
