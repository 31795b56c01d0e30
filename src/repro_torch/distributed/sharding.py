"""Logical-axis -> physical-mesh rule tables (torch port of
``repro.distributed.sharding``), and the placements that put a tree on a
mesh.

Production mesh axes: ("pod", "data", "model") multi-pod / ("data",
"model") single-pod.  Parameters and optimizer state are FSDP-sharded over
the data-parallel axes (ZeRO-3) *and* tensor-parallel over 'model';
activations shard batch over DP and heads/mlp over 'model'.  Serving
replicates params across DP (no per-step all-gather latency) unless the
arch is too big (qwen3-moe: experts shard over 'data' at decode).

A physical axis is claimed at most once per tensor (`logical_to_spec`), so
e.g. ("embed", "heads", None) -> (("pod", "data"), "model", None).

The tables and :func:`divisible_spec` read only a mesh's axis names and
sizes: a ``DeviceMesh`` (``mesh_dim_names``, ``shape``) or a
:class:`MeshShape` with the same two fields.  A leaf of
:func:`shardings_for` is a :class:`Sharding`, the port's ``NamedSharding``:
the mesh, the spec and its DTensor placements, one ``Shard(dim)`` or
``Replicate()`` a mesh dim.  Every rank runs its own process and holds the
whole of each host tree it places, so :func:`place` cuts the rank's block
without communicating; :func:`place_model` gives a rank its block of every
parameter as a model of plain tensors, which the layers compute on, and
:func:`place_train_state` its blocks of a training model's float32
masters and of AdamW's state (:func:`gather_train_state` the whole
tensors back).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.distributed.constraints import Rules, _names, logical_to_spec
from repro_torch.models.config import ModelConfig

__all__ = [
    "MeshShape",
    "Sharding",
    "train_rules",
    "serve_rules",
    "is_spec_leaf",
    "divisible_spec",
    "mesh_sizes",
    "placements_for",
    "shardings_for",
    "serve_pool_shardings",
    "serve_pool_tree",
    "local_rows",
    "place",
    "zeros_tree",
    "local_tree",
    "gather",
    "full_tensor",
    "place_model",
    "place_train_state",
    "gather_train_state",
    "place_batch",
    "local_group",
]


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes without devices: all the rule tables
    read."""

    mesh_dim_names: tuple
    shape: tuple


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or a :class:`MeshShape`, in
    mesh order."""
    return dict(zip(tuple(mesh.mesh_dim_names), tuple(mesh.shape)))


def _fsdp_axes(mesh):
    names = mesh_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def train_rules(cfg: ModelConfig, mesh, *, seq_parallel: bool = False) -> Rules:
    """``seq_parallel`` shards the residual stream's sequence axis over
    'model' between blocks (Megatron-SP): the scan-carried activations and
    norm compute shard 16x at the cost of boundary all-gathers."""
    fsdp = _fsdp_axes(mesh)
    model_size = mesh_sizes(mesh)["model"]
    rules: Rules = {
        # activations
        "batch": fsdp,
        "seq": "model" if seq_parallel else None,
        # params (FSDP x TP)
        "embed": fsdp,
        "heads": "model",
        "kv_heads": "model" if cfg.n_kv_heads % model_size == 0 else None,
        "heads_mix": "model",
        "mlp": "model",
        "vocab": "model",
        "layers": None,
        "expert": None,
        # caches (train unused)
        "kv_seq": None,
    }
    if cfg.moe is not None:
        if cfg.moe.n_experts % model_size == 0:
            # EP: experts over 'model'; expert-ffn dim falls back to replicated
            rules["expert"] = "model"
            rules["mlp"] = "model"  # claimed second -> replicated on expert w
        # else: experts replicated, ffn dim TP (mixtral path)
    return rules


def serve_rules(cfg: ModelConfig, mesh, *, seq_shard_kv: bool = False,
                replicate_params: bool = False) -> Rules:
    """Serving rule table.

    Default: tensor-parallel: params sharded over 'model' (replicated
    across DP for latency), KV cache batch-over-data and
    kv-heads-over-model.

    ``replicate_params=True`` is the *exact* serving mode: params replicate
    everywhere and the batch (slot) axis claims EVERY mesh axis, so each
    device owns a contiguous block of slots end-to-end.  No contraction
    ever crosses a shard boundary, which makes mesh decode bit-exact against
    a single device (TP's partitioned wo/mlp reductions reassociate the
    sums, enough to flip a greedy argmax).  Use it when the model fits one
    device and the pool is what needs scaling.
    """
    names = tuple(mesh_sizes(mesh))
    if replicate_params:
        rules: Rules = {
            "batch": names,
            "seq": None,
            "embed": None,
            "heads": None,
            "kv_heads": None,
            "heads_mix": None,
            "mlp": None,
            "vocab": None,
            "layers": None,
            "expert": None,
            "kv_seq": None,
            "kv_dim": None,
        }
        return rules
    if "kv" in names:
        return _serve_rules_kv_mesh(cfg, mesh, seq_shard_kv=seq_shard_kv)
    fsdp = _fsdp_axes(mesh)
    sizes = mesh_sizes(mesh)
    model_size = sizes["model"]
    rules: Rules = {
        "batch": fsdp,
        "seq": None,
        # params: TP only; replicated across DP for serving latency
        "embed": None,
        "heads": "model",
        # kv_heads shard over 'model' when divisible; otherwise the KV cache
        # replicates across 'model' and decode fits memory via the int8 cache
        "kv_heads": "model" if cfg.n_kv_heads % model_size == 0 else None,
        "heads_mix": "model",
        "mlp": "model",
        "vocab": "model",
        "layers": None,
        "expert": None,
        # never shard the cache's sequence axis: a per-token write at a
        # dynamic index of a sharded dim turns an O(token) update into an
        # O(cache) rewrite, and sharding head_dim gathers the whole KV per
        # layer; kv_heads over 'model' keeps updates local and attention
        # collective-free
        "kv_seq": None,
        "kv_dim": None,
    }
    if seq_shard_kv:
        # long-context decode (batch=1): batch can't shard; KV stays model-
        # sharded via heads and replicates over DP
        rules["batch"] = None
    if cfg.moe is not None:
        per_chip_gb = _param_gib(cfg) / model_size
        if per_chip_gb > 12.0 and cfg.moe.n_experts % sizes.get("data", 1) == 0:
            rules["expert"] = "data"  # qwen3-moe: too big for pure TP
    return rules


def _serve_rules_kv_mesh(cfg: ModelConfig, mesh, *, seq_shard_kv: bool = False) -> Rules:
    """Decode mesh reshaped to (pod?, data, kv, qg): the 'model' dimension
    is split into kv_heads x query-groups so the KV cache is *persistently*
    kv-head-sharded, and every tensor's steady-state sharding equals its
    in-step sharding: no cache collectives."""
    fsdp = _fsdp_axes(mesh)
    sizes = mesh_sizes(mesh)
    rules: Rules = {
        "batch": fsdp,
        "seq": None,
        "embed": None,
        "heads": ("kv", "qg"),
        "kv_heads": "kv",
        "heads_mix": ("kv", "qg"),
        "mlp": ("kv", "qg"),
        "vocab": ("kv", "qg"),
        "layers": None,
        "expert": None,
        "kv_seq": None,
        "kv_dim": None,
    }
    if seq_shard_kv:
        rules["batch"] = None
    if cfg.moe is not None:
        per_chip_gb = _param_gib(cfg) / (sizes["kv"] * sizes["qg"])
        if per_chip_gb > 12.0 and cfg.moe.n_experts % sizes.get("data", 1) == 0:
            rules["expert"] = "data"
    return rules


def _param_gib(cfg: ModelConfig) -> float:
    """Rough bf16 parameter GiB (for serve-sharding policy)."""
    d, f, L, v = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab
    attn = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.d_head + cfg.n_heads * cfg.d_head * d
    if cfg.moe is not None:
        ffn = 3 * d * cfg.moe.d_ff_expert * cfg.moe.n_experts
    else:
        ffn = (3 if cfg.mlp_act == "swiglu" else 2) * d * f
    total = L * (attn + ffn) + 2 * v * d
    return total * 2 / 2**30


def is_spec_leaf(s) -> bool:
    return isinstance(s, tuple) and all(isinstance(e, (str, type(None))) for e in s)


def divisible_spec(spec, shape, mesh) -> tuple:
    """Drop mesh axes a dim's size can't divide (replicate instead), e.g.
    gemma3's 4 heads on a 16-wide 'model' axis, or odd vocabs."""
    sizes = mesh_sizes(mesh)
    parts = []
    for i, p in enumerate(spec):
        if p is None:
            parts.append(None)
            continue
        kept = []
        size = shape[i]
        for a in _names(p):
            n = sizes[a]
            if size % n == 0:
                kept.append(a)
                size //= n
        parts.append(tuple(kept) if len(kept) > 1 else (kept[0] if kept else None))
    return tuple(parts)


def placements_for(spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` of the tensor dim whose entry names it, else
    ``Replicate()``.  Several mesh axes on one dim must come in mesh order
    (DTensor shards them in that order, the first major): a spec that names
    them otherwise raises rather than being reordered."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh_sizes(mesh))
    owner = {}
    for d, part in enumerate(spec):
        axes = _names(part)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: dim {d} names mesh axes {axes} out of mesh "
                             f"order {names}")
        for a in axes:
            owner[a] = d
    return tuple(Shard(owner[a]) if a in owner else Replicate() for a in names)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """The port's ``NamedSharding``: a mesh, a spec (one entry a tensor dim)
    and the spec's DTensor placements on the mesh."""

    mesh: object
    spec: tuple
    placements: tuple

    @classmethod
    def of(cls, mesh, spec) -> "Sharding":
        return cls(mesh, tuple(spec), placements_for(spec, mesh))


def _tree_map(fn, tree, *rest, is_leaf=is_spec_leaf):
    """``fn`` over the leaves of a tree of dicts and lists (``is_leaf``
    marks a leaf), with matching trees ``rest``."""
    if is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def shardings_for(spec_tree, mesh, rules: Rules, shapes=None):
    """Map a logical-spec tree to a :class:`Sharding` tree.  With ``shapes``
    (a matching tree of tensors), indivisible assignments degrade to
    replication per-dim."""
    if shapes is None:
        return _tree_map(lambda s: Sharding.of(mesh, logical_to_spec(s, rules)), spec_tree)
    return _tree_map(
        lambda s, t: Sharding.of(mesh, divisible_spec(logical_to_spec(s, rules), tuple(t.shape),
                                                      mesh)),
        spec_tree, shapes)


def serve_pool_shardings(cfg: ModelConfig, mesh, rules: Rules, *, num_slots: int,
                         cache_len: int, quantized: bool = False) -> dict:
    """Shardings of the continuous-batching engine's slot-pool state on a
    serving mesh.

    The KV slot pool follows the :func:`serve_rules` table (batch, the slot
    axis, sharded over the data-parallel axes, ``kv_heads`` over 'model'
    where divisible) and the per-slot scheduler vectors ride the same batch
    sharding.  Returns a dict::

        {"cache": <tree matching lm.init_cache>,
         "tok":   (num_slots, 1),
         "vec":   (num_slots,),          # pos / active / remaining
         "keys":  (num_slots, 2),        # per-slot sampling words
         "replicated": scalarlike operands (prompts, slot indices)}

    Indivisible dims (``num_slots`` not a multiple of the data axis, 1-row
    admission staging) degrade to replication per-dim, as in
    :func:`shardings_for`.
    """
    from repro_torch.models import lm

    cache_abs = lm.init_cache(cfg, num_slots, cache_len, quantized=quantized, abstract=True)
    cache_sh = shardings_for(lm.cache_specs(cfg, quantized=quantized), mesh, rules, cache_abs)

    def vec_sharding(shape, axes):
        return Sharding.of(mesh, divisible_spec(logical_to_spec(axes, rules), shape, mesh))

    return {
        "cache": cache_sh,
        "tok": vec_sharding((num_slots, 1), ("batch", None)),
        "vec": vec_sharding((num_slots,), ("batch",)),
        "keys": vec_sharding((num_slots, 2), ("batch", None)),
        "replicated": Sharding.of(mesh, ()),
    }


def serve_pool_tree(pool_sh: dict) -> dict:
    """Reshape a :func:`serve_pool_shardings` bundle into a sharding tree
    matching ``lm.init_pool_state``'s layout: the restore target of
    ``Engine.resume``'s elastic path (a snapshot taken on one mesh shape
    lands on another by passing this tree to ``checkpoint.restore``)."""
    return {
        "cache": pool_sh["cache"],
        "tok": pool_sh["tok"],
        "pos": pool_sh["vec"],
        "active": pool_sh["vec"],
        "remaining": pool_sh["vec"],
        "keys": pool_sh["keys"],
    }


def _is_sharding(x) -> bool:
    return isinstance(x, Sharding)


def _block(shape, sh: Sharding) -> tuple:
    """(this rank's slices, its local shape) of a tensor of global
    ``shape`` under ``sh``: per dim, the block index over the mesh axes
    sharding it, the first major."""
    sizes = mesh_sizes(sh.mesh)
    names = tuple(sizes)
    coord = sh.mesh.get_coordinate()
    slices, local = [], []
    for d, n in enumerate(shape):
        idx, parts = 0, 1
        for a in _names(sh.spec[d]) if d < len(sh.spec) else ():
            i = names.index(a)
            idx, parts = idx * sizes[a] + coord[i], parts * sizes[a]
        if n % parts:
            raise ValueError(f"dim {d} of {tuple(shape)} is not divisible by {parts} "
                             f"(spec {sh.spec}); divisible_spec it first")
        step = n // parts
        slices.append(slice(idx * step, (idx + 1) * step))
        local.append(step)
    return tuple(slices), tuple(local)


def local_rows(n: int, sh: Sharding) -> slice:
    """The rows of an ``n``-row tensor (sharded on dim 0 by ``sh``) that
    this rank holds."""
    return _block((n,), sh)[0][0]


def _dtensor(local: torch.Tensor, shape, sh: Sharding):
    from torch.distributed.tensor import DTensor

    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, sh.mesh, sh.placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def place(t: torch.Tensor, sh: Sharding):
    """A DTensor of the whole tensor ``t`` (which every rank holds) on
    ``sh``: this rank keeps its block, on the mesh's device (this rank's
    card on CUDA), with no communication."""
    slices, _ = _block(tuple(t.shape), sh)
    return _dtensor(t[slices].to(_mesh_device(sh.mesh)).contiguous(), tuple(t.shape), sh)


def _mesh_device(mesh) -> torch.device:
    from repro_torch.launch.mesh import is_fake_group

    if mesh.device_type == "cuda" and is_fake_group():
        return torch.device("cuda", 0)  # fake tensors' card: none is opened
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def zeros_tree(like, sh_tree):
    """DTensors of zeros shaped and typed as the tree ``like`` (meta
    tensors do), each rank allocating only its block."""
    def zeros(t, sh):
        local = torch.zeros(_block(tuple(t.shape), sh)[1], dtype=t.dtype,
                            device=_mesh_device(sh.mesh))
        return _dtensor(local, tuple(t.shape), sh)

    return _tree_map(zeros, like, sh_tree, is_leaf=lambda x: isinstance(x, torch.Tensor))


def local_tree(tree):
    """The rank's local tensors of a tree of DTensors (views of the same
    storage: in-place updates reach the DTensors)."""
    return _tree_map(lambda t: t.to_local(), tree, is_leaf=lambda x: isinstance(x, torch.Tensor))


def _gather(local: torch.Tensor, mesh, placements) -> torch.Tensor:
    """The whole tensor from this rank's block: an all-gather a mesh dim
    that shards it, the last mesh dim first, so the blocks land in their
    major-first order (none for a dim one wide).  The bits travel as a
    type of the element's width that gloo gathers (it has no int16 or
    uint32); a gather copies them unchanged."""
    import torch.distributed as dist

    out = local.contiguous()
    dtype = out.dtype
    out = out.view(_BITS[out.element_size()])
    for i in reversed(range(len(placements))):
        p = placements[i]
        if p.is_shard() and mesh.size(i) > 1:
            parts = [torch.empty_like(out) for _ in range(mesh.size(i))]
            dist.all_gather(parts, out, group=mesh.get_group(i))
            out = torch.cat(parts, dim=p.dim)
    return out.view(dtype)


_BITS = {1: torch.uint8, 2: torch.float16, 4: torch.int32, 8: torch.int64}


def gather(local: torch.Tensor, sh: Sharding) -> torch.Tensor:
    """The whole tensor on every rank from this rank's block of it under
    ``sh``."""
    return _gather(local, sh.mesh, sh.placements)


def full_tensor(x) -> torch.Tensor:
    """The whole tensor of a DTensor on every rank (DTensor's own
    ``full_tensor`` without its sequential-gather warning and with bool
    on gloo)."""
    return _gather(x.to_local(), x.device_mesh, x.placements)


def place_model(model, cfg: ModelConfig, mesh, rules: Rules):
    """Put a model's parameters on ``mesh`` by ``rules`` (the reference's
    ``device_put(params, shardings_for(specs, mesh, rules, params))``).

    Returns a model of this rank's blocks (``place`` of each parameter) as
    plain tensors, which the layers compute on.  Every leaf of
    ``lm.named_param_specs`` places, each block the :class:`Sharding`'s
    block of the reference's layout: under the default ``serve_rules`` the
    embedding and unembedding over the vocabulary, attention heads, MLP and
    expert hidden units, the SSD's packed ``in_proj`` columns and
    ``conv_w`` channels (which do not line up with its heads), its heads'
    ``a_log``/``d_skip``/``dt_bias`` and ``out_proj`` rows, the RG-LRU's
    channels, the encoder's and the cross-attention's heads over 'model';
    experts over 'data' where the rules say so (qwen3-moe-235b-a22b at full
    size); query heads over 'model' above replicated KV heads (one KV head:
    gemma3-1b, recurrentgemma-2b), a rank then reading the KV heads its
    query heads map to.  The layers gather, slice and reduce what their
    blocks need (``layers/attention.py``, ``mlp.py``, ``moe.py``,
    ``ssd.py``, ``rglru.py``).  Any local group (a rank's query heads a KV
    head, :func:`local_group`) runs on ``decode_attention.cu``:
    recurrentgemma-2b's 10 over a 2-wide 'model' axis give 5."""
    from torch import nn

    from repro_torch.models import lm

    named = dict(model.named_parameters())
    shardings = _param_shardings(model, cfg, mesh, rules)
    local = lm.LM(cfg, device=torch.device("meta"))
    for n, p in named.items():
        owner, _, leaf = n.rpartition(".")
        block = place(p.detach(), shardings[n]).to_local()
        setattr(local.get_submodule(owner), leaf, nn.Parameter(block, requires_grad=False))
    return local


def _param_shardings(model, cfg: ModelConfig, mesh, rules: Rules) -> dict:
    """{parameter name: its ``Sharding``} under ``rules``: each leaf of
    ``lm.named_param_specs`` placed as the reference's ``shardings_for``
    does (indivisible dims replicated)."""
    from repro_torch.models import lm

    specs = lm.named_param_specs(cfg)
    return {n: Sharding.of(mesh, divisible_spec(logical_to_spec(specs[n], rules),
                                                tuple(p.shape), mesh))
            for n, p in model.named_parameters()}


def place_train_state(model, cfg: ModelConfig, mesh, rules: Rules):
    """Put a model and a fresh AdamW state on ``mesh`` for training by
    ``rules`` (``train_rules``: FSDP over the data axes x TP over 'model',
    experts over 'model' where it divides them), as the reference's dry run
    places its params and ``opt_state_specs``.

    Returns (model, opt_state): a model of this rank's blocks as float32
    masters that require gradients, its ``placement`` attribute the
    ``Sharding`` of each parameter name (the training forward gathers each
    layer's blocks over the data axes by it); and ``{"m", "v", "step"}``,
    m and v zero blocks placed as the parameters (``opt_state_specs``
    mirrors the parameters' axes), the step a replicated int32 zero.  A
    block may share storage with ``model``'s tensor (a one-wide mesh cuts
    nothing)."""
    from torch import nn

    from repro_torch.models import lm

    shardings = _param_shardings(model, cfg, mesh, rules)
    dev = _mesh_device(mesh)
    local = lm.LM(cfg, device=torch.device("meta"), trainable=True)
    m, v = {}, {}
    for n, p in model.named_parameters():
        owner, _, leaf = n.rpartition(".")
        block = p.detach()[_block(tuple(p.shape), shardings[n])[0]]
        block = block.to(device=dev, dtype=torch.float32).contiguous()
        setattr(local.get_submodule(owner), leaf, nn.Parameter(block, requires_grad=True))
        m[n], v[n] = torch.zeros_like(block), torch.zeros_like(block)
    local.placement = shardings
    return local, {"m": m, "v": v, "step": torch.zeros((), dtype=torch.int32, device=dev)}


def gather_train_state(model, opt_state=None) -> dict:
    """The whole tensors, on every rank, of a model placed by
    :func:`place_train_state` (``{"params": {name: tensor}}``) and of its
    optimizer state if given (``"m"``, ``"v"``, ``"step"``): for the tests
    and for checkpoints."""
    placement = model.placement
    out = {"params": {n: gather(p.detach(), placement[n])
                      for n, p in model.named_parameters()}}
    if opt_state is not None:
        for k in ("m", "v"):
            out[k] = {n: gather(t, placement[n]) for n, t in opt_state[k].items()}
        out["step"] = opt_state["step"].clone()
    return out


def place_batch(batch: dict, mesh, rules: Rules, microbatches: int = 1) -> dict:
    """This rank's rows of a train batch (``{name: (B, ...) tensor}``, the
    whole batch on every rank) under ``rules``, as
    ``launch.steps.make_train_step(mesh=, microbatches=)`` takes them.
    Microbatch ``i`` of the whole batch is rows ``[i*B/M, (i+1)*B/M)``, as
    the unsharded step slices it; each is split over the batch's mesh axes,
    and the rank's blocks of microbatches 0..M-1 follow one another, so
    that slice ``i`` of the rank's rows is its block of microbatch ``i``.
    Raises where the batch's axes do not divide a microbatch's rows."""
    sizes = mesh_sizes(mesh)
    parts = 1
    for a in _names(logical_to_spec(("batch",), rules)[0]):
        parts *= sizes[a]
    out = {}
    for name, t in batch.items():
        rows = t.shape[0]
        if rows % (microbatches * parts):
            raise ValueError(f"{name}: {rows} rows do not split into {microbatches} "
                             f"microbatches over {parts} batch blocks")
        grouped = t.reshape(microbatches, rows // microbatches, *t.shape[1:])
        sh = Sharding.of(mesh, divisible_spec(logical_to_spec((None, "batch"), rules)
                                              + (None,) * (t.ndim - 1), tuple(grouped.shape),
                                              mesh))
        block = place(grouped, sh).to_local()
        out[name] = block.reshape(-1, *t.shape[1:])
    return out


def local_group(cfg: ModelConfig, mesh, rules: Rules) -> int:
    """Query heads a KV head on each rank (the group the decode-attention
    kernel runs at) under ``rules`` on ``mesh`` (a ``DeviceMesh`` or a
    :class:`MeshShape`: every rank's group is the first's)."""
    from repro_torch.distributed.constraints import axis_rules
    from repro_torch.layers.attention import rank_kv_heads

    with axis_rules(mesh, rules):
        q_parts, kv_parts, sel = rank_kv_heads(cfg, q_index=0)
    return (cfg.n_heads // q_parts) // (cfg.n_kv_heads // kv_parts if sel is None else sel[1])
