"""Logical-axis sharding context (torch port of
``repro.distributed.constraints``).

Layers annotate tensors with *logical* axes (``constrain(x, ("batch",
"seq", "embed"))``).  Inside a ``with axis_rules(mesh, rules):`` scope the
rule table maps them onto the mesh; outside any scope they are no-ops, so
the model code is the same for one device and for a mesh.

The reference is one program over every device, and GSPMD moves data where
a constraint asks for it.  The port runs one process a rank, each on its
own block of every tensor: plain tensors, which is all the kernels and the
plain versions ever see.  A rank's blocks are laid out by the weights that
made them, so a constraint on a plain tensor has nothing to move and
returns it.  What does move is a result a rank holds only part of: a
product whose contraction a mesh axis shards (the attention's and the
MLP's output projections over sharded heads or hidden units, the
vocab-sharded embedding) is one addend a rank, and a vocab-sharded logit
row is one block a rank.  :func:`shard_of` wraps such a local tensor as a
``DTensor`` over the mesh axes concerned, and :func:`constrain`
redistributes it onto the placements its logical axes give (the
all-gather of the serving logits) and returns the rank's local tensor.

The collectives that training differentiates are :class:`_Comm`: a
forward collective and the backward that is its conjugate at that site,
named there, not DTensor's (which takes the gradient at a replicated
placement to be the same on every rank; ROADMAP C.43).
:func:`reduce_sum` sums every rank's addend and passes the gradient
through (the rank's partial sums of a TP block, after which every rank
computes the same thing: Megatron's "g"); :func:`tp_entry` is the identity
whose backward sums the gradient over the axes that split what follows
("f"); :func:`gather_dim` all-gathers a block and reduce-scatters the
gradient; :func:`reduce_scatter_dim` reduce-scatters and all-gathers the
gradient.  :func:`tp_in` and :func:`tp_out` are a block's entry and exit
("f" and "g", or under sequence parallelism the gather of the sequence
and its reduce-scatter); :func:`fsdp_param` and :func:`gathered` give a
layer its weights gathered over the data-parallel axes, their gradients
reduce-scattered; :func:`stream_param` sums the gradient of a parameter
used on the rank's block of a sequence-parallel stream over the sequence
axes; :func:`over_shards` reduces a value of a placed tensor's block over
the axes that shard it (the optimizer's clip norm and int8 scale).  Each
skips its collective where every mesh axis it names is one wide, so a
one-device mesh runs the unsharded ops.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

__all__ = [
    "Rules",
    "axis_rules",
    "maybe_axis_rules",
    "constrain",
    "logical_to_spec",
    "current_rules",
    "mesh_axes",
    "block_index",
    "mesh_parts",
    "shard_of",
    "gather_dim",
    "reduce_scatter_dim",
    "reduce_sum",
    "reduce_max",
    "tp_entry",
    "data_axes",
    "seq_axes",
    "whole_sequence",
    "tp_in",
    "tp_out",
    "fsdp_param",
    "stream_param",
    "gathered",
    "shard_axes",
    "over_shards",
    "block_origin",
    "fault_block",
]

_state = threading.local()

Rules = Dict[str, Union[None, str, Tuple[str, ...]]]

# a spec: one entry a tensor dim, None (replicated), a mesh axis, or a tuple
# of mesh axes in mesh order (the reference's PartitionSpec)
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


def current_rules():
    """The ``(mesh, rules)`` of the innermost :func:`axis_rules` scope, or
    None."""
    return getattr(_state, "ctx", None)


def current_extents() -> dict:
    """The global sizes of logical axes the innermost scope declared (see
    :func:`axis_rules`); {} outside a scope."""
    return getattr(_state, "extents", None) or {}


@contextlib.contextmanager
def axis_rules(mesh, rules: Rules, extents: Optional[Dict[str, int]] = None):
    """The scope of ``(mesh, rules)``.  ``extents`` ({logical axis: global
    size}) declares the whole extent of an axis whose blocks the scope's
    tensors are, where the local size does not tell it: the engine's pool
    rows (``{"batch": num_slots}``, replicated when the mesh does not divide
    them), or an admission's rows, which are the rank's own (``{"batch":
    k}``).  :func:`block_origin` reads them."""
    prev = getattr(_state, "ctx", None), getattr(_state, "extents", None)
    _state.ctx, _state.extents = (mesh, rules), dict(extents or {})
    try:
        yield
    finally:
        _state.ctx, _state.extents = prev


def maybe_axis_rules(mesh, rules: Optional[Rules], extents: Optional[Dict[str, int]] = None):
    """``axis_rules(mesh, rules, extents)`` when a mesh is given, else a
    no-op context: the mesh-optional entry points (``lm.prefill(...,
    mesh=)``, the Engine's mesh mode) wrap their bodies in it, so one model
    code serves one device and a mesh."""
    if mesh is None:
        return contextlib.nullcontext()
    if rules is None:
        raise ValueError("maybe_axis_rules: a mesh needs a rule table (rules=None)")
    return axis_rules(mesh, rules, extents)


def logical_to_spec(axes: Sequence[Optional[str]], rules: Rules) -> Spec:
    """Map logical axis names to a spec through the rule table.

    A physical mesh axis may be claimed only once per spec; a later logical
    axis that maps to an axis already used falls back to replication (the
    standard logical-axis-rules semantics)."""
    used = set()
    parts = []
    for ax in axes:
        phys = rules.get(ax) if ax is not None else None
        if phys is None:
            parts.append(None)
            continue
        phys_t = (phys,) if isinstance(phys, str) else tuple(phys)
        free = tuple(a for a in phys_t if a not in used)
        if not free:
            parts.append(None)
            continue
        used.update(free)
        parts.append(free if len(free) > 1 else free[0])
    return tuple(parts)


def _names(part) -> tuple:
    return () if part is None else (part,) if isinstance(part, str) else tuple(part)


def mesh_axes(axes: Sequence[Optional[str]], shape, dim: int) -> tuple:
    """The mesh axes wider than one that shard dim ``dim`` of a tensor of
    logical ``axes`` and global ``shape`` in the current scope, in mesh
    order; () outside a scope.  A layer asks this of its weight to learn
    whether its product is a partial sum or a block."""
    ctx = current_rules()
    if ctx is None:
        return ()
    mesh, rules = ctx
    from repro_torch.distributed.sharding import divisible_spec, mesh_sizes

    sizes = mesh_sizes(mesh)
    part = divisible_spec(logical_to_spec(axes, rules), tuple(shape), mesh)[dim]
    return tuple(a for a in _names(part) if sizes[a] > 1)


def block_index(axes: Sequence[str]) -> int:
    """This rank's block along the mesh axes ``axes`` of the current scope's
    mesh, the first axis major (the order of DTensor's ``Shard`` over
    several mesh dims, and of the reference's ``P(("data", "model"))``)."""
    mesh, _ = current_rules()
    names, coord = tuple(mesh.mesh_dim_names), mesh.get_coordinate()
    idx = 0
    for a in axes:
        i = names.index(a)
        idx = idx * mesh.size(i) + coord[i]
    return idx


def mesh_parts(axes: Sequence[str], mesh=None) -> int:
    """The blocks the mesh axes ``axes`` cut a dim into (1 for none), on
    ``mesh`` (default: the current scope's)."""
    if not axes:
        return 1
    from repro_torch.distributed.sharding import mesh_sizes

    sizes = mesh_sizes(current_rules()[0] if mesh is None else mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def block_origin(axes: Sequence[Optional[str]], shape,
                 extents: Optional[Dict[str, int]] = None) -> Tuple[tuple, tuple]:
    """(origin, global shape) of this rank's block, of local ``shape``, of a
    tensor of logical ``axes`` in the current scope: the global coordinates
    of the block's first element and the whole tensor's shape, which a fault
    site hashes an element's global flat index from.

    A dim's global size is ``extents[axis]`` (the caller's, e.g.
    ``{"heads": cfg.n_heads}``), else the scope's declared extent, else the
    local size times the mesh axes the rules give it (a block placed by the
    rules); the rules then place it as ``divisible_spec`` does, and the
    block's origin is its index over those mesh axes (the first major) times
    the local size.  Outside a scope: (zeros, ``shape``), the identity."""
    shape = tuple(int(n) for n in shape)
    ctx = current_rules()
    if ctx is None:
        return (0,) * len(shape), shape
    mesh, rules = ctx
    from repro_torch.distributed.sharding import divisible_spec

    known = {**current_extents(), **(extents or {})}
    spec = logical_to_spec(axes, rules)
    glob = [int(known[ax]) if ax in known else n * mesh_parts(_names(spec[d]), mesh)
            for d, (ax, n) in enumerate(zip(axes, shape))]
    part = divisible_spec(spec, tuple(glob), mesh)
    origin = []
    for d, n in enumerate(shape):
        names = _names(part[d])
        parts = mesh_parts(names, mesh)
        if glob[d] == n:  # the whole dim on every rank
            origin.append(0)
            continue
        if glob[d] != n * parts:
            raise ValueError(f"a block of {n} is not 1/{parts} of the global {glob[d]} along "
                             f"logical axis {axes[d]!r} (spec {part})")
        origin.append(block_index(names) * n if names else 0)
    return tuple(origin), tuple(glob)


def fault_block(axes: Sequence[Optional[str]], shape, extents: Optional[Dict[str, int]] = None):
    """The context a fault site opens around its unit call on this rank's
    block (local ``shape``, logical ``axes``): ``core.faults.block`` at the
    :func:`block_origin`, so the strike hash reads each element's index in
    the whole tensor.  Outside a scope a no-op."""
    if current_rules() is None:
        return contextlib.nullcontext()
    from repro_torch.core import faults

    return faults.block(*block_origin(axes, shape, extents))


def _submesh(axes):
    mesh, _ = current_rules()
    return mesh[axes[0]] if len(axes) == 1 else mesh[tuple(axes)]


def shard_of(x: torch.Tensor, axes: Sequence[str], dim: int):
    """``x`` as this rank's block of dim ``dim``, sharded over the mesh axes
    ``axes`` (first major), for :func:`constrain` to gather; ``x`` itself
    when ``axes`` is empty."""
    if not axes:
        return x
    from torch.distributed.tensor import DTensor, Shard

    return DTensor.from_local(x, _submesh(axes), [Shard(dim % x.ndim)] * len(axes),
                              run_check=False)


def _groups(axes: Sequence[str]) -> list:
    """The process groups of the current scope's mesh axes ``axes``, in
    the order given."""
    mesh, _ = current_rules()
    return [mesh.get_group(a) for a in axes]


def _wait(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed._functional_collectives import AsyncCollectiveTensor

    return t.wait() if isinstance(t, AsyncCollectiveTensor) else t


def _collective(op: str, x: torch.Tensor, groups: list, dim: int) -> torch.Tensor:
    """One collective over ``groups`` (mesh axes, the first major):
    "gather" (all-gather along ``dim``: the last axis first, so the blocks
    land in their major-first order), "scatter" (reduce-scatter with SUM
    along ``dim``, the first axis first: the conjugate of "gather"), "sum"
    (all-reduce with SUM, one an axis), "max" (all-reduce with MAX) or
    "slice" (the rank's block along ``dim``, no communication).  A gather or
    a scatter runs on dim 0 of ``x`` with ``dim`` moved there."""
    from torch.distributed import _functional_collectives as funcol

    if not groups:
        return x
    if op == "slice":  # this rank's block (first major), no communication
        dim %= x.ndim
        idx, parts = 0, 1
        for g in groups:
            n = g.size()
            idx, parts = idx * n + g.rank(), parts * n
        if x.shape[dim] % parts:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split into {parts} blocks")
        step = x.shape[dim] // parts
        return x.narrow(dim, idx * step, step).contiguous()
    if op in ("gather", "scatter"):
        dim %= x.ndim
        x = x.movedim(dim, 0).contiguous()
        if op == "gather":
            gather = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor
            for g in reversed(groups):
                x = _wait(gather(x, 0, g))
        else:
            scatter = (getattr(funcol, "reduce_scatter_single", None)
                       or funcol.reduce_scatter_tensor)
            for g in groups:
                x = _wait(scatter(x, "sum", 0, g))
        return x.movedim(0, dim).contiguous()
    x = x.contiguous()
    for g in groups:
        x = _wait(funcol.all_reduce(x, op, g))
    return x


class _Comm(torch.autograd.Function):
    """A forward collective with the backward collective that is its
    transpose where it matters: ``fwd`` and ``bwd`` are lists of (op,
    groups) run in order (:func:`_collective`), along ``dim``."""

    @staticmethod
    def forward(ctx, x, fwd, bwd, dim):
        ctx.bwd, ctx.dim = bwd, dim
        if not fwd:
            return x.view_as(x)
        for op, groups in fwd:
            x = _collective(op, x, groups, dim)
        return x

    @staticmethod
    def backward(ctx, g):
        for op, groups in ctx.bwd:
            g = _collective(op, g, groups, ctx.dim)
        return g, None, None, None


def _comm(x: torch.Tensor, fwd, bwd, dim: int = 0) -> torch.Tensor:
    fwd = [(op, gs) for op, gs in fwd if gs]
    bwd = [(op, gs) for op, gs in bwd if gs]
    if not fwd and not (bwd and x.requires_grad):
        return x
    return _Comm.apply(x, fwd, bwd, dim)


def gather_dim(x: torch.Tensor, axes: Sequence[str], dim: int) -> torch.Tensor:
    """The whole of dim ``dim`` from this rank's block ``x`` of it, sharded
    over the mesh axes ``axes`` (first major): an all-gather; ``x`` itself
    when ``axes`` is empty.  Each rank then computes something of its own
    with the whole (its heads of the SSD's gathered projection, its experts
    of the gathered rows), so the backward sums every rank's gradient of
    the whole and keeps the rank's block: a reduce-scatter (DTensor's
    backward takes the block of this rank's gradient alone, right only
    where every rank computes the same thing after the gather)."""
    if not axes:
        return x
    groups = _groups(axes)
    return _comm(x, [("gather", groups)], [("scatter", groups)], dim)


def reduce_scatter_dim(x: torch.Tensor, axes: Sequence[str], dim: int) -> torch.Tensor:
    """This rank's block of dim ``dim`` (over the mesh axes ``axes``, first
    major) of the sum of every rank's addend ``x``: a reduce-scatter, whose
    backward all-gathers the blocks' gradients (every rank's addend reached
    every block); ``x`` itself when ``axes`` is empty."""
    if not axes:
        return x
    groups = _groups(axes)
    return _comm(x, [("scatter", groups)], [("gather", groups)], dim)


def reduce_sum(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """The sum over the mesh axes ``axes`` of every rank's addend ``x``, on
    every rank (an all-reduce, one a mesh axis); ``x`` itself when ``axes``
    is empty.  Every rank then computes the same thing with the sum (the
    residual stream after a tensor-parallel block, a loss), so each gets the
    whole gradient already: the backward is the identity (Megatron's "g")."""
    return _comm(x, [("sum", _groups(axes) if axes else [])], [])


def tp_entry(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """``x``, replicated over the mesh axes ``axes``, where it enters a
    computation those axes split (a rank's heads, hidden units, experts or
    vocabulary block): the identity, whose backward sums the ranks' partial
    gradients over ``axes`` (Megatron's "f").  ``x`` itself when ``axes``
    is empty or nothing asks for its gradient."""
    if not axes:
        return x
    return _comm(x, [], [("sum", _groups(axes))])


@torch.no_grad()
def reduce_max(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """The elementwise max over the mesh axes ``axes`` (no gradient: a
    logsumexp's shift)."""
    return _collective("max", x, _groups(axes), 0) if axes else x


def _wide_axes(logical: str) -> tuple:
    """The mesh axes wider than one that the current scope's rules give the
    logical axis ``logical``; () outside a scope."""
    ctx = current_rules()
    if ctx is None:
        return ()
    mesh, rules = ctx
    from repro_torch.distributed.sharding import mesh_sizes

    sizes = mesh_sizes(mesh)
    return tuple(a for a in _names(logical_to_spec((logical,), rules)[0]) if sizes[a] > 1)


def data_axes() -> tuple:
    """The mesh axes wider than one that shard the batch in the current
    scope (the data-parallel axes; () outside a scope)."""
    return _wide_axes("batch")


def seq_axes() -> tuple:
    """The mesh axes wider than one that shard the residual stream's
    sequence in the current scope (sequence parallelism:
    ``train_rules(seq_parallel=True)`` puts 'seq' over 'model'); () outside
    a scope and without it."""
    return _wide_axes("seq")


@contextlib.contextmanager
def whole_sequence():
    """The current scope with the sequence unsharded (a block of its own
    that sequence parallelism does not reach: the encoder over its
    frames).  A no-op without sequence parallelism."""
    if not seq_axes():
        yield
        return
    mesh, rules = current_rules()
    with axis_rules(mesh, {**rules, "seq": None}, current_extents()):
        yield


def tp_in(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """``x``, the residual stream's (b, s, d) after a norm, where it enters
    a block that the mesh axes ``axes`` split (its heads, hidden units or
    channels; () for a block computed whole on every rank).  Without
    sequence parallelism :func:`tp_entry`.  Under it the rank holds a block
    of the sequence: the block enters a split computation all-gathered over
    the sequence axes, its backward reduce-scattering the ranks' partial
    gradients (Megatron-SP's "g"); a whole computation takes the gathered
    sequence and gives the rank back its block's gradient, a slice."""
    sp = seq_axes()
    if not sp:
        return tp_entry(x, axes)
    groups = _groups(sp)
    if tuple(axes) == sp:
        return _comm(x, [("gather", groups)], [("scatter", groups)], 1)
    if axes:
        raise NotImplementedError(f"a block split over {tuple(axes)} in a sequence over {sp}")
    return _comm(x, [("gather", groups)], [("slice", groups)], 1)


def tp_out(y: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """The output of a block entered through :func:`tp_in`: without
    sequence parallelism the ranks' partial sums over ``axes`` all-reduced
    (:func:`reduce_sum`); under it, reduce-scattered over the sequence into
    the rank's block (the backward all-gathers), or, for a block computed
    whole, the rank's block of the sequence sliced (the backward
    all-gathers the blocks' gradients)."""
    sp = seq_axes()
    if not sp:
        return reduce_sum(y, axes)
    groups = _groups(sp)
    if tuple(axes) == sp:
        return _comm(y, [("scatter", groups)], [("gather", groups)], 1)
    if axes:
        raise NotImplementedError(f"a block split over {tuple(axes)} in a sequence over {sp}")
    return _comm(y, [("slice", groups)], [("gather", groups)], 1)


def fsdp_param(p: torch.Tensor, spec) -> torch.Tensor:
    """The block of parameter ``p`` (this rank's block under ``spec``, a
    placed spec) that the layers compute on: whole over the data-parallel
    axes (:func:`data_axes`), still blocked over the others.  The forward
    all-gathers the dim the data axes shard; the backward reduce-scatters
    its gradient (each rank's is the addend of its rows) and sums the
    gradient of a parameter no data axis shards (a bias, a norm's scale, a
    conv) over the data axes.  ``p`` itself outside a scope and where no
    data axis is wider than one."""
    data = data_axes()
    if not data:
        return p
    dim, axes = 0, ()
    for d, part in enumerate(spec):
        names = _names(part)
        mine = tuple(a for a in names if a in data)
        if mine:
            if names[:len(mine)] != mine:
                raise NotImplementedError(f"spec {spec}: dim {d} is sharded over {names}, "
                                          f"the data axes {mine} not major")
            dim, axes = d, mine
            break
    rest = [a for a in data if a not in axes]
    gathered = _groups(axes) if axes else []
    return _comm(p, [("gather", gathered)],
                 [("scatter", gathered), ("sum", _groups(rest) if rest else [])], dim)


def stream_param(p: torch.Tensor) -> torch.Tensor:
    """``p``, a parameter applied to the residual stream (a norm's scale or
    bias, the MLP's output bias), where its user calls it: under sequence
    parallelism the stream is the rank's block of the sequence, so the
    gradient is summed over the sequence axes (:func:`tp_entry` over
    :func:`seq_axes`).  ``p`` itself without sequence parallelism and in a
    :func:`whole_sequence` block."""
    return tp_entry(p, seq_axes())


@contextlib.contextmanager
def gathered(module: torch.nn.Module, placement: Optional[dict], prefix: str = "",
             recurse: bool = True):
    """Within the block, each parameter of ``module`` (its own only, unless
    ``recurse``) reads as :func:`fsdp_param` of it: ``placement`` maps a
    parameter's name (``prefix`` + its name in ``module``) to its
    ``Sharding``.  The swap is undone on exit; run inside a checkpointed
    function, the recompute gathers again.  A no-op without a placement or
    a data axis wider than one."""
    if not placement or not data_axes():
        yield
        return
    swapped = []
    try:
        for name, p in list(module.named_parameters(recurse=recurse)):
            owner, _, leaf = name.rpartition(".")
            sub = module.get_submodule(owner) if owner else module
            swapped.append((sub, leaf, p))
            sub._parameters[leaf] = fsdp_param(p, placement[prefix + name].spec)
        yield
    finally:
        for sub, leaf, p in swapped:
            sub._parameters[leaf] = p


def shard_axes(sh) -> tuple:
    """The mesh axes wider than one that shard a tensor placed by ``sh``
    (a ``distributed.sharding.Sharding``), in mesh order; () for a
    replicated tensor or None.  Needs no scope: the axes are ``sh``'s."""
    if sh is None:
        return ()
    used = {a for part in sh.spec for a in _names(part)}
    return tuple(a for i, a in enumerate(sh.mesh.mesh_dim_names)
                 if a in used and sh.mesh.size(i) > 1)


def over_shards(op: str, x: torch.Tensor, sh) -> torch.Tensor:
    """``x``, a value computed from this rank's block of a tensor placed by
    ``sh`` (a local sum of squares, a local max), reduced ("sum" or "max",
    an all-reduce) over the mesh axes that shard it and only those
    (:func:`shard_axes`): a replicated copy counts once.  ``x`` itself for
    a tensor no axis wider than one shards."""
    axes = shard_axes(sh)
    return _collective(op, x, [sh.mesh.get_group(a) for a in axes], 0) if axes else x


def constrain(x, axes: Sequence[Optional[str]]):
    """Lay ``x`` out on the spec its logical ``axes`` give in the current
    scope (``divisible_spec`` of ``logical_to_spec``).  Outside a scope, and
    for a plain tensor (a rank's block, already where its producer put it),
    returns ``x``.  A DTensor (:func:`shard_of`) is
    redistributed onto the spec's placements over its own mesh axes, with
    the collective that takes, and its local tensor is returned."""
    ctx = current_rules()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    from repro_torch.distributed.sharding import divisible_spec

    spec = divisible_spec(logical_to_spec(axes, rules), tuple(x.shape), mesh)
    sub = x.device_mesh
    target = []
    for a in sub.mesh_dim_names:
        dims = [d for d, part in enumerate(spec) if a in _names(part)]
        target.append(Shard(dims[0]) if dims else Replicate())
    return x.redistribute(sub, target).to_local()
