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
row is one block a rank.  :func:`partial_sum` and :func:`shard_of` wrap
such a local tensor as a ``DTensor`` over the mesh axes concerned, and
:func:`constrain` redistributes it onto the placements its logical axes
give (the all-reduce or the all-gather) and returns the rank's local
tensor.
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
    "partial_sum",
    "shard_of",
    "gather_dim",
    "reduce_sum",
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


def partial_sum(x: torch.Tensor, axes: Sequence[str]):
    """``x`` as this rank's addend of a sum over the mesh axes ``axes`` (a
    ``Partial`` DTensor over them), for :func:`constrain` to reduce; ``x``
    itself when ``axes`` is empty."""
    if not axes:
        return x
    from torch.distributed.tensor import DTensor, Partial

    return DTensor.from_local(x, _submesh(axes), [Partial()] * len(axes), run_check=False)


def shard_of(x: torch.Tensor, axes: Sequence[str], dim: int):
    """``x`` as this rank's block of dim ``dim``, sharded over the mesh axes
    ``axes`` (first major), for :func:`constrain` to gather; ``x`` itself
    when ``axes`` is empty."""
    if not axes:
        return x
    from torch.distributed.tensor import DTensor, Shard

    return DTensor.from_local(x, _submesh(axes), [Shard(dim % x.ndim)] * len(axes),
                              run_check=False)


def gather_dim(x: torch.Tensor, axes: Sequence[str], dim: int) -> torch.Tensor:
    """The whole of dim ``dim`` from this rank's block ``x`` of it, sharded
    over the mesh axes ``axes`` (first major): an all-gather; ``x`` itself
    when ``axes`` is empty."""
    if not axes:
        return x
    from torch.distributed.tensor import Replicate

    sub = _submesh(axes)
    return shard_of(x.contiguous(), axes, dim).redistribute(
        sub, [Replicate()] * len(axes)).to_local()


def reduce_sum(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """The sum over the mesh axes ``axes`` of every rank's addend ``x``, on
    every rank (an all-reduce); ``x`` itself when ``axes`` is empty."""
    from torch.distributed.tensor import Replicate

    for a in axes:  # one all-reduce a mesh axis
        x = partial_sum(x.contiguous(), (a,)).redistribute(_submesh((a,)), [Replicate()]).to_local()
    return x


def constrain(x, axes: Sequence[Optional[str]]):
    """Lay ``x`` out on the spec its logical ``axes`` give in the current
    scope (``divisible_spec`` of ``logical_to_spec``).  Outside a scope, and
    for a plain tensor (a rank's block, already where its producer put it),
    returns ``x``.  A DTensor (:func:`partial_sum`, :func:`shard_of`) is
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
