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
    "partial_sum",
    "shard_of",
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


@contextlib.contextmanager
def axis_rules(mesh, rules: Rules):
    prev = getattr(_state, "ctx", None)
    _state.ctx = (mesh, rules)
    try:
        yield
    finally:
        _state.ctx = prev


def maybe_axis_rules(mesh, rules: Optional[Rules]):
    """``axis_rules(mesh, rules)`` when a mesh is given, else a no-op
    context: the mesh-optional entry points (``lm.prefill(..., mesh=)``,
    the Engine's mesh mode) wrap their bodies in it, so one model code
    serves one device and a mesh."""
    if mesh is None:
        return contextlib.nullcontext()
    if rules is None:
        raise ValueError("maybe_axis_rules: a mesh needs a rule table (rules=None)")
    return axis_rules(mesh, rules)


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
