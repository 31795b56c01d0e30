"""Cost of the step that really runs (the port's counterpart of
``repro.launch.hlo_cost``): a ``TorchDispatchMode`` that counts every aten op
a step dispatches, on real or fake tensors, into an :class:`OpCost` with
``HloCost``'s fields, plus the kernel launches.

The rules follow ``hlo_cost``'s:

* flops: dot and convolution products only (mm, addmm, bmm, baddbmm and the
  convolutions by ``torch.utils.flop_counter``'s formulas; mv, addmv, dot
  and vdot, which it lacks, at 2 flops a multiply-add);
* bytes: operand bytes plus result bytes of every op;
* free: views and reshapes (an op whose result aliases an operand, and
  ``_unsafe_view``), ops outside the aten namespace (``prim.device``), casts
  and copies (``_to_copy``, ``clone``: the fusions ``hlo_cost`` passes
  through), allocations and factories (``empty*``, ``*_like``, ``arange``,
  ``full``, ``zeros``: its parameters, constants and iotas), and metadata;
* collectives: the result bytes of each c10d or functional collective, by
  kind (all-reduce, all-gather, reduce-scatter, all-to-all), also in bytes;
* a kernel launch (``dispatch.count_launch``) is one op of its operands' and
  results' bytes, as ``hlo_cost`` counts a Pallas custom call; its plain
  version's ops never run in its place (a wrapper launches or computes the
  plain version, never both), and its flops are not dot flops.

A Python loop needs no trip counts: every iteration is dispatched.  Where
``trace=True`` each counted op is also recorded with its place in the
model (the module path of a parameter operand, else the innermost function
of the port that ran it) for ``launch/attribution.py``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
from typing import Dict, Iterator, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import dispatch

__all__ = ["OpCost", "counting", "count"]

_aten = torch.ops.aten

_DOT_OPS = {_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm, _aten.convolution,
            _aten._convolution}
# matrix-vector and vector products (2 x the matrix's or vector's elements)
_VECTOR_DOT_OPS = {_aten.mv, _aten.addmv, _aten.dot, _aten.vdot}
_FREE_OPS = {
    _aten._to_copy, _aten.clone, _aten.lift_fresh, _aten.lift_fresh_copy, _aten.detach,
    _aten.alias, _aten._local_scalar_dense, _aten.empty, _aten.empty_like, _aten.empty_strided,
    _aten.new_empty, _aten.new_empty_strided, _aten.zeros_like, _aten.ones_like,
    _aten.full_like, _aten.arange, _aten.full, _aten.zeros, _aten.ones, _aten.scalar_tensor,
    _aten.new_zeros, _aten.new_ones, _aten.new_full, _aten.sym_size, _aten.sym_stride,
    _aten.sym_numel, _aten.sym_storage_offset, _aten.is_same_size, _aten.resize_,
    _aten._unsafe_view,
}
_COLLECTIVE_KINDS = (("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
                     ("all_gather", "all-gather"), ("allgather", "all-gather"),
                     ("reduce_scatter", "reduce-scatter"), ("all_to_all", "all-to-all"),
                     ("alltoall", "all-to-all"), ("broadcast", "broadcast"))
_COLLECTIVE_FREE = ("wait_tensor", "barrier", "monitored_barrier")


@dataclasses.dataclass
class OpCost:
    """Per-device cost of a step: dot flops, bytes, collective bytes and
    collectives by kind (``HloCost``'s fields), the kernel launches by name,
    and (with ``trace``) one record an op for
    :func:`repro_torch.launch.attribution.attribute`."""

    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collectives: Dict[str, dict] = dataclasses.field(default_factory=dict)
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    records: List[tuple] = dataclasses.field(default_factory=list)  # (place, op, bytes, flops, shape)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _collective_kind(func) -> Optional[str]:
    if func.namespace not in ("_c10d_functional", "c10d", "c10d_functional"):
        return None
    name = func.__name__
    if any(name.startswith(f) for f in _COLLECTIVE_FREE):
        return ""
    for key, kind in _COLLECTIVE_KINDS:
        if key in name:
            return kind
    return ""


def _is_view(func) -> bool:
    """True where the op's first result aliases an operand without writing
    it (a view, a reshape, a transpose)."""
    rets = func._schema.returns
    return bool(rets) and rets[0].alias_info is not None and not rets[0].alias_info.is_write


_HERE = __file__
# frames that are plumbing, not the model: this module, the dispatch layer
# and the dry run (whose indexing shim runs ops on the model's behalf)
_SKIP_FILES = (_HERE, dispatch.__file__, _HERE.replace("op_cost.py", "dryrun.py"))


def _function_place() -> str:
    """The innermost function of the port on the Python stack (outside this
    module and the dispatch layer), as "<file under repro_torch>:<name>"."""
    frame = sys._getframe(2)
    while frame is not None:
        path = frame.f_code.co_filename
        if "repro_torch" in path and path not in _SKIP_FILES:
            return f"{path.rsplit('repro_torch/', 1)[-1]}:{frame.f_code.co_name}"
        frame = frame.f_back
    return "?"


class _CostMode(TorchDispatchMode):
    def __init__(self, cost: OpCost, trace: bool, names: dict):
        super().__init__()
        self.cost, self.trace, self.names = cost, trace, names

    def _place(self, tensors) -> str:
        for t in tensors:
            try:
                owner = self.names.get(t.untyped_storage()._cdata)
            except (RuntimeError, NotImplementedError):
                owner = None
            if owner is not None:
                return f"{owner} {_function_place()}"
        return _function_place()

    def _add(self, op: str, nbytes: float, flops: float, operands, result) -> None:
        c = self.cost
        c.bytes += nbytes
        c.flops += flops
        if self.trace:
            shape = tuple(result.shape) if isinstance(result, torch.Tensor) else ()
            c.records.append((self._place(operands), op, nbytes, flops, shape))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        kind = _collective_kind(func)
        if kind == "":
            return out
        if kind is not None:
            rbytes = _nbytes(out)
            slot = self.cost.collectives.setdefault(kind, {"count": 0, "bytes": 0})
            slot["count"] += 1
            slot["bytes"] += rbytes
            self.cost.collective_bytes += rbytes
            operands = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            self._add(str(packet), rbytes + _nbytes(operands), 0.0, operands, out)
            return out
        if func.namespace != "aten" or packet in _FREE_OPS or _is_view(func):
            return out
        flops = 0.0
        if packet in _DOT_OPS:
            from torch.utils.flop_counter import flop_registry

            flops = float(flop_registry[packet](*args, **kwargs, out_val=out))
        elif packet in _VECTOR_DOT_OPS:  # not in flop_counter: 2 flops a multiply-add
            mat = args[1] if packet is _aten.addmv else args[0]
            flops = 2.0 * mat.numel()
        operands = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        self._add(str(packet), _nbytes(operands) + _nbytes(out), flops, operands, out)
        return out

    def launch(self, name: str, reads, writes) -> None:
        """One kernel launch: an op of its operands' and results' bytes."""
        self.cost.launches[name] = self.cost.launches.get(name, 0) + 1
        first = writes[0] if writes else None
        self._add(f"kernel.{name}", _nbytes(list(reads)) + _nbytes(list(writes)), 0.0,
                  list(reads), first)


@contextlib.contextmanager
def counting(*, trace: bool = False, model: Optional[torch.nn.Module] = None) -> Iterator[OpCost]:
    """Count every op dispatched and every kernel launched inside the block
    into the yielded :class:`OpCost`.  ``trace`` records each op's place;
    ``model``'s parameter names are the places of ops that read them."""
    cost = OpCost()
    names = {}
    if trace and model is not None:
        for name, p in model.named_parameters():
            names[p.untyped_storage()._cdata] = name.rpartition(".")[0] or name
    mode = _CostMode(cost, trace, names)
    with dispatch.observe_launches(mode.launch), mode:
        yield cost


def count(fn, *args, trace: bool = False, model=None, **kw):
    """``fn(*args, **kw)`` counted: (its result, :class:`OpCost`)."""
    with counting(trace=trace, model=model) as cost:
        out = fn(*args, **kw)
    return out, cost
