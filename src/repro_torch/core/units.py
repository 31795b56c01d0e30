"""SqrtUnit registry: every sqrt/rsqrt consumer takes a ``sqrt_unit`` name and
resolves it here (torch port of ``repro.core.units``: "exact", "e2afs" and
the baselines "esas", "cwaha4", "cwaha8")::

    unit = get_unit("e2afs")
    y = unit.sqrt(x)                       # plain bit-level datapath
    z = get_unit("e2afs", kernel=True).rsqrt(x)   # the e2afs_sqrt kernel

The kernel route goes through the dispatch layer: the CUDA kernel for a
CUDA tensor, the plain version for a CPU tensor.  The baselines are
sqrt-only designs: their ``rsqrt`` is ``1 / sqrt``, as in the reference.

The approximate units carry a gradient taken at the approximate value
(``kernels.dispatch.make_differentiable_*``), on their plain datapaths and
on the kernel route alike, as the reference's ``custom_jvp`` rules do; the
kernel route's backward is plain elementwise torch and launches no kernel.
"exact" uses torch's own autograd.

Fault injection: ``get_unit(name, faults=cfg)`` returns a unit whose
sqrt/rsqrt strike seeded bit flips (:mod:`repro_torch.core.faults`), on the
reference's routes: e2afs in its datapath's output fields before compose
(the raw datapath, no gradient: injection is for inference), the kernel
route and every other unit at the output register (``flip_float_bits``);
a composed rsqrt under faults is ``1 / sqrt`` of the faulted sqrt.
:func:`resolve_ladder` resolves an approximate -> exact ladder, faults on
rung 0 only.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import torch

from repro_torch.core import cwaha, e2afs, esas, exact
from repro_torch.core.faults import FaultConfig, flip_float_bits
from repro_torch.kernels.dispatch import make_differentiable_rsqrt, make_differentiable_sqrt

__all__ = ["SqrtUnit", "available_units", "get_unit", "resolve_ladder"]


def _kernel_sqrt(x, **kw):
    from repro_torch.kernels.e2afs_sqrt import ops  # lazy: kernels import core

    return ops.sqrt(x, **kw)


def _kernel_rsqrt(x, **kw):
    from repro_torch.kernels.e2afs_sqrt import ops

    return ops.rsqrt(x, **kw)


class _Reciprocal(torch.autograd.Function):
    """``1 / y`` of the composed rsqrt, with the derivative the reference
    takes of ``1.0 / y``: ``-(t * (1 / (y * y)))``, rounded in its order."""

    @staticmethod
    def forward(ctx, y):
        ctx.save_for_backward(y)
        return 1.0 / y

    @staticmethod
    def backward(ctx, t):
        (y,) = ctx.saved_tensors
        return -(t * (y.new_full((), 1.0) / (y * y)))


@dataclasses.dataclass(frozen=True)
class SqrtUnit:
    name: str
    _sqrt: Callable
    _rsqrt: Optional[Callable] = None  # native rsqrt datapath if available
    description: str = ""
    _kernel_sqrt: Optional[Callable] = None
    _kernel_rsqrt: Optional[Callable] = None
    kernel_default: bool = False  # route through the kernel unless overridden
    faults: Optional[FaultConfig] = None  # seeded datapath fault schedule
    _fault_sqrt: Optional[Callable] = None  # raw datapath with a faults= hook
    _fault_rsqrt: Optional[Callable] = None

    def _use_kernel(self, kernel: Optional[bool]) -> bool:
        use = self.kernel_default if kernel is None else kernel
        if use and self._kernel_sqrt is None:
            raise ValueError(f"unit {self.name!r} has no kernel route")
        return use

    def _fault_active(self) -> bool:
        return self.faults is not None and self.faults.targets_sqrt and self.faults.rate > 0.0

    def sqrt(self, x: torch.Tensor, *, kernel: Optional[bool] = None, **kw) -> torch.Tensor:
        if self._use_kernel(kernel):
            y = self._kernel_sqrt(x, **kw)
            return flip_float_bits(y, self.faults) if self._fault_active() else y
        if self._fault_active():
            if self._fault_sqrt is not None:
                return self._fault_sqrt(x, faults=self.faults, **kw)
            return flip_float_bits(self._sqrt(x, **kw), self.faults)
        return self._sqrt(x, **kw)

    def rsqrt(self, x: torch.Tensor, *, kernel: Optional[bool] = None, **kw) -> torch.Tensor:
        if self._use_kernel(kernel):
            y = self._kernel_rsqrt(x, **kw)
            return flip_float_bits(y, self.faults) if self._fault_active() else y
        if self._fault_active():
            if self._fault_rsqrt is not None:
                return self._fault_rsqrt(x, faults=self.faults, **kw)
            # composed rsqrt: the sqrt stage is faulted, then the exact reciprocal
            return 1.0 / self.sqrt(x, kernel=kernel, **kw)
        if self._rsqrt is None:
            return _Reciprocal.apply(self._sqrt(x, **kw))
        return self._rsqrt(x, **kw)

    @property
    def is_exact(self) -> bool:
        return self.name == "exact"


_REGISTRY = {
    "exact": SqrtUnit("exact", exact.exact_sqrt, exact.exact_rsqrt, "IEEE sqrt (reference)"),
    "e2afs": SqrtUnit(
        "e2afs",
        make_differentiable_sqrt(e2afs.e2afs_sqrt),
        make_differentiable_rsqrt(e2afs.e2afs_rsqrt),
        "paper's dual-level shift-add datapath",
        _kernel_sqrt=_kernel_sqrt,
        _kernel_rsqrt=_kernel_rsqrt,
        _fault_sqrt=e2afs.e2afs_sqrt,
        _fault_rsqrt=e2afs.e2afs_rsqrt,
    ),
    "esas": SqrtUnit("esas", make_differentiable_sqrt(esas.esas_sqrt), None,
                     "reconstructed ESAS (level-1 series)"),
    "cwaha4": SqrtUnit("cwaha4", make_differentiable_sqrt(partial(cwaha.cwaha_sqrt, k=4)), None,
                       "reconstructed CWAHA, 4 clusters"),
    "cwaha8": SqrtUnit("cwaha8", make_differentiable_sqrt(partial(cwaha.cwaha_sqrt, k=8)), None,
                       "reconstructed CWAHA, 8 clusters"),
}


def get_unit(name: str, *, kernel: bool = False,
             faults: Optional[FaultConfig] = None) -> SqrtUnit:
    try:
        unit = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown sqrt unit {name!r}; available: {sorted(_REGISTRY)}") from None
    if kernel:
        unit._use_kernel(True)  # validate the route exists
        unit = dataclasses.replace(unit, kernel_default=True)
    if faults is not None and faults.targets_sqrt:
        unit = dataclasses.replace(unit, faults=faults)
    return unit


def available_units():
    return tuple(_REGISTRY)


def resolve_ladder(names, *, faults: Optional[FaultConfig] = None):
    """Resolve an accuracy-SLO demotion ladder (approximate -> exact) into
    units: rung 0 is the serving datapath and the only rung that sees
    ``faults``, so demotion moves a row off the faulty datapath; the last
    rung must be "exact"."""
    names = tuple(names)
    if len(names) < 2:
        raise ValueError(f"ladder needs >= 2 rungs (approx -> exact), got {names!r}")
    if names[-1] != "exact":
        raise ValueError(f"ladder must end at 'exact', got {names!r}")
    return tuple(get_unit(n, faults=faults if i == 0 else None) for i, n in enumerate(names))
