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
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import torch

from repro_torch.core import cwaha, e2afs, esas, exact
from repro_torch.kernels.dispatch import make_differentiable_rsqrt, make_differentiable_sqrt

__all__ = ["SqrtUnit", "available_units", "get_unit"]


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

    def _use_kernel(self, kernel: Optional[bool]) -> bool:
        use = self.kernel_default if kernel is None else kernel
        if use and self._kernel_sqrt is None:
            raise ValueError(f"unit {self.name!r} has no kernel route")
        return use

    def sqrt(self, x: torch.Tensor, *, kernel: Optional[bool] = None, **kw) -> torch.Tensor:
        if self._use_kernel(kernel):
            return self._kernel_sqrt(x, **kw)
        return self._sqrt(x, **kw)

    def rsqrt(self, x: torch.Tensor, *, kernel: Optional[bool] = None, **kw) -> torch.Tensor:
        if self._use_kernel(kernel):
            return self._kernel_rsqrt(x, **kw)
        if self._rsqrt is None:
            return _Reciprocal.apply(self._sqrt(x, **kw))
        return self._rsqrt(x, **kw)


_REGISTRY = {
    "exact": SqrtUnit("exact", exact.exact_sqrt, exact.exact_rsqrt, "IEEE sqrt (reference)"),
    "e2afs": SqrtUnit(
        "e2afs",
        make_differentiable_sqrt(e2afs.e2afs_sqrt),
        make_differentiable_rsqrt(e2afs.e2afs_rsqrt),
        "paper's dual-level shift-add datapath",
        _kernel_sqrt=_kernel_sqrt,
        _kernel_rsqrt=_kernel_rsqrt,
    ),
    "esas": SqrtUnit("esas", make_differentiable_sqrt(esas.esas_sqrt), None,
                     "reconstructed ESAS (level-1 series)"),
    "cwaha4": SqrtUnit("cwaha4", make_differentiable_sqrt(partial(cwaha.cwaha_sqrt, k=4)), None,
                       "reconstructed CWAHA, 4 clusters"),
    "cwaha8": SqrtUnit("cwaha8", make_differentiable_sqrt(partial(cwaha.cwaha_sqrt, k=8)), None,
                       "reconstructed CWAHA, 8 clusters"),
}


def get_unit(name: str, *, kernel: bool = False) -> SqrtUnit:
    try:
        unit = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown sqrt unit {name!r}; available: {sorted(_REGISTRY)}") from None
    if kernel:
        unit._use_kernel(True)  # validate the route exists
        unit = dataclasses.replace(unit, kernel_default=True)
    return unit


def available_units():
    return tuple(_REGISTRY)
