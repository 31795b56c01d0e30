"""Kernel routing and launch counts (counterpart of ``repro.kernels.dispatch``).

Every kernel wrapper asks :func:`use_kernel` where to go, per call:

* a CPU tensor gets the plain PyTorch version;
* a CUDA tensor gets the hand-written CUDA kernel, unless the caller has
  asked for the plain versions with ``set_backend("reference")``;
* any other device raises.

There is no fallback: a CUDA tensor that the kernel refuses raises.  Each
wrapper calls :func:`count_launch` where it launches its kernel and nowhere
else, so a run can show that its main path went through the kernels.

A CUDA graph launches its kernels at each replay, not where the wrappers
run: :func:`capture_launches` keeps the counts a capture makes out of the
totals (a capture launches nothing), and :func:`replay_launches` adds them
to the totals once a replay.

:func:`make_differentiable_sqrt` and :func:`make_differentiable_rsqrt` give
an approximate unit a gradient (the reference's ``custom_jvp`` factories),
on the plain datapaths and on the e2afs kernel route alike.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional

import torch

__all__ = [
    "BACKENDS",
    "KNOWN",
    "Launches",
    "capture_launches",
    "count_launch",
    "launch_counts",
    "launch_details",
    "make_differentiable_rsqrt",
    "make_differentiable_sqrt",
    "replay_launches",
    "reset_launch_counts",
    "set_backend",
    "use_kernel",
]

BACKENDS = ("auto", "reference")
KNOWN = ("adam", "decode_attention", "e2afs_rsqrt", "e2afs_sqrt", "kmeans_assign", "rmsnorm",
         "sobel")

_backend = "auto"
_launches = dict.fromkeys(KNOWN, 0)
_details: dict = {}
_capturing: Optional["Launches"] = None


def set_backend(name: Optional[str]) -> str:
    """Process-wide route: "auto" (kernels on CUDA, plain versions on CPU) or
    "reference" (plain versions everywhere); None resets to "auto".  Returns
    the previous setting so callers can restore it."""
    global _backend
    name = "auto" if name is None else name
    if name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r}; expected one of {BACKENDS}")
    prev, _backend = _backend, name
    return prev


def use_kernel(*tensors: Optional[torch.Tensor]) -> bool:
    """True when these operands go to the CUDA kernel, False for the plain
    version.  All operands must lie on one device."""
    present = [t for t in tensors if t is not None]
    dev = present[0].device
    for t in present[1:]:
        if t.device != dev:
            raise ValueError(f"kernel operands on different devices: {dev} and {t.device}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel route for device {dev}")
    return _backend != "reference"


class Launches:
    """The launches recorded while a CUDA graph was captured, by kernel and
    by variant: what one replay of that graph launches."""

    def __init__(self):
        self.counts = dict.fromkeys(KNOWN, 0)
        self.details: dict = {}


def _tally(counts: dict, details: dict, name: str, detail: Optional[str]) -> None:
    counts[name] += 1
    if detail is not None:
        key = f"{name} {detail}"
        details[key] = details.get(key, 0) + 1


def count_launch(name: str, detail: Optional[str] = None) -> None:
    """One launch of kernel ``name``; ``detail`` (a variant such as "wrap")
    is also tallied under "<name> <detail>" in :func:`launch_details`.
    Inside :func:`capture_launches` the launch goes to the capture's record
    instead of the totals."""
    if _capturing is not None:
        _tally(_capturing.counts, _capturing.details, name, detail)
    else:
        _tally(_launches, _details, name, detail)


@contextlib.contextmanager
def capture_launches() -> Iterator[Launches]:
    """Record the launches counted inside the block (a CUDA graph's
    capture) in the yielded :class:`Launches`, leaving the totals as they
    were."""
    global _capturing
    if _capturing is not None:
        raise RuntimeError("launches are already being captured")
    _capturing = record = Launches()
    try:
        yield record
    finally:
        _capturing = None


def replay_launches(record: Launches) -> None:
    """Add to the totals what one replay of a captured graph launches."""
    for name, n in record.counts.items():
        _launches[name] += n
    for key, n in record.details.items():
        _details[key] = _details.get(key, 0) + n


def launch_counts() -> dict:
    return dict(_launches)


def launch_details() -> dict:
    """Launches by variant, for the kernels whose wrapper names one."""
    return dict(_details)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0
    _details.clear()


# ---------------------------------------------------------------------------
# Differentiability of the approximate units
# ---------------------------------------------------------------------------


def _over(num: float, y: torch.Tensor) -> torch.Tensor:
    """``num / y`` as one correctly rounded division (``float / tensor`` in
    torch is a reciprocal times ``num``, two roundings)."""
    return y.new_full((), num) / y


def make_differentiable_sqrt(fn: Callable) -> Callable:
    """Wrap an approximate sqrt so gradients flow: d/dx sqrt(x) = 1 / (2 sqrt(x)),
    taken at the *approximate* forward value y, as ``t * (0.5 / y)``
    (straight-through on the approximation error; the reference's rounding
    order, so the gradients are bit-identical to it)."""

    class _Sqrt(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            y = fn(x)
            ctx.save_for_backward(y)
            return y

        @staticmethod
        def backward(ctx, t):
            (y,) = ctx.saved_tensors
            return t * _over(0.5, y)

    return _apply_if_needed(_Sqrt, fn)


def make_differentiable_rsqrt(fn: Callable) -> Callable:
    """Wrap an approximate rsqrt: d/dx x^(-1/2) = -y / (2x) at the approximate
    forward value y, as ``t * (-0.5 * y / x)``."""

    class _Rsqrt(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            y = fn(x)
            ctx.save_for_backward(x, y)
            return y

        @staticmethod
        def backward(ctx, t):
            x, y = ctx.saved_tensors
            return t * (-0.5 * y / x)

    return _apply_if_needed(_Rsqrt, fn)


def _apply_if_needed(function: type, fn: Callable) -> Callable:
    """``function.apply`` where x needs a gradient; plain ``fn`` otherwise,
    with no autograd state."""

    def call(x: torch.Tensor) -> torch.Tensor:
        if x.requires_grad and torch.is_grad_enabled():
            return function.apply(x)
        return fn(x)

    return call
