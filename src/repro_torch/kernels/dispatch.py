"""Kernel routing and launch counts (counterpart of ``repro.kernels.dispatch``).

Every kernel wrapper asks :func:`use_kernel` where to go, per call:

* a CPU tensor gets the plain PyTorch version;
* a CUDA tensor gets the hand-written CUDA kernel, unless the caller has
  asked for the plain versions with ``set_backend("reference")``;
* any other device raises.

There is no fallback: a CUDA tensor that the kernel refuses raises.  Each
wrapper calls :func:`count_launch` where it launches its kernel and nowhere
else, so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = [
    "BACKENDS",
    "KNOWN",
    "count_launch",
    "launch_counts",
    "reset_launch_counts",
    "set_backend",
    "use_kernel",
]

BACKENDS = ("auto", "reference")
KNOWN = ("decode_attention", "e2afs_rsqrt", "e2afs_sqrt", "kmeans_assign", "rmsnorm", "sobel")

_backend = "auto"
_launches = dict.fromkeys(KNOWN, 0)


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


def count_launch(name: str) -> None:
    _launches[name] += 1


def launch_counts() -> dict:
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0
