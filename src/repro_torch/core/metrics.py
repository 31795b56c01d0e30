"""The paper's error metric suite and its input domains (torch port of
``repro.core.metrics``).

MED, MRED, NMED, MSE and EDmax of an approximate sqrt against the exact one,
over the complete positive-normal space of a 16-bit format (the paper's
Table 3 protocol) or over the stratified grid of a wider one.  The unit runs
on the device the caller names; the errors are computed in float64 numpy on
the host, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.numerics import FP16, FP32, FloatFormat
from repro_torch.device import resolve_device

__all__ = [
    "ErrorMetrics",
    "error_metrics",
    "positive_normal_values",
    "sampled_normal_values",
]


@dataclasses.dataclass(frozen=True)
class ErrorMetrics:
    med: float
    mred: float
    nmed: float
    mse: float
    ed_max: float

    def as_dict(self):
        return dataclasses.asdict(self)

    def __str__(self):
        return (
            f"MED={self.med:.4f} MRED={self.mred * 100:.4f}e-2 "
            f"NMED={self.nmed * 100:.4f}e-2 MSE={self.mse:.3f} EDmax={self.ed_max:.2f}"
        )


def _bits_to_tensor(bits: np.ndarray, fmt: FloatFormat) -> torch.Tensor:
    ints = bits.astype(np.uint32 if fmt.total_bits == 32 else np.uint16)
    signed = ints.view(np.int32 if fmt.total_bits == 32 else np.int16)
    return torch.from_numpy(signed.copy()).view(fmt.dtype)


def positive_normal_values(fmt: FloatFormat = FP16) -> torch.Tensor:
    """All positive normal values of a 16-bit format, in bit order, as a CPU
    tensor of ``fmt.dtype``."""
    if fmt.total_bits != 16:
        raise ValueError("exhaustive domain only for 16-bit formats")
    exps = np.arange(1, fmt.exp_mask, dtype=np.uint32)  # normals: 1..emax-1
    mans = np.arange(fmt.one, dtype=np.uint32)
    return _bits_to_tensor(((exps[:, None] << fmt.man_bits) | mans[None, :]).reshape(-1), fmt)


def sampled_normal_values(fmt: FloatFormat = FP32, *, mans_per_exp: int = 256) -> torch.Tensor:
    """A deterministic stratified grid of positive normals: EVERY normal
    exponent crossed with ``mans_per_exp`` evenly spaced mantissa codes
    (endpoints included).  For fp32 at the default density that is
    254 x 256 ~ 65k points.  No RNG.  Returns a CPU tensor of ``fmt.dtype``."""
    mans_per_exp = int(mans_per_exp)
    if mans_per_exp < 1:
        raise ValueError(f"mans_per_exp must be >= 1, got {mans_per_exp}")
    exps = np.arange(1, fmt.exp_mask, dtype=np.uint64)  # normals: 1..emax-1
    n = min(mans_per_exp, fmt.one)
    mans = np.unique(np.linspace(0, fmt.one - 1, n).round().astype(np.uint64))
    return _bits_to_tensor(((exps[:, None] << fmt.man_bits) | mans[None, :]).reshape(-1), fmt)


def _float64(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy().astype(np.float64)


def error_metrics(
    approx_fn: Callable,
    fmt: FloatFormat = FP16,
    *,
    reference: str = "sqrt",
    mans_per_exp: int = 256,
    device=None,
) -> ErrorMetrics:
    """Error metrics of ``approx_fn`` against the exact function.

    ``approx_fn`` maps a tensor of ``fmt.dtype`` to the same dtype; it runs
    on ``device`` (the card unless the caller asks for the CPU).  A 16-bit
    ``fmt`` is evaluated over its complete positive normal space, a wider one
    over :func:`sampled_normal_values`.  ED = |approx - exact| in float64.
    """
    if reference not in ("sqrt", "rsqrt"):
        raise ValueError(reference)
    if fmt.total_bits == 16:
        x = positive_normal_values(fmt)
    else:
        x = sampled_normal_values(fmt, mans_per_exp=mans_per_exp)
    y_app = _float64(approx_fn(x.to(resolve_device(device))))
    xf = _float64(x)
    y_ref = np.sqrt(xf) if reference == "sqrt" else 1.0 / np.sqrt(xf)

    ed = np.abs(y_app - y_ref)
    return ErrorMetrics(
        med=float(ed.mean()),
        mred=float((ed / y_ref).mean()),
        nmed=float(ed.mean() / y_ref.max()),
        mse=float((ed**2).mean()),
        ed_max=float(ed.max()),
    )
