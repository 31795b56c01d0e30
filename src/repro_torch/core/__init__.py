"""Bit-level sqrt/rsqrt datapaths and the sqrt-unit registry."""
from repro_torch.core.e2afs import e2afs_rsqrt, e2afs_sqrt, e2afs_sqrt_positive
from repro_torch.core.exact import exact_rsqrt, exact_sqrt
from repro_torch.core.numerics import BF16, FP16, FP32, FloatFormat, format_of
from repro_torch.core.units import SqrtUnit, get_unit

__all__ = [
    "BF16",
    "FP16",
    "FP32",
    "FloatFormat",
    "SqrtUnit",
    "e2afs_rsqrt",
    "e2afs_sqrt",
    "e2afs_sqrt_positive",
    "exact_rsqrt",
    "exact_sqrt",
    "format_of",
    "get_unit",
]
