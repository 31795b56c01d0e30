"""Bit-level sqrt/rsqrt datapaths, the paper's error metrics, the seeded
fault model and the sqrt-unit registry."""
from repro_torch.core.cwaha import cwaha_sqrt
from repro_torch.core.e2afs import e2afs_rsqrt, e2afs_sqrt, e2afs_sqrt_positive
from repro_torch.core.esas import esas_sqrt
from repro_torch.core.exact import exact_rsqrt, exact_sqrt
from repro_torch.core.faults import FaultConfig
from repro_torch.core.metrics import ErrorMetrics, error_metrics, sampled_normal_values
from repro_torch.core.numerics import BF16, FP16, FP32, FloatFormat, format_of
from repro_torch.core.units import SqrtUnit, available_units, get_unit, resolve_ladder

__all__ = [
    "BF16",
    "FP16",
    "FP32",
    "ErrorMetrics",
    "FaultConfig",
    "FloatFormat",
    "SqrtUnit",
    "available_units",
    "cwaha_sqrt",
    "e2afs_rsqrt",
    "e2afs_sqrt",
    "e2afs_sqrt_positive",
    "error_metrics",
    "esas_sqrt",
    "exact_rsqrt",
    "exact_sqrt",
    "format_of",
    "get_unit",
    "resolve_ladder",
    "sampled_normal_values",
]
