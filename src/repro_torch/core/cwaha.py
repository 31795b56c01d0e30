"""Reconstructed CWAHA-k baselines (torch port of ``repro.core.cwaha``,
bit-identical to it).

The mantissa interval is split into k uniform clusters and each cluster
outputs a constant: a small ROM indexed by the top log2(k) mantissa bits,
with separate tables for even and odd exponent parity.  The Q10 tables are
scaled to each format's mantissa grid with Python's half-to-even ``round``,
as the reference does.
"""
from __future__ import annotations

import torch

from repro_torch.core import numerics
from repro_torch.core.numerics import FloatFormat, format_of

__all__ = ["cwaha_sqrt", "CWAHA_TABLES"]

# Q10 tables (the reference's tools/fit_constants.py output)
CWAHA_TABLES = {
    4: {
        "even": (1086, 1201, 1305, 1402),
        "odd": (1536, 1698, 1846, 1983),
    },
    8: {
        "even": (1055, 1116, 1173, 1228, 1280, 1330, 1378, 1425),
        "odd": (1492, 1578, 1659, 1736, 1810, 1881, 1949, 2015),
    },
}


def _cwaha_fields(exp, man, fmt: FloatFormat, k: int):
    one = fmt.one
    r = exp - fmt.bias
    odd = r & 1
    exp_out = torch.where(odd == 1, (r - 1) >> 1, r >> 1) + fmt.bias

    idx = man >> (fmt.man_bits - (k.bit_length() - 1))  # top log2(k) bits

    def table(vals):
        scaled = [int(round(v * fmt.one / 1024)) for v in vals]
        return torch.tensor(scaled, dtype=torch.int32, device=man.device)[idx]

    res = torch.where(odd == 1, table(CWAHA_TABLES[k]["odd"]), table(CWAHA_TABLES[k]["even"]))
    return exp_out, res - one


def cwaha_sqrt(x: torch.Tensor, k: int = 8, *, ftz: bool = True) -> torch.Tensor:
    if k not in CWAHA_TABLES:
        raise ValueError(f"CWAHA variants: {sorted(CWAHA_TABLES)}; got {k}")
    fmt = format_of(x.dtype)
    sign, exp, man = numerics.decompose(x, fmt)
    exp_out, man_out = _cwaha_fields(exp, man, fmt, k)
    result = numerics.compose(torch.zeros_like(sign), exp_out, man_out, fmt)
    return numerics.apply_specials(result, x, sign, exp, man, fmt, ftz=ftz)
