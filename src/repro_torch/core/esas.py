"""Reconstructed ESAS baseline (torch port of ``repro.core.esas``,
bit-identical to it).

The level-1-only series approximation with the exponent-parity trick and no
second-level corrections:

    r even:  2^{r/2}     * (1 + Y/2)
    r odd :  2^{(r-1)/2} * 1.5 * (1 + Y/4)
"""
from __future__ import annotations

import torch

from repro_torch.core import numerics
from repro_torch.core.numerics import FloatFormat, format_of

__all__ = ["esas_sqrt"]


def _esas_fields(exp, man, fmt: FloatFormat):
    one = fmt.one
    r = exp - fmt.bias
    odd = r & 1
    exp_out = torch.where(odd == 1, (r - 1) >> 1, r >> 1) + fmt.bias

    even_res = one + (man >> 1)
    t = one + (man >> 2)
    odd_res = t + (t >> 1)
    res = torch.where(odd == 1, odd_res, even_res)
    # max odd result: t = one + (one-1)>>2 -> 1.25*one; res = 1.875*one < 2*one
    return exp_out, res - one


def esas_sqrt(x: torch.Tensor, *, ftz: bool = True) -> torch.Tensor:
    fmt = format_of(x.dtype)
    sign, exp, man = numerics.decompose(x, fmt)
    exp_out, man_out = _esas_fields(exp, man, fmt)
    result = numerics.compose(torch.zeros_like(sign), exp_out, man_out, fmt)
    return numerics.apply_specials(result, x, sign, exp, man, fmt, ftz=ftz)
