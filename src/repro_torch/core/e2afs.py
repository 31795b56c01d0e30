"""E2AFS: the paper's multiplier-free approximate floating-point square rooter
(torch port of ``repro.core.e2afs``, bit-identical to it).

For ``M = 2^r (1+Y)``:

    r even, Y < 0.5 :  2^{r/2}      * (1 + Y/2)
    r even, Y >= 0.5:  2^{r/2}      * (1 + Y/2 - 0.045)
    r odd,  Y < 0.5 :  2^{(r-1)/2}  * 1.5 * (1 + Y/4)
    r odd,  Y >= 0.5:  2^{(r-1)/2}  * 1.5 * (1 + (Y + 0.3333)/4)

as an integer datapath of shifts, adds and two 1-bit decisions (exponent
parity, mantissa MSB).  E2AFS-R is the reciprocal square root built by the
same recipe (a four-region shift-add PWL of the mantissa).

The Q-grid constants come from :func:`format_constants`, which rounds with
Python's half-to-even ``round`` exactly as the reference does; the CUDA
datapath (``csrc/e2afs.cuh``) takes the same numbers from a header generated
from this function, so no rounding happens in C++.
"""
from __future__ import annotations

import torch

from repro_torch.core import numerics
from repro_torch.core.faults import flip_fields
from repro_torch.core.numerics import FloatFormat, format_of

__all__ = [
    "e2afs_sqrt",
    "e2afs_sqrt_positive",
    "e2afs_rsqrt",
    "E2AFS_CONSTANTS",
    "RSQRT_REGIONS",
    "format_constants",
]

_C_EVEN_HI = 0.045  # subtracted when r even, Y >= 0.5
_C_ODD_HI = 0.3333  # added to Y (before >>2) when r odd, Y >= 0.5

E2AFS_CONSTANTS = {"c_even_hi": _C_EVEN_HI, "c_odd_hi": _C_ODD_HI}

# (odd, y_hi) -> (shift_a, shift_b, intercept_q10) of the E2AFS-R regions
RSQRT_REGIONS = {
    (0, 0): (1, 2, 2030),
    (0, 1): (2, 3, 1835),
    (1, 0): (1, 8, 1428),
    (1, 1): (2, 4, 1336),
}


def format_constants(fmt: FloatFormat) -> dict:
    """The datapath's integer constants on ``fmt``'s mantissa grid:
    ``c_even``/``c_odd`` of E2AFS and the four E2AFS-R intercepts keyed by
    (odd, y_hi)."""
    return {
        "c_even": fmt.q(_C_EVEN_HI),
        "c_odd": fmt.q(_C_ODD_HI),
        "rsqrt_intercepts": {
            key: int(round(c_q10 * fmt.one / 1024))
            for key, (_, _, c_q10) in RSQRT_REGIONS.items()
        },
    }


def _e2afs_mantissa_exponent(exp, man, fmt: FloatFormat):
    """Shared integer datapath: biased exp + mantissa -> output fields (int32)
    for the normal-input case; specials are the caller's."""
    one = fmt.one
    consts = format_constants(fmt)
    c_even, c_odd = consts["c_even"], consts["c_odd"]

    r = exp - fmt.bias
    odd = r & 1  # two's-complement LSB: correct parity for negative r too
    y_hi = man >> (fmt.man_bits - 1)

    # r/2 (even) or (r-1)/2 (odd); arithmetic shifts are exact for both
    half = torch.where(odd == 1, (r - 1) >> 1, r >> 1)
    exp_out = half + fmt.bias

    even_res = one + (man >> 1) - torch.where(y_hi == 1, c_even, 0)
    man_adj = torch.where(y_hi == 1, man + c_odd, man)
    t = one + (man_adj >> 2)
    odd_res = t + (t >> 1)

    res = torch.where(odd == 1, odd_res, even_res)

    # one-step renormalizer (never taken for FP16; kept for other formats)
    ovf = res >> (fmt.man_bits + 1)
    res = torch.where(ovf == 1, res >> 1, res)
    exp_out = exp_out + ovf

    man_out = res - one
    return exp_out, man_out


def e2afs_sqrt_positive(x: torch.Tensor) -> torch.Tensor:
    """E2AFS sqrt for known-positive finite inputs (no specials); exact zeros
    from a caller's clamp map to 0.  The reference's ``x <= 0`` compares in
    float32 with denormals read as zero (XLA on CPU and TPU), so a bf16 or
    fp32 subnormal maps to 0 as well; fp16 subnormals are normal in float32
    and keep their datapath value."""
    fmt = format_of(x.dtype)
    sign, exp, man = numerics.decompose(x, fmt)
    exp_out, man_out = _e2afs_mantissa_exponent(exp, man, fmt)
    res = numerics.compose(torch.zeros_like(sign), exp_out, man_out, fmt)
    zero = x <= 0.0
    if fmt.exp_bits == numerics.FP32.exp_bits:  # subnormal in float32 too
        zero = zero | (exp == 0)
    return torch.where(zero, torch.zeros_like(res), res)


def e2afs_sqrt(x: torch.Tensor, *, ftz: bool = True, faults=None) -> torch.Tensor:
    """Approximate sqrt via the E2AFS datapath.  Same dtype in/out.

    ``faults`` (a :class:`~repro_torch.core.faults.FaultConfig` targeting a
    sqrt site) strikes the output fields between the datapath and compose;
    special inputs still route through ``apply_specials`` unfaulted, as a
    datapath-internal upset would behave.
    """
    fmt = format_of(x.dtype)
    sign, exp, man = numerics.decompose(x, fmt)
    exp_out, man_out = _e2afs_mantissa_exponent(exp, man, fmt)
    exp_out, man_out = _maybe_fault(exp_out, man_out, fmt, faults)
    result = numerics.compose(torch.zeros_like(sign), exp_out, man_out, fmt)
    return numerics.apply_specials(result, x, sign, exp, man, fmt, ftz=ftz)


def _maybe_fault(exp_out, man_out, fmt: FloatFormat, faults):
    if faults is None:
        return exp_out, man_out
    exp_out, man_out = flip_fields(exp_out, man_out, fmt, faults)
    return exp_out & fmt.exp_mask, man_out & fmt.man_mask


def _rsqrt_mantissa_exponent(exp, man, fmt: FloatFormat):
    one = fmt.one
    r = exp - fmt.bias
    odd = r & 1
    y_hi = man >> (fmt.man_bits - 1)

    # even -> -r/2 - 1 (renorm folded); odd -> -(r+1)/2 (exact: r+1 even)
    exp_out = torch.where(odd == 1, -((r + 1) >> 1), -(r >> 1) - 1) + fmt.bias

    intercepts = format_constants(fmt)["rsqrt_intercepts"]

    def region(key):
        a, b, _ = RSQRT_REGIONS[key]
        return intercepts[key] - (man >> a) - (man >> b)

    res = torch.where(
        odd == 1,
        torch.where(y_hi == 1, region((1, 1)), region((1, 0))),
        torch.where(y_hi == 1, region((0, 1)), region((0, 0))),
    )

    # the odd path near Y -> 1 can dip just below 1.0; renormalize
    under = (res < one).to(torch.int32)
    res = torch.where(under == 1, res << 1, res)
    exp_out = exp_out - under

    man_out = (res - one) & fmt.man_mask
    return exp_out, man_out


def e2afs_rsqrt(x: torch.Tensor, *, ftz: bool = True, faults=None) -> torch.Tensor:
    """Approximate rsqrt via the E2AFS-R datapath.

    rsqrt(0) = +inf and rsqrt(+inf) = 0.  Under ftz a positive subnormal is
    zero to the datapath and also gives +inf; negative subnormals keep NaN.
    ``faults`` as in :func:`e2afs_sqrt`.
    """
    fmt = format_of(x.dtype)
    sign, exp, man = numerics.decompose(x, fmt)
    exp_out, man_out = _rsqrt_mantissa_exponent(exp, man, fmt)
    exp_out, man_out = _maybe_fault(exp_out, man_out, fmt, faults)
    result = numerics.compose(torch.zeros_like(sign), exp_out, man_out, fmt)
    out = numerics.apply_specials(result, x, sign, exp, man, fmt, ftz=ftz)
    is_zero = (exp == 0) & (man == 0)
    if ftz:
        is_zero = is_zero | ((exp == 0) & (sign == 0))
    is_inf = (exp == fmt.exp_mask) & (man == 0) & (sign == 0)
    out = torch.where(is_zero, torch.full_like(out, float("inf")), out)
    out = torch.where(is_inf, torch.zeros_like(out), out)
    return out
