"""IEEE binary float format descriptors and bit-level helpers (torch port of
``repro.core.numerics``).

Field math is done in int32, as the reference does after its
``.astype(int32)``: a 16-bit pattern is read through ``Tensor.view(int16)``
and masked with ``& 0xFFFF``; composing truncates the int32 word back to 16
or 32 bits, so out-of-range exponents wrap exactly as they do there.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "FloatFormat",
    "FP16",
    "BF16",
    "FP32",
    "format_of",
    "decompose",
    "compose",
    "apply_specials",
    "all_bit_patterns",
]


@dataclasses.dataclass(frozen=True)
class FloatFormat:
    """Descriptor for an IEEE-754-style binary format."""

    name: str
    dtype: torch.dtype
    int_dtype: torch.dtype  # signed integer of the same width, for bitcasts
    exp_bits: int
    man_bits: int

    @property
    def bias(self) -> int:
        return (1 << (self.exp_bits - 1)) - 1

    @property
    def exp_mask(self) -> int:
        return (1 << self.exp_bits) - 1

    @property
    def man_mask(self) -> int:
        return (1 << self.man_bits) - 1

    @property
    def one(self) -> int:
        """Implicit leading one in fixed-point mantissa domain (Q<man_bits>)."""
        return 1 << self.man_bits

    @property
    def total_bits(self) -> int:
        return 1 + self.exp_bits + self.man_bits

    def q(self, value: float) -> int:
        """Quantize a real constant to this format's fixed-point mantissa grid
        (Python's half-to-even ``round``, as the reference)."""
        return int(round(value * self.one))


FP16 = FloatFormat("fp16", torch.float16, torch.int16, 5, 10)
BF16 = FloatFormat("bf16", torch.bfloat16, torch.int16, 8, 7)
FP32 = FloatFormat("fp32", torch.float32, torch.int32, 8, 23)

_BY_DTYPE = {f.dtype: f for f in (FP16, BF16, FP32)}


def format_of(dtype) -> FloatFormat:
    try:
        return _BY_DTYPE[dtype]
    except KeyError:
        raise ValueError(
            f"approx sqrt units support fp16/bf16/fp32, got {dtype}"
        ) from None


def decompose(x: torch.Tensor, fmt: FloatFormat):
    """Split a float tensor into (sign, biased_exp, mantissa) int32 fields."""
    bits = x.view(fmt.int_dtype).to(torch.int32)
    if fmt.total_bits == 16:
        bits = bits & 0xFFFF
    sign = (bits >> (fmt.exp_bits + fmt.man_bits)) & 1
    exp = (bits >> fmt.man_bits) & fmt.exp_mask
    man = bits & fmt.man_mask
    return sign, exp, man


def compose(sign, exp, man, fmt: FloatFormat) -> torch.Tensor:
    """Assemble int32 (sign, biased_exp, mantissa) fields back into a float,
    truncating the int32 word to the format's width."""
    bits = (sign << (fmt.exp_bits + fmt.man_bits)) | (exp << fmt.man_bits) | man
    if fmt.total_bits == 16:
        bits = bits & 0xFFFF
        bits = torch.where(bits >= 0x8000, bits - 0x10000, bits)
    return bits.to(fmt.int_dtype).view(fmt.dtype)


def apply_specials(result, x, sign, exp, man, fmt: FloatFormat, *, ftz: bool = True):
    """IEEE edge-case policy shared by every approximate unit.

    +0 -> +0, +inf -> +inf, NaN -> NaN, negative -> NaN.  Subnormal inputs are
    flushed to zero when ``ftz``; otherwise they fall through to ``result``.
    """
    del x
    zero = torch.zeros_like(result)
    nan = torch.full_like(result, float("nan"))
    inf = torch.full_like(result, float("inf"))

    is_exp_min = exp == 0
    is_exp_max = exp == fmt.exp_mask
    is_zero = is_exp_min & (man == 0)
    is_sub = is_exp_min & (man != 0)
    is_inf = is_exp_max & (man == 0)
    is_nan = is_exp_max & (man != 0)
    is_neg = (sign == 1) & ~is_zero

    out = result
    if ftz:
        out = torch.where(is_sub, zero, out)
    out = torch.where(is_zero, zero, out)
    out = torch.where(is_inf, inf, out)
    out = torch.where(is_nan | is_neg, nan, out)
    return out


def all_bit_patterns(fmt: FloatFormat) -> np.ndarray:
    """Every bit pattern of the format as a numpy uint16 array (16-bit only)."""
    n = fmt.total_bits
    if n > 16:
        raise ValueError("exhaustive enumeration only for 16-bit formats")
    return np.arange(1 << n, dtype=np.uint16)
