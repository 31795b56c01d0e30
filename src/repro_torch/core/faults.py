"""Deterministic, seeded fault model for error-tolerant serving (torch port
of ``repro.core.faults``, with the same schedule bit for bit).

Three fault surfaces, one :class:`FaultConfig`:

* **sqrt datapath bit flips** (``site="sqrt_man"`` / ``"sqrt_exp"``):
  single-bit flips in the mantissa / exponent output fields of the
  approximate sqrt/rsqrt datapaths.  ``core/e2afs.py`` injects them between
  the integer datapath and the compose step (special inputs still route
  around the fault); ``core/units.py`` threads the same config through every
  unit and the kernel route, where the flip lands on the output register
  (:func:`flip_float_bits`);
* **activation corruption** (``site="logit_nan"`` / ``"logit_inf"``):
  NaN/Inf writes into the decode-step logits through :func:`logits_hook`;
* **dispatch failures** (``site="dispatch"``): host-side simulated launch
  failures (:class:`DispatchFaultInjector` raising :class:`DispatchFault`
  before the device call).

Determinism: a device fault decision is a pure function of (value bits,
flat element index, seed), an integer avalanche hash per element, so a run
replays the same schedule on the CPU and the card, eagerly or inside a
captured CUDA graph.  The index is the element's in the WHOLE tensor,
wrapped to 32 bits as the reference's ``uint32`` arange: on a device mesh a
rank hashes its block at its global coordinates (:func:`block`, which the
fault sites open with ``distributed.constraints.block_origin``), so every
layout strikes the elements one device strikes.  Torch has no uint32
multiply on every device, so the 32-bit words ride in int64 and
:func:`_mul32` splits the products (the sampling stream of
``models/lm.py`` uses the same :func:`_mix32`).  Host dispatch faults draw
from ``random.Random(seed)``, as in the reference.
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
import threading
from typing import Callable, Optional

import torch

from repro_torch.core import numerics
from repro_torch.core.numerics import FloatFormat, format_of

__all__ = [
    "FAULT_SITES",
    "FaultConfig",
    "block",
    "fault_mask",
    "flip_fields",
    "flip_float_bits",
    "corrupt_logits",
    "logits_hook",
    "DispatchFault",
    "DispatchFaultInjector",
]

FAULT_SITES = ("sqrt_man", "sqrt_exp", "logit_nan", "logit_inf", "dispatch")


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """One seeded fault schedule: ``site`` picks the surface, ``rate`` the
    per-element (or per-dispatch) fault probability, ``seed`` the schedule.
    ``bit`` pins the flipped bit within the targeted field (0 = LSB); None
    derives it per element from the hash.  Frozen and hashable, so it can
    ride a :class:`~repro_torch.models.config.ModelConfig`."""

    site: str
    rate: float
    seed: int = 0
    bit: Optional[int] = None

    def __post_init__(self):
        if self.site not in FAULT_SITES:
            raise ValueError(f"unknown fault site {self.site!r}; available: {FAULT_SITES}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"fault rate must be in [0, 1], got {self.rate}")

    @property
    def targets_sqrt(self) -> bool:
        return self.site in ("sqrt_man", "sqrt_exp")

    @property
    def targets_logits(self) -> bool:
        return self.site in ("logit_nan", "logit_inf")

    @property
    def targets_dispatch(self) -> bool:
        return self.site == "dispatch"


# ---------------------------------------------------------------------------
# Device fault decisions: 32-bit words held in int64
# ---------------------------------------------------------------------------

_GOLDEN = 0x9E3779B9  # 2^32 / phi, the Weyl increment
_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a 32-bit constant c,
    with every product below 2^49 (no int64 overflow on any device)."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """The reference's 32-bit avalanche (murmur3-style finalizer, the
    "lowbias32" constants), a bijection of words in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


_block = threading.local()


@contextlib.contextmanager
def block(origin, shape):
    """Hash the tensors struck inside as the block at global coordinates
    ``origin`` of a tensor of global ``shape`` (one entry a dim of the
    struck tensor): a rank's share of a sharded fault site.  Outside a
    block a tensor is hashed as the whole."""
    prev = getattr(_block, "at", None)
    _block.at = (tuple(origin), tuple(shape))
    try:
        yield
    finally:
        _block.at = prev


def _flat_index(shape, device) -> torch.Tensor:
    """Each element's flat index in the whole tensor (int64, wrapped to 32
    bits): ``sum((i_d + origin_d) * stride_d)`` over the strides of the
    open :func:`block`'s global shape; a plain ``arange`` outside one."""
    shape = tuple(shape)
    origin, whole = getattr(_block, "at", None) or ((0,) * len(shape), shape)
    if origin == (0,) * len(shape) and whole == shape:
        n = 1
        for s in shape:
            n *= s
        idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
        return idx & _M32 if n > _M32 else idx
    if len(origin) != len(shape) or len(whole) != len(shape) or any(
            o + s > w for o, s, w in zip(origin, shape, whole)):
        raise ValueError(f"a block of {shape} at {origin} does not lie in a tensor of {whole}")
    idx = torch.zeros((), dtype=torch.int64, device=device)
    stride = 1
    for d in reversed(range(len(shape))):
        coord = torch.arange(shape[d], dtype=torch.int64, device=device) + int(origin[d])
        term = (coord * (stride & _M32)) & _M32  # int64 wrap-around keeps the low 32 bits
        idx = idx + term.reshape((-1,) + (1,) * (len(shape) - 1 - d))
        stride *= int(whole[d])
    return idx.expand(shape) & _M32


def _entropy(bits: torch.Tensor, seed: int) -> torch.Tensor:
    """Per-element 32-bit hash (in int64) of (value bits, flat index, seed);
    ``bits`` any integer tensor, read as its low 32 bits.  The index is the
    element's in the whole tensor: inside :func:`block`, ``bits`` is that
    block of a tensor of the block's global shape (a rank's share of a
    sharded fault site), else ``bits`` is the whole tensor; it wraps to 32
    bits as the reference's ``uint32`` arange."""
    idx = _flat_index(bits.shape, bits.device)
    h = (bits.to(torch.int64) & _M32) ^ _mix32(idx ^ (seed & _M32))
    return _mix32(h ^ ((seed * _GOLDEN) & _M32))


def fault_mask(bits: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """Boolean fault-strike mask, elementwise over ``bits``: a pure function
    of (bits, index, seed), so replaying the same values under the same seed
    strikes the same elements.  Inside :func:`block` it is that slice of the
    whole tensor's mask."""
    if rate <= 0.0:
        return torch.zeros(bits.shape, dtype=torch.bool, device=bits.device)
    thr = min(int(rate * float(1 << 32)), (1 << 32) - 1)
    return _entropy(bits, seed) < thr


def _bit_choice(bits: torch.Tensor, seed: int, width: int, pinned: Optional[int]):
    """Which bit of a ``width``-bit field to flip, per element (int32)."""
    if pinned is not None:
        return torch.full(bits.shape, int(pinned) % width, dtype=torch.int32, device=bits.device)
    return (_entropy(bits, seed ^ 0x5BF03635) % width).to(torch.int32)


def flip_fields(exp: torch.Tensor, man: torch.Tensor, fmt: FloatFormat, cfg: FaultConfig):
    """Strike the (exponent, mantissa) int32 field pair of a decomposed
    float: flip one seeded bit of the targeted field on hash-selected
    elements.  The in-datapath injection point of ``core/e2afs.py``."""
    if not cfg.targets_sqrt or cfg.rate <= 0.0:
        return exp, man
    entropy_src = ((exp & fmt.exp_mask) << fmt.man_bits) | (man & fmt.man_mask)
    strike = fault_mask(entropy_src, cfg.rate, cfg.seed)
    if cfg.site == "sqrt_man":
        bit = _bit_choice(entropy_src, cfg.seed, fmt.man_bits, cfg.bit)
        man = torch.where(strike, man ^ (1 << bit), man)
    else:  # sqrt_exp
        bit = _bit_choice(entropy_src, cfg.seed, fmt.exp_bits, cfg.bit)
        exp = torch.where(strike, exp ^ (1 << bit), exp)
    return exp, man


def flip_float_bits(x: torch.Tensor, cfg: FaultConfig) -> torch.Tensor:
    """Output-register form of :func:`flip_fields`: decompose, strike the
    targeted field, recompose.  Used where the datapath is opaque (the
    kernel route, the units without a ``faults=`` hook)."""
    if not cfg.targets_sqrt or cfg.rate <= 0.0:
        return x
    fmt = format_of(x.dtype)
    sign, exp, man = numerics.decompose(x, fmt)
    exp, man = flip_fields(exp, man, fmt, cfg)
    return numerics.compose(sign, exp & fmt.exp_mask, man & fmt.man_mask, fmt)


def corrupt_logits(logits: torch.Tensor, cfg: FaultConfig) -> torch.Tensor:
    """NaN/Inf activation injection into a float logits tensor, struck by
    the hash of its float32 bits."""
    if not cfg.targets_logits or cfg.rate <= 0.0:
        return logits
    lg = logits.float()
    strike = fault_mask(lg.view(torch.int32), cfg.rate, cfg.seed)
    bad = float("nan") if cfg.site == "logit_nan" else float("inf")
    return torch.where(strike, torch.full_like(lg, bad), lg).to(logits.dtype)


def logits_hook(cfg: Optional[FaultConfig]) -> Optional[Callable]:
    """The per-step logits corruption hook for
    ``lm.decode_slots_scan(logits_hook=)``; None when the config does not
    target activations."""
    if cfg is None or not cfg.targets_logits:
        return None
    return lambda lg: corrupt_logits(lg, cfg)


# ---------------------------------------------------------------------------
# Host-side dispatch failures
# ---------------------------------------------------------------------------


class DispatchFault(RuntimeError):
    """An injected device-dispatch failure, raised before the call."""


class DispatchFaultInjector:
    """Seeded host-side failure schedule: one draw per dispatch attempt.
    ``reset()`` rewinds the stream, so a replay sees the same schedule."""

    def __init__(self, cfg: FaultConfig):
        if not cfg.targets_dispatch:
            raise ValueError(f"DispatchFaultInjector needs site='dispatch', got {cfg.site!r}")
        self.cfg = cfg
        self.reset()

    def reset(self):
        self._rng = random.Random(self.cfg.seed)

    def should_fail(self) -> bool:
        return self._rng.random() < self.cfg.rate
