"""Kernel registry, routing, tiles and launch counts (counterpart of
``repro.kernels.dispatch``).

Every kernel wrapper asks :func:`use_kernel` where to go, per call:

* a CPU tensor gets the plain PyTorch version;
* a CUDA tensor gets the hand-written CUDA kernel, unless the backend is
  "reference" (``REPRO_KERNEL_BACKEND=reference`` or
  ``set_backend("reference")``), which takes the plain versions everywhere;
* any other device raises.

There is no fallback: a CUDA tensor that the kernel refuses raises.  Each
wrapper calls :func:`count_launch` where it launches its kernel and nowhere
else, so a run can show that its main path went through the kernels.  On a
fake tensor (``FakeTensorMode``, the dry run's) a wrapper allocates its
outputs and counts its launch without calling the library (:func:`is_fake`).

Each kernel package registers a :class:`KernelSpec`: its plain version, its
wrapper and a :class:`TilingSpec` of candidate tiles (the launch shape the
``.cu`` source takes as an argument).  :func:`dispatch` is the one entry
point that resolves the backend per call; a wrapper given no ``block``
resolves its tile with :func:`resolve_block`: a cached or swept choice, else
the spec's default (``kernels/tuning.py``), memoised per kernel, shapes,
dtypes and device so that a step's hundreds of calls read no cache.
:func:`as_blocked_2d`, :func:`unblock`, :func:`pad_rows` and
:func:`pad2d_to_multiple` are the reference's pad helpers on torch tensors.

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
import dataclasses
import importlib
import os
from typing import Callable, Iterator, Optional, Sequence

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor

__all__ = [
    "BACKENDS",
    "ENV_BACKEND",
    "KNOWN",
    "KernelSpec",
    "Launches",
    "TilingSpec",
    "as_blocked_2d",
    "capture_launches",
    "count_launch",
    "dispatch",
    "forget_choices",
    "get",
    "is_fake",
    "fake_cpu_kernel_route",
    "kernel_device",
    "last_blocks",
    "launch_counts",
    "launch_details",
    "make_differentiable_rsqrt",
    "make_differentiable_sqrt",
    "observe_launches",
    "pad2d_to_multiple",
    "pad_rows",
    "register",
    "registered",
    "replay_launches",
    "reset_launch_counts",
    "resolve_backend",
    "resolve_block",
    "set_backend",
    "unblock",
    "use_kernel",
]

ENV_BACKEND = "REPRO_KERNEL_BACKEND"
# the port has no interpreter: "auto" takes the kernels on CUDA tensors and
# the plain versions on CPU tensors, "reference" the plain versions everywhere
BACKENDS = ("auto", "reference")
KNOWN = ("adam", "decode_attention", "e2afs_rsqrt", "e2afs_sqrt", "kmeans_assign", "rmsnorm",
         "sobel")
# get() imports the ops module that registers each kernel on first touch, so
# importing dispatch loads no kernel wrapper
_OPS_MODULE = {
    "adam": "repro_torch.kernels.adam.ops",
    "decode_attention": "repro_torch.kernels.attention.ops",
    "e2afs_rsqrt": "repro_torch.kernels.e2afs_sqrt.ops",
    "e2afs_sqrt": "repro_torch.kernels.e2afs_sqrt.ops",
    "kmeans_assign": "repro_torch.kernels.kmeans.ops",
    "rmsnorm": "repro_torch.kernels.rmsnorm.ops",
    "sobel": "repro_torch.kernels.sobel.ops",
}

_backend_override: Optional[str] = None
_launches = dict.fromkeys(KNOWN, 0)
_details: dict = {}
_capturing: Optional["Launches"] = None
_observers: list = []
_choices: dict = {}
_uniform: dict = {}  # kernel -> the tile of every shape (nothing cached, tuning off)
_last_blocks: dict = {}


# ---------------------------------------------------------------------------
# backend resolution
# ---------------------------------------------------------------------------


def set_backend(name: Optional[str]) -> str:
    """Process-wide route, beating ``REPRO_KERNEL_BACKEND``: "auto" (kernels
    on CUDA, plain versions on CPU) or "reference" (plain versions
    everywhere); None goes back to the variable.  Returns the route in force
    before, so callers can restore it."""
    global _backend_override
    if name is not None and name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r}; expected one of {BACKENDS}")
    prev = resolve_backend()
    _backend_override = name
    return prev


def resolve_backend() -> str:
    """The route in force: :func:`set_backend`'s, else ``REPRO_KERNEL_BACKEND``,
    else "auto".  A value outside :data:`BACKENDS` raises with the valid
    set."""
    if _backend_override is not None:
        return _backend_override
    req = os.environ.get(ENV_BACKEND, "auto")
    if req not in BACKENDS:
        raise ValueError(f"invalid {ENV_BACKEND}={req!r}; expected one of {BACKENDS}")
    return req


_fake_cpu_route = False


@contextlib.contextmanager
def fake_cpu_kernel_route() -> Iterator[None]:
    """Within the block, fake CPU tensors take the kernel route (the output
    and the count, no library) as fake CUDA tensors do.  A torch built
    without CUDA can neither index nor differentiate a fake CUDA tensor
    (both ask the missing CUDA guard), so the dry run's cells run on fake
    CPU tensors there."""
    global _fake_cpu_route
    prev, _fake_cpu_route = _fake_cpu_route, True
    try:
        yield
    finally:
        _fake_cpu_route = prev


def kernel_device(device_type: str) -> bool:
    """True where tensors of ``device_type`` go to the CUDA kernels: "cuda",
    and "cpu" within :func:`fake_cpu_kernel_route`."""
    return device_type == "cuda" or (device_type == "cpu" and _fake_cpu_route)


def use_kernel(*tensors: Optional[torch.Tensor]) -> bool:
    """True when these operands go to the CUDA kernel, False for the plain
    version.  All operands must lie on one device."""
    present = [t for t in tensors if t is not None]
    dev = present[0].device
    for t in present[1:]:
        if t.device != dev:
            raise ValueError(f"kernel operands on different devices: {dev} and {t.device}")
    if dev.type == "cpu":
        return _fake_cpu_route and is_fake(present[0]) and resolve_backend() != "reference"
    if dev.type != "cuda":
        raise ValueError(f"no kernel route for device {dev}")
    return resolve_backend() != "reference"


def is_fake(t: torch.Tensor) -> bool:
    """True when ``t``, a wrapper's first operand, is a fake tensor
    (``FakeTensorMode``, where every operand is fake): the wrapper then
    allocates its outputs and counts its launch, and calls no library.
    Never true of a real tensor."""
    return isinstance(t, FakeTensor)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TilingSpec:
    """Candidate tiles of a kernel, each a tuple of ints its ``.cu`` source
    takes at launch; ``default`` is among them, the launch an untuned call
    takes.

    ``geometry`` optionally maps the kernel's positional arguments to the
    problem geometry the roofline reads to narrow a sweep (rows /
    row_elems / ops_per_elem / streams / max_block_rows / staged, see
    :func:`repro_torch.kernels.tuning.tile_geometry`); ``block[0]`` is the
    rows of that geometry a block takes."""

    default: tuple
    candidates: tuple
    geometry: Optional[Callable] = None

    def __post_init__(self):
        if tuple(self.default) not in tuple(tuple(c) for c in self.candidates):
            raise ValueError(f"default {self.default} not among candidates {self.candidates}")


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """A registered kernel: its plain version, its wrapper and its tiles.
    ``kernel`` takes the plain version's arguments and ``block=`` (a tile,
    or None to resolve one) and ``tune=``; on a CPU tensor it runs the plain
    version, as every wrapper does."""

    name: str
    reference: Callable
    kernel: Callable
    tiling: TilingSpec


_REGISTRY: dict = {}


def register(spec: KernelSpec) -> KernelSpec:
    """Add a kernel to the registry (each ops module, at import); returns
    the spec."""
    _REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> KernelSpec:
    """The registered :class:`KernelSpec` of ``name``, importing its ops
    module on first touch; a name it does not know raises ValueError with
    the known ones."""
    if name not in _REGISTRY:
        mod = _OPS_MODULE.get(name)
        if mod is not None:
            importlib.import_module(mod)
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown kernel {name!r}; known: {sorted(KNOWN)}") from None


def registered() -> tuple:
    """Every registered kernel name (registering the known ones first)."""
    for name in KNOWN:
        get(name)
    return tuple(sorted(_REGISTRY))


def dispatch(name: str, *args, block: Optional[Sequence[int]] = None,
             tune: Optional[bool] = None, **kw):
    """Run kernel ``name`` on ``args``: the plain version where the backend
    is "reference", else its wrapper (kernel on CUDA, plain version on CPU)
    with ``block`` (None: resolved by :func:`resolve_block`) and ``tune``."""
    spec = get(name)
    if resolve_backend() == "reference":
        return spec.reference(*args, **kw)
    return spec.kernel(*args, block=block, tune=tune, **kw)


def resolve_block(name: str, tensors: Sequence[torch.Tensor], sweep_run: Callable,
                  sweep_args: tuple, *, tune: Optional[bool] = None) -> tuple:
    """The tile of kernel ``name`` for these operands: ``tuning.choose_block``
    (a cache hit, a sweep where tuning is on, else the spec's default),
    memoised per kernel and first operand's shape and dtype (finer than the
    cache's key, its dtype and size bucket), and per kernel alone where the
    cache holds nothing of it and tuning is off, so that every shape takes
    the default: a step's hundreds of calls pay one dict lookup.  A sweep
    times ``sweep_run(*sweep_args)``, a callable of the tile, built only
    when a sweep runs.  An explicit ``tune=True`` resolves again.  Nothing
    is memoised inside a CUDA graph's capture (no sweep runs there)."""
    if not tune:
        block = _uniform.get(name)
        if block is not None:
            return block
    memo = (name, tensors[0].shape, tensors[0].dtype)
    if not tune:
        block = _choices.get(memo)
        if block is not None:
            return block
    from repro_torch.kernels import tuning

    built = []

    def run(block):
        if not built:
            built.append(sweep_run(*sweep_args))
        return built[0](block)

    spec = get(name)
    block = tuning.choose_block(name, spec.tiling.candidates, spec.tiling.default, run,
                                tuple(tensors), tune=tune, geometry=spec.tiling.geometry)
    if tune:
        _uniform.pop(name, None)  # the sweep may have cached a tile
    if not (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()):
        _choices[memo] = block
        if not tune and not tuning.autotune_enabled() and not tuning.has_entries(name):
            _uniform[name] = block
    return block


def forget_choices() -> None:
    """Drop every memoised tile, so the next call resolves again (after the
    tune cache or its variables change)."""
    _choices.clear()
    _uniform.clear()


def last_blocks() -> dict:
    """{kernel: the tile of its last launch}."""
    return dict(_last_blocks)


# ---------------------------------------------------------------------------
# launch counts
# ---------------------------------------------------------------------------


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


def count_launch(name: str, detail: Optional[str] = None, *, reads=(), writes=(),
                 block: Optional[tuple] = None) -> None:
    """One launch of kernel ``name``; ``detail`` (a variant such as "wrap")
    is also tallied under "<name> <detail>" in :func:`launch_details`.
    Inside :func:`capture_launches` the launch goes to the capture's record
    instead of the totals.  ``reads`` and ``writes`` are the operands the
    launch reads and the tensors it writes, handed to the observers of
    :func:`observe_launches` (a cost count); ``block`` is its tile."""
    if _capturing is not None:
        _tally(_capturing.counts, _capturing.details, name, detail)
    else:
        _tally(_launches, _details, name, detail)
    if block is not None:
        _last_blocks[name] = tuple(block)
    for fn in _observers:
        fn(name, [t for t in reads if t is not None], [t for t in writes if t is not None])


@contextlib.contextmanager
def observe_launches(fn: Callable) -> Iterator[None]:
    """Call ``fn(name, reads, writes)`` at every launch counted inside the
    block (``launch/op_cost.py`` counts each as one op of those bytes)."""
    _observers.append(fn)
    try:
        yield
    finally:
        _observers.remove(fn)


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
# Shared pad/unpad plumbing (the reference's helpers, on torch tensors)
# ---------------------------------------------------------------------------


def as_blocked_2d(x: torch.Tensor, *, width: int, block_rows: int,
                  pad_value=0.0) -> torch.Tensor:
    """Flatten to (rows, width) with rows % block_rows == 0, padding with
    ``pad_value``.  A block-aligned (rows, width) input is returned as it is
    (the same tensor)."""
    n = x.numel()
    chunk = width * block_rows
    total = -(-max(n, 1) // chunk) * chunk
    if total == n and x.ndim == 2 and x.shape[1] == width:
        return x
    flat = x.reshape(-1)
    if total != n:
        flat = F.pad(flat, (0, total - n), value=pad_value)
    return flat.reshape(total // width, width)


def unblock(y2d: torch.Tensor, n: int, shape) -> torch.Tensor:
    """Inverse of :func:`as_blocked_2d`: drop the padding, restore the shape."""
    return y2d.reshape(-1)[:n].reshape(shape)


def pad_rows(x2d: torch.Tensor, block_rows: int, pad_value=0.0) -> torch.Tensor:
    """Pad the leading dim of (rows, d) to a multiple of ``block_rows``; an
    aligned input is returned as it is."""
    pad = (-x2d.shape[0]) % block_rows
    if pad:
        x2d = F.pad(x2d, (0, 0, 0, pad), value=pad_value)
    return x2d


def pad2d_to_multiple(x: torch.Tensor, block: Sequence[int], *, halo: int = 0,
                      mode: str = "edge") -> torch.Tensor:
    """Pad the trailing two dims of ``x`` so that (dim - halo) is a multiple
    of the block (``halo``: the border a stencil consumes, 2 for a 3 x 3).
    An aligned input is returned as it is; "edge" replicates the last row
    and column, "constant" pads zeros."""
    bh, bw = block
    h, w = x.shape[-2:]
    ph = (-(h - halo)) % bh
    pw = (-(w - halo)) % bw
    if not (ph or pw):
        return x
    if mode == "edge":
        rows = torch.cat([x, x[..., -1:, :].expand(*x.shape[:-2], ph, w)], dim=-2)
        return torch.cat([rows, rows[..., -1:].expand(*rows.shape[:-1], pw)], dim=-1)
    if mode == "constant":
        return F.pad(x, (0, pw, 0, ph))
    raise ValueError(f"unknown pad mode {mode!r}; expected 'edge' or 'constant'")


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
