"""Tile tuning for the kernel registry (torch port of ``repro.kernels.tuning``).

A wrapper's tile is resolved in three steps:

1. cache hit: the JSON cache maps a problem key
   ``<kernel>/cuda/<dtype>/n2^<bucket>`` to a tile picked before;
2. timed sweep: where tuning is on (``REPRO_AUTOTUNE=1`` or an explicit
   ``tune=True``), the roofline-admissible candidates of the kernel's
   ``TilingSpec`` are timed on the real operands (CUDA events on the card,
   after a warm-up) and the winner is written to the cache;
3. otherwise the spec's default, the kernel's measured launch.  The
   reference returns its roofline prior here; on the card the prior would
   only restate the default (ROADMAP C.40), so it narrows sweeps instead.

The roofline prior: per candidate the predicted time is grid steps x (the
chip's step overhead + tile work), the work the larger of its operation and
memory terms (chip constants from :mod:`repro_torch.core.hw_model`); a
candidate whose predicted occupancy (work / total) falls below
:data:`OCC_FLOOR` is left out of the sweep.

The cache lives at ``~/.cache/repro_torch/kernel_tune.json`` unless
``REPRO_TUNE_CACHE`` names another file; a corrupt or unwritable file is
tolerated (no entries, nothing persisted).  A sweep never runs on fake or
meta tensors (there is nothing to time) nor while a CUDA graph is being
captured (a launch there runs nothing).  The arithmetic of
:func:`predict_block_time` and :func:`roofline_plan` is the reference's,
term for term.
"""
from __future__ import annotations

import json
import math
import os
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

import torch
from torch._subclasses.fake_tensor import FakeTensor

__all__ = [
    "OCC_FLOOR",
    "autotune_enabled",
    "cache_path",
    "choose_block",
    "has_entries",
    "lookup",
    "predict_block_time",
    "problem_key",
    "record",
    "roofline_plan",
    "sweep",
    "tile_geometry",
]

ENV_CACHE = "REPRO_TUNE_CACHE"
ENV_AUTOTUNE = "REPRO_AUTOTUNE"
DEFAULT_CACHE = "~/.cache/repro_torch/kernel_tune.json"
CACHE_VERSION = 1

# least predicted busy fraction (tile work / total with the step overhead)
# for a candidate to stay in the tuning plan
OCC_FLOOR = 0.5
# when every candidate is overhead-bound (tiny problems), keep this many
# best-predicted candidates so that a sweep still has something to time
_NARROW_TOP = 3

# in-memory mirror of the on-disk cache, keyed by resolved path so that a
# changed REPRO_TUNE_CACHE reads its own file
_mem: dict = {}


def cache_path() -> Path:
    return Path(os.environ.get(ENV_CACHE, DEFAULT_CACHE)).expanduser()


def autotune_enabled() -> bool:
    return os.environ.get(ENV_AUTOTUNE, "0").lower() not in ("0", "", "false", "off")


def _entries(path: Path) -> dict:
    key = str(path)
    if key not in _mem:
        try:
            _mem[key] = json.loads(path.read_text()).get("entries", {})
        except (FileNotFoundError, json.JSONDecodeError, OSError, AttributeError):
            _mem[key] = {}
    return _mem[key]


def _persist(path: Path, entries: dict) -> None:
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(
            json.dumps({"version": CACHE_VERSION, "entries": entries}, indent=2, sort_keys=True))
    except OSError:
        pass  # read-only file system: keep the in-memory pick, persist nothing


def _first_tensor(args: Sequence):
    return next(a for a in args if isinstance(a, torch.Tensor))


def problem_key(name: str, args: Sequence) -> str:
    """Cache key: kernel, backend ("cuda"), dtype of the first tensor
    argument, and a power-of-two bucket of its size."""
    arr = _first_tensor(args)
    bucket = max(arr.numel() - 1, 0).bit_length()  # ceil(log2(n))
    return f"{name}/cuda/{str(arr.dtype).removeprefix('torch.')}/n2^{bucket}"


def lookup(key: str, candidates: Sequence[tuple]) -> Optional[tuple]:
    """The cached tile of ``key``, if it is still one of ``candidates``."""
    entry = _entries(cache_path()).get(key)
    if not isinstance(entry, dict):
        return None
    block = tuple(entry.get("block", ()))
    return block if block in tuple(tuple(c) for c in candidates) else None


def has_entries(name: str) -> bool:
    """True when the cache holds a tile of kernel ``name`` for any size."""
    return any(key.startswith(f"{name}/") for key in _entries(cache_path()))


def record(key: str, block: tuple, timings_us: dict) -> None:
    path = cache_path()
    entries = _entries(path)
    entries[key] = {"block": list(block), "timings_us": timings_us}
    _persist(path, entries)


def _timed_us(run: Callable[[tuple], object], cand: tuple, reps: int, device) -> float:
    """Microseconds a call of ``run(cand)`` after one warm-up call: CUDA
    events around ``reps`` back-to-back calls on the card, the host clock
    for a callable on the CPU."""
    run(cand)
    if device is not None and device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            run(cand)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        run(cand)
    return (time.perf_counter() - t0) / reps * 1e6


def sweep(run: Callable[[tuple], object], candidates: Sequence[tuple], reps: int = 3,
          device=None):
    """Time ``run(block)`` for each candidate on ``device`` (CUDA events on
    a CUDA device, else the host clock); a candidate that raises is left
    out.  Returns (best tile, {str(list(tile)): microseconds}), or (None,
    {}) when every candidate raised."""
    results = []
    timings = {}
    for cand in candidates:
        cand = tuple(cand)
        try:
            us = _timed_us(run, cand, reps, device)
        except Exception:
            continue  # the candidate does not take this problem
        results.append((cand, us))
        timings[str(list(cand))] = us
    if not results:
        return None, timings
    return min(results, key=lambda r: r[1])[0], timings


# ---------------------------------------------------------------------------
# roofline tile priors
# ---------------------------------------------------------------------------


def _hw_model():
    from repro_torch.core import hw_model

    return hw_model


def tile_geometry(args: Sequence) -> dict:
    """Default problem geometry: the first tensor argument of at least one
    dim is tiled along its leading axis, each of whose rows carries
    ``row_elems`` elements; ``ops_per_elem`` is the E2AFS critical-path
    depth of the unit-gate model, two streams (read x, write out).  A
    kernel's own geometry may add ``max_block_rows`` (a cap on
    ``block[0]``) and ``staged: False`` (its blocks stream from device
    memory and stage no tile, so the fast-memory test does not apply)."""
    arr = next(a for a in args if getattr(a, "ndim", 0) >= 1 and hasattr(a, "numel"))
    rows = int(arr.shape[0])
    return {
        "rows": rows,
        "row_elems": max(int(arr.numel()) // max(rows, 1), 1),
        "ops_per_elem": _hw_model().cost("e2afs")["depth"],
        "streams": 2,
    }


def predict_block_time(block: Sequence[int], geom: dict, chip):
    """Predicted (seconds, occupancy, feasible) of one candidate: tile work
    = max(operation term, memory term) over the padded element count, plus
    the chip's fixed overhead a grid step; occupancy = work / total.  A tile
    is feasible when its streams fit the chip's fast memory (where the
    kernel stages its tile) and its rows do not pass the geometry's
    ``max_block_rows``."""
    rows, width = geom["rows"], geom["row_elems"]
    b0 = max(1, min(int(block[0]), rows))  # a wrapper clamps an oversize tile
    steps = math.ceil(rows / b0)
    elems = steps * b0 * width  # padded: the grid's work includes the pad
    compute_s = elems * geom["ops_per_elem"] / chip.peak_flops
    memory_s = elems * 4.0 * geom.get("streams", 2) / chip.hbm_bw
    work = max(compute_s, memory_s)
    total = work + steps * chip.step_overhead_s
    occupancy = work / total if total > 0.0 else 0.0
    feasible = (not geom.get("staged", True)
                or b0 * width * 4.0 * geom.get("streams", 2) <= chip.vmem_bytes)
    feasible = feasible and int(block[0]) <= geom.get("max_block_rows", int(block[0]))
    return total, occupancy, feasible


def roofline_plan(candidates: Sequence[tuple], default: tuple, args: Sequence, *, chip=None,
                  geometry: Optional[Callable[[Sequence], dict]] = None):
    """(prior tile, admissible candidates) from the chip's roofline model
    (``chip``, else the model of the first tensor's card).

    The prior is the fastest-predicted feasible candidate whose occupancy
    clears :data:`OCC_FLOOR`; when every candidate is overhead-bound the
    floor is waived and the best :data:`_NARROW_TOP` stay, ties going to
    the smaller tile.  Any modelling failure (no tensor argument, no model
    of the device) gives the default and the blind grid."""
    cands = tuple(tuple(c) for c in candidates)
    try:
        geom = (geometry or tile_geometry)(args)
        if chip is None:
            chip = _hw_model().chip_for_device(_first_tensor(args).device)
        scored = []
        for cand in cands:
            t, occ, ok = predict_block_time(cand, geom, chip)
            if ok:
                scored.append((t, math.prod(cand), cand, occ))
        if not scored:
            return tuple(default), cands
        scored.sort()
        admissible = [c for _, _, c, occ in scored if occ >= OCC_FLOOR]
        if admissible:
            prior = admissible[0]
        else:
            admissible = [c for _, _, c, _ in scored[:_NARROW_TOP]]
            prior = admissible[0]
        return prior, tuple(admissible)
    except Exception:
        return tuple(default), cands


def _untimeable(args: Sequence) -> bool:
    """True where nothing can be timed: a fake or meta operand, or a CUDA
    graph being captured."""
    for a in args:
        if isinstance(a, FakeTensor) or (isinstance(a, torch.Tensor) and a.is_meta):
            return True
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def choose_block(name: str, candidates: Sequence[tuple], default: tuple,
                 run: Callable[[tuple], object], args: Sequence, *, tune: Optional[bool] = None,
                 geometry: Optional[Callable[[Sequence], dict]] = None, chip=None) -> tuple:
    """Resolve a tile: a cache hit, else (where tuning is on and the
    operands can be timed) a timed sweep of ``run(block)`` over the
    roofline-admissible candidates, else ``default``."""
    hit = lookup(problem_key(name, args), candidates)
    if hit is not None:
        return hit
    if tune is None:
        tune = autotune_enabled()
    if not tune or _untimeable(args):
        return tuple(default)
    _, admissible = roofline_plan(candidates, default, args, chip=chip, geometry=geometry)
    device = _first_tensor(args).device
    # on the card 20 back-to-back calls a candidate: three calls of a
    # microsecond kernel time the host's launches more than the kernel
    best, timings = sweep(run, admissible, reps=20 if device.type == "cuda" else 3,
                          device=device)
    if best is None:
        return tuple(default)
    record(problem_key(name, args), best, timings)
    return best
