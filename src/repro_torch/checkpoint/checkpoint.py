"""Checkpoints with atomic commit and an async writer (torch port of
``repro.checkpoint.checkpoint``), in the reference's on-disk format, so a
step written by either package restores in the other.

Format: one directory per step holding one ``.npy`` per leaf of a tree of
nested dicts and lists (keys sorted, list entries by index, the leaf named
by its joined key path, as the reference's tree flattening names it, e.g.
``params_layers_3_attn_wq``) and ``manifest.json``.  Writes go to
``<dir>/tmp-<step>``, renamed to ``<dir>/step-<step>`` only after the
manifest lands, so a crashed writer never leaves a half-readable step.
bfloat16 leaves are stored as 2-byte void records (numpy has no bfloat16)
and reinterpreted against the restore target's dtype.

Leaves are torch tensors (any device), numpy arrays or Python scalars.
:func:`restore` gives each leaf the kind, dtype and device of the matching
leaf of its target.

On a mesh (one process a rank): :func:`save` of a tree that holds DTensors
gathers each such leaf whole on every rank (a collective, in leaf order),
rank 0 alone writes the step, and every rank waits at a barrier until it is
committed, so the files are the full leaves under the reference's names
and either package restores them.  :func:`restore` with ``shardings=`` (a
matching tree of ``distributed.sharding.Sharding``) reads each leaf on the
host and places it: every rank keeps its own block, as a DTensor (elastic
resharding: a step written on one mesh shape restores onto another, or
onto none).

Failure hygiene:

* a torn or corrupt step surfaces as :class:`CheckpointError` naming the
  missing or unreadable leaf file;
* ``save`` and ``latest_step`` sweep stale ``tmp-<step>`` directories left
  by a crashed writer (live in-process async writers are exempt);
* async writer errors are captured and re-raised by :func:`wait_pending`
  (the first one wins).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "save",
    "save_async",
    "restore",
    "latest_step",
    "wait_pending",
    "CheckpointError",
]


class CheckpointError(RuntimeError):
    """A checkpoint could not be written or read back; the message names the
    step directory and the leaf file."""


class _Writer:
    """One in-flight async save: the thread, its target (dir, step), so the
    stale-tmp sweep can exempt it, and the error its thread parks."""

    __slots__ = ("thread", "dir", "step", "error")

    def __init__(self, ckpt_dir, step: int):
        self.dir = Path(ckpt_dir).resolve()
        self.step = step
        self.thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None


_pending_lock = threading.Lock()
_pending: list = []


def _flatten(tree, prefix=()):
    """[(path tuple, leaf)] of nested dicts and lists in the reference's
    order (keys sorted, list entries by index, named by it)."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in _flatten(tree[k], prefix + (str(k),))]
    if isinstance(tree, list):
        return [item for i, node in enumerate(tree) for item in _flatten(node, prefix + (str(i),))]
    return [(prefix, tree)]


def _unflatten(like, leaves):
    """Rebuild ``like``'s nested dicts and lists from leaves in
    :func:`_flatten` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [build(n) for n in node]
        return next(it)

    return build(like)


def _is_dtensor(x) -> bool:
    if not (isinstance(x, torch.Tensor) and dist.is_available()):
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _sharded(tree) -> bool:
    """Whether ``tree`` holds DTensors: a mesh's ranks save it together,
    and rank 0 alone writes."""
    return any(_is_dtensor(leaf) for _, leaf in _flatten(tree))


def _to_host(x) -> tuple:
    """(numpy array, manifest dtype name) of one leaf, copied off the
    device (a DTensor gathered whole first); bfloat16 as 2-byte void
    records."""
    if _is_dtensor(x):
        from repro_torch.distributed.sharding import full_tensor

        x = full_tensor(x)
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.array(x)
    return arr, str(arr.dtype)


def _host_items(tree):
    return [("_".join(path), *_to_host(leaf)) for path, leaf in _flatten(tree)]


def _live_tmp_steps(ckpt_dir: Path) -> set:
    d = Path(ckpt_dir).resolve()
    with _pending_lock:
        return {w.step for w in _pending
                if w.dir == d and w.thread is not None and w.thread.is_alive()}


def _sweep_stale_tmp(ckpt_dir) -> None:
    """Remove ``tmp-<step>`` directories of crashed writers; a live
    in-process writer's is left alone."""
    d = Path(ckpt_dir)
    if not d.exists():
        return
    live = _live_tmp_steps(d)
    for p in d.iterdir():
        if not (p.is_dir() and p.name.startswith("tmp-")):
            continue
        try:
            step = int(p.name.split("-", 1)[1])
        except ValueError:
            continue
        if step not in live:
            shutil.rmtree(p, ignore_errors=True)


def _write_step(ckpt_dir: Path, step: int, host_items) -> Path:
    """Leaves and manifest into ``tmp-<step>``, then one atomic rename to
    ``step-<step>``.  An existing step is left as it is."""
    tmp = ckpt_dir / f"tmp-{step}"
    final = ckpt_dir / f"step-{step}"
    if final.exists():
        return final
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "leaves": []}
    for name, arr, dtype in host_items:
        fname = f"{name}.npy"
        np.save(tmp / fname, arr)
        manifest["leaves"].append(
            {"name": name, "file": fname, "shape": list(arr.shape), "dtype": dtype})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    os.replace(tmp, final)  # atomic commit
    return final


def save(ckpt_dir, step: int, tree) -> Path:
    """Synchronous atomic save.  Returns the committed directory.  A tree
    holding DTensors is saved by every rank of its mesh together (see the
    module docstring)."""
    ckpt_dir = Path(ckpt_dir)
    sharded = _sharded(tree)
    items = _host_items(tree)
    path = ckpt_dir / f"step-{step}"
    if not sharded or dist.get_rank() == 0:
        _sweep_stale_tmp(ckpt_dir)
        path = _write_step(ckpt_dir, step, items)
    if sharded:
        dist.barrier()
    return path


def save_async(ckpt_dir, step: int, tree) -> threading.Thread:
    """Save off the training path: the tree is copied to the host now, the
    files are written by a daemon thread.  :func:`wait_pending` joins the
    writers and re-raises the first writer error.  A tree holding DTensors
    is gathered by every rank of its mesh; rank 0's thread writes it (no
    barrier: the other ranks do not wait for the files)."""
    host_items = _host_items(tree)
    if _sharded(tree) and dist.get_rank() != 0:
        host_items = None
    w = _Writer(ckpt_dir, step)

    def _write():
        if host_items is None:
            return
        try:
            _write_step(Path(ckpt_dir), step, host_items)
        except BaseException as e:  # parked for wait_pending, never swallowed
            w.error = e

    t = threading.Thread(target=_write, daemon=True)
    w.thread = t
    with _pending_lock:
        # drop writers that finished cleanly; errored ones stay until reported
        _pending[:] = [p for p in _pending if p.thread.is_alive() or p.error is not None]
        _pending.append(w)
    t.start()
    return t


def wait_pending() -> None:
    """Join every outstanding async writer; raise :class:`CheckpointError`
    for the first that failed (after joining them all)."""
    with _pending_lock:
        writers, _pending[:] = _pending[:], []
    first: Optional[_Writer] = None
    for w in writers:
        w.thread.join()
        if first is None and w.error is not None:
            first = w
    if first is not None:
        raise CheckpointError(
            f"async checkpoint writer for step {first.step} under {first.dir} failed: "
            f"{type(first.error).__name__}: {first.error}") from first.error


def latest_step(ckpt_dir) -> Optional[int]:
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    _sweep_stale_tmp(d)
    steps = [int(p.name.split("-", 1)[1]) for p in d.iterdir()
             if p.name.startswith("step-") and (p / "manifest.json").exists()]
    return max(steps) if steps else None


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return np.dtype(dtype).itemsize


def _as_like(arr: np.ndarray, like, device=None):
    """``arr`` with the kind, dtype and device (or ``device``) of
    ``like``."""
    if isinstance(like, torch.Tensor):
        device = like.device if device is None else device
        if arr.dtype.kind == "V":  # raw records: reinterpret through an integer view
            t = torch.from_numpy(arr.view(f"i{arr.dtype.itemsize}").copy())
            return t.view(like.dtype).to(device)
        return torch.from_numpy(np.array(arr)).to(device, like.dtype)
    if arr.dtype.kind == "V":
        return arr.view(np.dtype(like.dtype))
    return np.asarray(arr).astype(np.dtype(like.dtype))


def restore(ckpt_dir, step: int, like_tree, shardings=None):
    """Restore into the structure of ``like_tree`` (tensors, DTensors, meta
    tensors or arrays; only their shapes and dtypes are read).  Leaves
    present in the checkpoint but absent from ``like_tree`` are ignored; a
    leaf ``like_tree`` expects that is missing, unreadable or mis-shaped
    raises :class:`CheckpointError` naming it.

    ``shardings``: a matching tree of ``distributed.sharding.Sharding``;
    each leaf is read whole on the host and placed on its mesh and
    placements, this rank keeping its block (a DTensor on the mesh's
    device).  None gives each leaf ``like``'s device."""
    sh_leaves = None
    if shardings is not None:
        from repro_torch.distributed.sharding import Sharding, place

        sh_leaves = []
        for path, sh in _flatten(shardings):
            if not isinstance(sh, Sharding):
                raise TypeError(f"restore(shardings=): leaf '{'_'.join(path)}' is "
                                f"{type(sh).__name__}, not a distributed.sharding.Sharding")
            sh_leaves.append(sh)
    final = Path(ckpt_dir) / f"step-{step}"
    man_path = final / "manifest.json"
    if not man_path.exists():
        raise CheckpointError(
            f"no committed checkpoint at {final} (manifest.json missing); latest committed "
            f"step under {ckpt_dir} is {latest_step(ckpt_dir)!r}")
    try:
        manifest = json.loads(man_path.read_text())
    except (json.JSONDecodeError, OSError) as e:
        raise CheckpointError(f"corrupt checkpoint manifest {man_path}: {e}") from e
    by_name = {leaf["name"]: leaf for leaf in manifest["leaves"]}

    leaves = []
    for i, (path, like) in enumerate(_flatten(like_tree)):
        name = "_".join(path)
        entry = by_name.get(name)
        if entry is None:
            raise CheckpointError(
                f"checkpoint {final} has no leaf '{name}' expected by the restore target "
                f"(manifest holds {sorted(by_name)[:8]}...)")
        fpath = final / entry["file"]
        try:
            arr = np.load(fpath)
        except FileNotFoundError as e:
            raise CheckpointError(f"checkpoint {final} is torn: leaf file '{entry['file']}' "
                                  f"(leaf '{name}') is missing") from e
        except (ValueError, OSError, EOFError) as e:
            raise CheckpointError(f"checkpoint {final} is torn: leaf file '{entry['file']}' "
                                  f"(leaf '{name}') is unreadable: {e}") from e
        if arr.dtype.kind == "V" and arr.dtype.itemsize != _itemsize(like.dtype):
            raise CheckpointError(
                f"checkpoint {final} leaf '{name}': stored itemsize {arr.dtype.itemsize} does "
                f"not match restore target dtype {like.dtype}")
        if tuple(arr.shape) != tuple(like.shape):
            raise CheckpointError(f"checkpoint {final} leaf '{name}': shape {tuple(arr.shape)} "
                                  f"does not match restore target {tuple(like.shape)}")
        if sh_leaves is None:
            leaves.append(_as_like(arr, like))
        else:
            leaves.append(place(_as_like(arr, like, device="cpu"), sh_leaves[i]))
    return _unflatten(like_tree, leaves)
