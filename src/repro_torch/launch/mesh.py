"""Production mesh builders (torch port of ``repro.launch.mesh``; functions,
not module constants: importing this module touches no process group).

A mesh is a ``torch.distributed`` ``DeviceMesh`` over the ranks of the
process group the launcher set up: ``torchrun --nproc-per-node N`` (one
process a card, ``LOCAL_RANK`` naming it), a test's spawned workers, or,
when the mesh holds one device and no group exists yet, a one-rank group
that the builder starts itself.  On the card each rank takes
``cuda:LOCAL_RANK`` (NCCL), on the CPU it runs gloo.  Every rank runs the
same program on its own block of each tensor (see
``distributed/constraints.py``).  In a process that joined torch's ``fake``
process group (the dry run, ``launch/dryrun.py``) the mesh is a "cuda" mesh
for fake tensors: no card is opened and no rank is set.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

__all__ = ["make_production_mesh", "make_mesh_for", "is_fake_group"]


def is_fake_group() -> bool:
    """True in a process that joined torch's ``fake`` process group (every
    collective a no-op, for lowering on fake tensors)."""
    return dist.is_initialized() and dist.get_backend() == "fake"


def make_production_mesh(*, multi_pod: bool = False, shape: Optional[Tuple[int, ...]] = None,
                         axes: Optional[Sequence[str]] = None, device=None):
    """Build the serving/training device mesh.

    Defaults are the production topologies: single pod ``(data=16,
    model=16)`` = 256 devices, or ``multi_pod`` ``(pod=2, data=16,
    model=16)`` = 512.  ``shape=`` overrides the topology (e.g.
    ``shape=(2, 2)`` for the test mesh on 4 ranks, ``(1, 1)`` for one card)
    while keeping the standard axis names; pass ``axes=`` only when the
    override needs other names (len(axes) must equal len(shape)).
    ``device``: the card unless ``device="cpu"``.

    Raises a RuntimeError naming the world size needed when the process
    group has too few ranks."""
    if shape is None:
        shape = (2, 16, 16) if multi_pod else (16, 16)
    if axes is None:
        axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    if len(axes) != len(shape):
        raise ValueError(f"axes {axes} must match shape {shape} rank")
    return make_mesh_for(shape, axes, device=device)


def _start_one_rank_group(dev: torch.device) -> None:
    """A process group of this process alone (an in-process store, no
    network): the one-device mesh's, on the current card."""
    if dev.type == "cuda":
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                                device_id=torch.device("cuda", torch.cuda.current_device()))
    else:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)


def make_mesh_for(shape, axes, *, device=None):
    """A mesh of the first ``prod(shape)`` ranks, reshaped to ``shape`` with
    axis names ``axes``: the raw builder behind
    :func:`make_production_mesh`."""
    from torch.distributed.device_mesh import DeviceMesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    n = int(np.prod(shape))
    if is_fake_group():  # fake cuda tensors unless a device is named
        if dist.get_world_size() < n:
            raise RuntimeError(f"mesh {shape} needs {n} ranks, the fake group has "
                               f"{dist.get_world_size()}")
        kind = "cuda" if device is None else torch.device(device).type
        return DeviceMesh(kind, torch.arange(n).reshape(shape), mesh_dim_names=axes)
    dev = resolve_device(device)
    if not dist.is_initialized() and n != 1:
        raise RuntimeError(
            f"mesh {shape} needs a process group of {n} ranks (world size {n}), have none: "
            f"launch with `torchrun --nproc-per-node {n}` (one process a device) or "
            f"init_process_group(world_size={n}) in each rank first")
    if dev.type == "cuda":  # this rank's card
        rank = dist.get_rank() if dist.is_initialized() else 0
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK",
                                                 rank % torch.cuda.device_count())))
    if not dist.is_initialized():
        _start_one_rank_group(dev)
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks (world size {n}), have world size {world}: "
            f"launch with `torchrun --nproc-per-node {n}`")
    return DeviceMesh(dev.type, torch.arange(n).reshape(shape), mesh_dim_names=axes)
