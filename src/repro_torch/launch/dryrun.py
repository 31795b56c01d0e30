"""Dry run of every cell at production scale, without the cluster (torch
port of ``repro.launch.dryrun``).

For each (arch x shape x mesh) cell the process joins torch's ``fake``
process group as rank 0 of the mesh's ranks (256 or 512; 4 or 8 with
``--smoke``), builds the production mesh with ``launch/mesh.py``, places
the model (``sharding.place_model`` for a prefill or serve step under
``serve_rules``; ``sharding.place_train_state`` for a train step under
``train_rules``: float32 masters and AdamW's m and v, FSDP x TP x EP) and
runs one step inside ``FakeTensorMode`` on fake ``cuda`` tensors (fake
``cpu`` tensors under ``dispatch.fake_cpu_kernel_route`` on a torch built
without CUDA), so every kernel wrapper takes its kernel route (allocating
its outputs and counting its launch, calling no library) and every
collective is the fake group's no-op.  The step (a train step's backward,
its layers' FSDP gathers and gradient reduce-scatters, and the optimizer
included) is counted by ``launch/op_cost.py`` and its memory by torch's
``MemTracker``.  That
proves the sharding is coherent at 256/512 cards (the step runs), that it
fits (the peak), and gives the roofline's inputs against the H100 model
(``core/hw_model.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape decode_32k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --shape train_4k --mesh both --remat block
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --smoke --mesh both --out experiments/dryrun

A train cell takes ``--microbatches``, ``--remat`` (the config's own,
"block", unless named) and ``--seq-parallel`` (``train_rules(seq_parallel=
True)``: the residual stream's sequence over 'model' between blocks).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
import time
import traceback
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.shapes import (SHAPES, SMOKE_SHAPES, ShapeCase, cache_len_for,
                                        input_specs, shape_applies)
from repro_torch.core.hw_model import H100_SXM
from repro_torch.distributed.constraints import axis_rules, logical_to_spec
from repro_torch.distributed.sharding import (Sharding, _block, _param_gib, divisible_spec,
                                              local_tree, mesh_sizes, place_model,
                                              place_train_state, serve_rules, shardings_for,
                                              train_rules, zeros_tree)
from repro_torch.launch import op_cost
from repro_torch.launch.mesh import is_fake_group, make_mesh_for, make_production_mesh
from repro_torch.launch.steps import make_prefill_step, make_serve_step, make_train_step
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig

__all__ = ["LM_ARCHS", "lower_cell", "decode_hbm_estimate_gib", "main"]

LM_ARCHS = tuple(a for a in ARCH_IDS if a != "e2afs-fp16")

# the roofline's rates: the H100 model's (NVIDIA H100 SXM data sheet)
PEAK_FLOPS = H100_SXM.peak_flops  # bf16, dense, a card
HBM_BW = H100_SXM.hbm_bw  # bytes/s, a card
# NVLink 4 (NVIDIA H100 SXM data sheet): 900 GB/s a card to the other cards
# of its NVLink domain, 450 GB/s each way; the rate a card's collective bytes
# leave it.  A mesh wider than one NVLink domain also crosses the network,
# which this model does not tell apart.
LINK_BW = 450e9

# The quantized-KV policy's threshold: the reference quantizes the cache when
# bf16 cache + params would pass 14 GiB of a 16 GiB TPU v5e card; here the
# same 14/16 of the H100's 80 GB (74.5 GiB): 65.2 GiB.
HBM_GIB = 80e9 / 2**30
QUANTIZE_ABOVE_GIB = HBM_GIB * 14 / 16

def decode_hbm_estimate_gib(cfg, case: ShapeCase, mesh) -> float:
    """bf16 KV cache + bf16 params a device (the decode fit policy), on a
    ``DeviceMesh`` or a ``MeshShape``; the reference's
    ``_decode_hbm_estimate_gib``."""
    sizes = mesh_sizes(mesh)
    data = sizes.get("data", 1) * sizes.get("pod", 1)
    if "kv" in sizes:
        model = sizes["kv"] * sizes["qg"]
        kv_local = cfg.n_kv_heads / sizes["kv"]
    else:
        model = sizes["model"]
        kv_local = cfg.n_kv_heads / model if cfg.n_kv_heads % model == 0 else cfg.n_kv_heads
    b_local = max(1, case.global_batch // data)
    cache = 0.0
    for blk in cfg.blocks:
        if blk == "global":
            t = case.seq_len
        elif blk == "window":
            t = min(case.seq_len, cfg.window)
        else:
            continue  # state blocks are small
        cache += b_local * t * kv_local * cfg.d_head * 2 * 2
    return (cache + _param_gib(cfg) * 2**30 / model) / 2**30


def _join_fake_group(world: int) -> None:
    """Join torch's fake process group as rank 0 of ``world`` (once a
    process)."""
    if dist.is_initialized():
        if not is_fake_group():
            raise RuntimeError("the dry run needs torch's fake process group; this process "
                               f"already joined a {dist.get_backend()!r} group")
        if dist.get_world_size() < world:
            raise RuntimeError(f"the fake group has {dist.get_world_size()} ranks, the mesh "
                               f"needs {world}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _mesh(mesh_kind: str, *, smoke: bool, mesh_shape=None, device=None):
    if mesh_shape is not None:
        axes = ("pod", "data", "model") if len(mesh_shape) == 3 else ("data", "model")
        return make_mesh_for(mesh_shape, axes, device=device)
    if smoke:
        if mesh_kind == "multi":
            return make_mesh_for((2, 2, 2), ("pod", "data", "model"), device=device)
        return make_mesh_for((2, 2), ("data", "model"), device=device)
    return make_production_mesh(multi_pod=mesh_kind == "multi", device=device)


def _mesh_ranks(mesh_kind: str, smoke: bool, mesh_shape=None) -> int:
    if mesh_shape is not None:
        n = 1
        for s in mesh_shape:
            n *= int(s)
        return n
    return (8 if mesh_kind == "multi" else 4) if smoke else (512 if mesh_kind == "multi" else 256)


def _local_zeros(shape, dtype, axes, mesh, rules) -> torch.Tensor:
    """This rank's block of a zero tensor of global ``shape`` whose dims have
    logical ``axes`` (fake, under the caller's ``FakeTensorMode``)."""
    spec = divisible_spec(logical_to_spec(axes[:len(shape)], rules), tuple(shape), mesh)
    local = _block(tuple(shape), Sharding.of(mesh, spec))[1]
    return torch.zeros(local, dtype=dtype, device=mesh.device_type)


def _tensors(tree) -> list:
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _argument_bytes(model, tensors) -> int:
    """The bytes of a step's arguments as ``MemTracker`` counts them: each
    storage once, a CUDA one rounded up to the caching allocator's 512
    bytes (a CPU one, the dry run on a torch built without CUDA, is not:
    a difference of under 512 bytes a tensor)."""
    seen, total = set(), 0
    for t in [*model.parameters(), *model.buffers(), *tensors]:
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += -(-st.nbytes() // 512) * 512 if t.device.type == "cuda" else st.nbytes()
    return total


def _batch(cfg, case: ShapeCase, mesh, rules, microbatches: int = 1) -> dict:
    """This rank's block of each input of a train or prefill cell, zeros:
    the rows of each of the ``microbatches`` microbatches over the batch's
    axes (``sharding.place_batch``'s layout; the reference's
    ``_batch_shardings`` for one), each row's sequence whole (under
    sequence parallelism the train step splits it itself)."""
    out = {}
    for name, spec in input_specs(cfg, case).items():
        shape = (microbatches, spec.shape[0] // microbatches) + tuple(spec.shape[1:])
        block = _local_zeros(shape, spec.dtype, (None, "batch") + (None,) * (spec.ndim - 1),
                             mesh, rules)
        out[name] = block.reshape(-1, *block.shape[2:])
    return out


def lower_cell(arch: str, shape_name: str, mesh_kind: str, *, quantized_kv=None,
               sqrt_unit="e2afs", microbatches=1, seq_parallel=False, extra_overrides=None,
               smoke=False, attribute_top=0, case: Optional[ShapeCase] = None, mesh_shape=None,
               opt_cfg: Optional[AdamWConfig] = None) -> dict:
    """Run one cell's step on fake tensors; returns its record (a dict).

    ``quantized_kv=None`` is the policy: an int8 KV cache where the bf16
    cache and params would pass :data:`QUANTIZE_ABOVE_GIB` a card.
    ``smoke`` takes the smoke configs and shapes on a (2, 2 [, 2]) mesh.
    ``case`` replaces the named shape's case and ``mesh_shape`` the mesh
    (e.g. (1, 1), one rank), to hold a cell against a real step.  A train
    cell runs ``make_train_step(cfg, opt_cfg, microbatches=)`` under
    ``train_rules``, ``opt_cfg`` by default the reference's
    ``AdamWConfig(sqrt_unit=)`` (the unfused update), under
    ``train_rules(seq_parallel=)``."""
    # DTensor warns at each two-axis reduction of the (kv, qg) mesh; the
    # record counts them
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    if case is None:
        case = (SMOKE_SHAPES if smoke else SHAPES)[shape_name]
    getter = get_smoke_config if smoke else get_config
    cfg = getter(arch, sqrt_unit=sqrt_unit, **(extra_overrides or {}))
    skip = shape_applies(cfg, shape_name)
    if skip:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "status": skip}
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.kernels import dispatch

    _join_fake_group(_mesh_ranks(mesh_kind, smoke, mesh_shape))
    # a torch built without CUDA runs fake CPU tensors on the kernel route
    # (dispatch.fake_cpu_kernel_route): it can neither index nor
    # differentiate a fake CUDA tensor (ROADMAP C.45)
    fake_cpu = not torch.backends.cuda.is_built()
    device = "cpu" if fake_cpu else None
    mesh = _mesh(mesh_kind, smoke=smoke, mesh_shape=mesh_shape, device=device)
    t0 = time.time()
    rules = None
    if case.kind == "train":
        rules = train_rules(cfg, mesh, seq_parallel=seq_parallel)
    elif case.kind == "decode":
        # 'model' reshaped into (kv, qg) where kv_heads divides it: the cache
        # then stays kv-head-sharded from step to step
        model_size = mesh_sizes(mesh)["model"]
        kvh = cfg.n_kv_heads
        if (not smoke and mesh_shape is None and 1 < kvh < model_size
                and model_size % kvh == 0
                and any(b in ("global", "window") for b in cfg.blocks)):
            if mesh_kind == "multi":
                mesh = make_mesh_for((2, 16, kvh, model_size // kvh),
                                     ("pod", "data", "kv", "qg"), device=device)
            else:
                mesh = make_mesh_for((16, kvh, model_size // kvh), ("data", "kv", "qg"),
                                     device=device)
        seq_shard = case.global_batch < mesh_sizes(mesh)["data"]
        rules = serve_rules(cfg, mesh, seq_shard_kv=seq_shard)
        if quantized_kv is None:
            quantized_kv = decode_hbm_estimate_gib(cfg, case, mesh) > QUANTIZE_ABOVE_GIB
    else:
        rules = serve_rules(cfg, mesh)
    n_chips = mesh.size()

    meta_model = lm.LM(cfg, device=torch.device("meta"))
    route = dispatch.fake_cpu_kernel_route() if fake_cpu else contextlib.nullcontext()
    with FakeTensorMode(allow_non_fake_inputs=True), route:
        if case.kind == "train":
            model, opt_state = place_train_state(meta_model, cfg, mesh, rules)
            args = (model, opt_state, _batch(cfg, case, mesh, rules, microbatches))
            step = make_train_step(cfg, opt_cfg or AdamWConfig(sqrt_unit=sqrt_unit),
                                   microbatches=microbatches, mesh=mesh, rules=rules)
        elif case.kind == "prefill":
            model = place_model(meta_model, cfg, mesh, rules)
            args = (model, _batch(cfg, case, mesh, rules))
            step = make_prefill_step(cfg)
        else:
            model = place_model(meta_model, cfg, mesh, rules)
            clen = cache_len_for(cfg, case)
            cache_abs = lm.init_cache(cfg, case.global_batch, clen, quantized=quantized_kv,
                                      abstract=True)
            cache_sh = shardings_for(lm.cache_specs(cfg, quantized=quantized_kv), mesh, rules,
                                     cache_abs)
            cache = local_tree(zeros_tree(cache_abs, cache_sh))
            tokens = _local_zeros((case.global_batch, 1), torch.int32, ("batch", None), mesh,
                                  rules)
            with_cross = cfg.kind == "encdec"
            step = make_serve_step(cfg, with_cross=with_cross)
            args = (model, cache, tokens, clen - 1)
            if with_cross:
                xshape = (cfg.n_layers, case.global_batch, cfg.encoder.n_ctx, cfg.n_kv_heads,
                          cfg.d_head)
                args += ({k: _local_zeros(xshape, lm.act_dtype(cfg), axes, mesh, rules)
                          for k, axes in lm.cross_kv_specs().items()},)
        tracker = MemTracker()
        tracker.track_external(model, *_tensors(args[1:]))
        arg_bytes = _argument_bytes(model, _tensors(args[1:]))
        counts_before = dispatch.launch_counts()
        with axis_rules(mesh, rules), tracker, op_cost.counting(
                trace=attribute_top > 0, model=model) as cost:
            step(*args)
        launches = {k: n - counts_before[k] for k, n in dispatch.launch_counts().items()
                    if n != counts_before[k]}
        peak = max((snap.get("Total", 0) for snap in
                    tracker.get_tracker_snapshot("peak").values()), default=0)
    seconds = time.time() - t0

    colls = dict(cost.collectives)
    colls["total"] = {"count": sum(v["count"] for v in cost.collectives.values()),
                      "bytes": cost.collective_bytes}
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_kind,
        "status": "ok",
        "n_chips": n_chips,
        "chip": H100_SXM.name,
        "fake_device": mesh.device_type,
        "seconds": round(seconds, 1),
        # the peak counts the arguments (weights, cache, inputs); the step's
        # own is the rest
        "memory": {"peak_estimate_bytes": int(peak), "argument_bytes": arg_bytes,
                   "step_peak_bytes": int(peak) - arg_bytes},
        "flops_per_device": float(cost.flops),
        "bytes_per_device": float(cost.bytes),
        "collectives": colls,
        "launches": launches,
        "roofline": {
            "compute_s": cost.flops / PEAK_FLOPS,
            "memory_s": cost.bytes / HBM_BW,
            "collective_s": cost.collective_bytes / LINK_BW,
        },
        "quantized_kv": quantized_kv,
        # the train step's options (the serving steps have neither)
        "microbatches": microbatches if case.kind == "train" else 1,
        "seq_parallel": bool(seq_parallel) and case.kind == "train",
        "remat": cfg.remat,
    }
    if attribute_top:
        from repro_torch.launch.attribution import attribute

        rec["top_bytes"], rec["top_flops"] = attribute(cost, top=attribute_top)
    rec["roofline"]["dominant"] = max(rec["roofline"], key=rec["roofline"].get)
    return rec


def main(argv=None):
    """CLI over :func:`lower_cell`: one JSON record a cell in ``--out``
    (a cell whose file exists is skipped; delete it to run again).
    ``--arch`` and ``--shape`` take one or more names; ``--all`` takes every
    LM arch (and every shape unless ``--shape`` names some)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", choices=LM_ARCHS)
    ap.add_argument("--shape", nargs="+", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"), default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--quantized-kv", default=None,
                    type=lambda s: {"true": True, "false": False}[s.lower()],
                    help="force the int8 KV cache on or off; default: the fit policy")
    ap.add_argument("--sqrt-unit", default="e2afs")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="a train cell's gradient-accumulation steps")
    ap.add_argument("--seq-parallel", action="store_true",
                    help="a train cell's sequence parallelism ('seq' over 'model' between "
                         "blocks)")
    ap.add_argument("--remat", default=None, choices=("none", "block", "minimal"),
                    help="a train cell's remat; default: the config's")
    ap.add_argument("--smoke", action="store_true", help="smoke configs on a 2x2[x2] mesh")
    ap.add_argument("--attribute", type=int, default=0, metavar="N",
                    help="record the top-N ops by bytes and by flops in the JSON")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("name --arch and --shape, or --all")

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    archs = LM_ARCHS if args.all else tuple(args.arch)
    shapes = tuple(args.shape) if args.shape else tuple(SHAPES)
    # one fake group for the process, as wide as its widest mesh
    _join_fake_group(max(_mesh_ranks(m, args.smoke) for m in meshes))

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                tag = f"{arch}_{shape}_{mesh_kind}" + ("_qkv" if args.quantized_kv is True else "")
                if args.seq_parallel and SHAPES[shape].kind == "train":
                    tag += "_sp"
                if args.tag:
                    tag += f"_{args.tag}"
                path = outdir / f"{tag}.json"
                if path.exists():
                    print(f"[skip-cached] {tag}")
                    continue
                try:
                    rec = lower_cell(arch, shape, mesh_kind, quantized_kv=args.quantized_kv,
                                     sqrt_unit=args.sqrt_unit, microbatches=args.microbatches,
                                     seq_parallel=args.seq_parallel, smoke=args.smoke,
                                     attribute_top=args.attribute,
                                     extra_overrides={"remat": args.remat} if args.remat
                                     else None)
                except Exception as e:  # noqa: BLE001 -- record the failure and go on
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "status": f"FAIL: {type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                    failures += 1
                path.write_text(json.dumps(rec, indent=2))
                status = rec["status"]
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    extra = (f" seconds={rec['seconds']}"
                             f" peak={rec['memory']['peak_estimate_bytes']} dom={r['dominant']} c={r['compute_s']:.6f} m={r['memory_s']:.6f}"
                             f" x={r['collective_s']:.6f}")
                print(f"[{status[:60]}] {tag}{extra}", flush=True)
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
