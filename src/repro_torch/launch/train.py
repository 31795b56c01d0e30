"""Training launcher (torch port of ``repro.launch.train``): checkpoint and
resume, a heartbeat with a straggler deadline, optional int8 gradient
compression and microbatching.

  * atomic checkpoints every ``ckpt_every`` steps (async writer), in the
    reference's format and tree layout (layers stacked, or a list of
    layers for a mixed model), so a step written by either package
    restores in the other;
  * on start, resumes from the latest complete checkpoint (crash = rerun);
  * a per-step wall-time heartbeat; a step over ``step_deadline`` (or the
    step ``inject_straggler_at``) is a straggler event and checkpoints at
    once;
  * batches derive from (seed, step), so a resumed run replays the stream.

Usage (on the card unless ``--device cpu``):
  PYTHONPATH=src python -m repro_torch.launch.train --steps 20 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 5
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from repro_torch import checkpoint as ckpt_lib
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm
from repro_torch.models.convert import named_to_tree, tree_to_named
from repro_torch.optim import AdamWConfig, adamw_init, compress_init

__all__ = ["build", "train_loop", "main"]


def build(arch: str, *, smoke: bool, seq: int, batch: int, sqrt_unit: str, microbatches: int,
          compress: bool, opt_overrides=None, device=None):
    """Assemble one training run on ``device`` (the card unless "cpu"): the
    config, a model of float32 masters drawn from seed 0, the optimizer
    state, the train step and a synthetic data source.  Returns
    ``(cfg, model, opt_state, step_fn, data)``."""
    dev = resolve_device(device)
    cfg = (get_smoke_config if smoke else get_config)(arch, sqrt_unit=sqrt_unit)
    model = lm.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev, trainable=True)
    opt_cfg = AdamWConfig(sqrt_unit=sqrt_unit, **(opt_overrides or {}))
    opt_state = adamw_init(model)
    if compress:
        opt_state["residual"] = compress_init(model)
    step_fn = make_train_step(cfg, opt_cfg, compress_grads=compress, microbatches=microbatches)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch))
    return cfg, model, opt_state, step_fn, data


def state_tree(model, opt_state) -> dict:
    """``{"params", "opt": {"m", "v", "step"[, "residual"]}}`` as host numpy
    arrays in the reference's layout (the trainer's checkpoint): layers
    stacked for a uniform model, a list of layers for a mixed one."""
    n = len(model.layers)

    def tree(named):
        return named_to_tree(named, n, stacked=model.stacked)

    opt = {k: (v.detach().to("cpu", copy=True).numpy() if k == "step" else tree(v))
           for k, v in opt_state.items()}
    return {"params": tree(dict(model.named_parameters())), "opt": opt}


@torch.no_grad()
def load_state(model, opt_state, tree) -> None:
    """Copy a restored :func:`state_tree` back into the model and the
    optimizer state, in place."""
    params = dict(model.named_parameters())
    for name, a in tree_to_named(tree["params"], params).items():
        params[name].copy_(torch.as_tensor(a))
    for key, value in tree["opt"].items():
        if key == "step":
            opt_state["step"] = torch.as_tensor(value).to(opt_state["step"].device)
            continue
        for name, a in tree_to_named(value, opt_state[key]).items():
            opt_state[key][name].copy_(torch.as_tensor(a))


def train_loop(arch="qwen3-4b", *, smoke=True, steps=20, seq=64, batch=4, sqrt_unit="e2afs",
               ckpt_dir=None, ckpt_every=10, microbatches=1, compress=False, step_deadline=None,
               log_every=5, inject_straggler_at=None, lr=None, abort_after=None, device=None):
    """Run ``steps`` of training end to end on synthetic LM data, with the
    sqrt unit live in every norm and in the optimizer.  Optional: periodic
    async checkpoints to ``ckpt_dir`` with resume from the latest, a
    wall-clock ``step_deadline`` (``inject_straggler_at`` simulates a
    straggler), gradient compression, microbatching and ``abort_after``
    (a simulated crash: no final checkpoint).  Returns
    ``(model, opt_state, losses)``."""
    opt_overrides = {
        "lr": lr if lr is not None else (3e-3 if smoke else 3e-4),
        "warmup_steps": max(2, steps // 10),
        "total_steps": steps,
    }
    cfg, model, opt_state, step_fn, data = build(
        arch, smoke=smoke, seq=seq, batch=batch, sqrt_unit=sqrt_unit, microbatches=microbatches,
        compress=compress, opt_overrides=opt_overrides, device=device)
    dev = model.embed.device

    start = 0
    if ckpt_dir:
        latest = ckpt_lib.latest_step(ckpt_dir)
        if latest is not None:
            like = state_tree(model, opt_state)
            load_state(model, opt_state, ckpt_lib.restore(ckpt_dir, latest, like))
            start = latest
            print(f"[restore] resumed from step {latest}")

    heartbeat, losses = [], []
    for step in range(start, steps):
        batch_t = {k: torch.from_numpy(v).to(dev) for k, v in data.batch(step).items()}
        t0 = time.time()
        model, opt_state, metrics = step_fn(model, opt_state, batch_t)
        loss = float(metrics["loss"])  # waits for the step
        dt = time.time() - t0
        heartbeat.append({"step": step, "wall_s": dt, "loss": loss})
        losses.append(loss)

        straggled = (step_deadline and dt > step_deadline) or (
            inject_straggler_at is not None and step == inject_straggler_at)
        if straggled:
            print(f"[straggler] step {step} took {dt:.2f}s > deadline; checkpointing")
            if ckpt_dir:
                ckpt_lib.save(ckpt_dir, step + 1, state_tree(model, opt_state))
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            ckpt_lib.save_async(ckpt_dir, step + 1, state_tree(model, opt_state))
        if (step + 1) % log_every == 0:
            print(f"  step {step + 1:5d} loss {loss:.4f} ({dt * 1e3:.0f} ms)")
        if abort_after is not None and step + 1 >= abort_after:
            # simulated crash: no final checkpoint beyond what ckpt_every wrote
            ckpt_lib.wait_pending()
            return model, opt_state, losses

    ckpt_lib.wait_pending()
    if ckpt_dir:
        ckpt_lib.save(ckpt_dir, steps, state_tree(model, opt_state))
        Path(ckpt_dir, "heartbeat.json").write_text(json.dumps(heartbeat))
    return model, opt_state, losses


def main(argv=None):
    """CLI over :func:`train_loop`:
    ``python -m repro_torch.launch.train [--device cpu] [--steps N] ...``"""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--sqrt-unit", default="e2afs")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--step-deadline", type=float, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    _, _, losses = train_loop(
        args.arch, smoke=args.smoke, steps=args.steps, seq=args.seq, batch=args.batch,
        sqrt_unit=args.sqrt_unit, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        microbatches=args.microbatches, compress=args.compress_grads,
        step_deadline=args.step_deadline, device=args.device)
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")


if __name__ == "__main__":
    main()
