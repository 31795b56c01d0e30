"""Eager decode milliseconds a step of the PyTorch port on the card, at the
shapes of ``chip_smoke.py``'s phases 4a and 4d, to compare two trees of the
repository in one run on one card.

* qwen3-4b, full width: batch 8, a 512-token prompt, 64 new tokens;
* gemma3-1b, full width: batch 8, a 2048-token prompt, 64 new tokens.

Each model is initialised from seed 0 on the card, its prompt drawn from
seed 1; one warm-up generation of 2 tokens, then ``--repeats`` timed
generations (``lm.prefill`` then ``lm.generate_scan``, the host clock with
a synchronize, as phase 4a times them).  Also the host microseconds a
call of the RMSNorm wrapper at a decode step's (8, 2560) bfloat16 rows
(``--calls`` back-to-back calls after a warm-up, one synchronize at the
end: the kernel takes about 2 us on the card, so the host's wrapper sets
the pace).  Prints the card's name and power limit, then one JSON line:
``{"src": ..., "rmsnorm_call_us": [...], "qwen3-4b": [ms a step, ...],
"gemma3-1b": [...], "gc_ms": {arch: [ms of garbage collection a step,
...]}}`` (``gc.callbacks`` around each collection in the timed runs).

``--profile N`` instead runs N decode steps of qwen3-4b under cProfile and
prints the host functions that took the most time.

Usage (a parent tree unpacked into a directory .gitignore lists):
  python tools/torch_eager_step_ms.py                      # this checkout
  python tools/torch_eager_step_ms.py --src .chip_scratch/parent/src
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CASES = {"qwen3-4b": (8, 512, 64), "gemma3-1b": (8, 2048, 64)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--calls", type=int, default=20000)
    ap.add_argument("--profile", type=int, default=0, metavar="N")
    ap.add_argument("--arch", nargs="+", choices=tuple(CASES), default=tuple(CASES))
    args = ap.parse_args(argv)
    src = Path(args.src).resolve()
    if not (src / "repro_torch").is_dir():
        print(f"error: no repro_torch under {src}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0] if card.strip() else torch.cuda.get_device_name(0))
    out = {"src": str(src)}
    if args.profile:
        return _profile(torch, lm, get_config, dev, args.profile)
    from repro_torch.kernels.rmsnorm.ops import rmsnorm

    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((8, 2560), generator=g, device=dev).to(torch.bfloat16)
    scale = (torch.randn((2560,), generator=g, device=dev) * 0.1).to(torch.bfloat16)
    out["rmsnorm_call_us"] = []
    for _ in range(args.repeats + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.calls):
            rmsnorm(x, scale)
        torch.cuda.synchronize()
        out["rmsnorm_call_us"].append((time.perf_counter() - t0) / args.calls * 1e6)
    out["rmsnorm_call_us"] = out["rmsnorm_call_us"][1:]  # the first warms up
    gc_s = [0.0]
    started = []

    def on_gc(phase, info):
        if phase == "start":
            started.append(time.perf_counter())
        elif started:
            gc_s[0] += time.perf_counter() - started.pop()

    gc.callbacks.append(on_gc)
    out["gc_ms"] = {}
    for arch in args.arch:
        batch, prompt_len, gen_len = CASES[arch]
        cfg = get_config(arch, sqrt_unit="e2afs", decode_kernel="fused")
        model = lm.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        prompt = torch.randint(0, cfg.vocab, (batch, prompt_len),
                               generator=torch.Generator(device=dev).manual_seed(1), device=dev)

        def run(n):
            cache = lm.init_cache(cfg, batch, prompt_len + gen_len, device=dev)
            logits, cache = lm.prefill(model, cfg, cache, prompt, last_logit_only=True)
            torch.cuda.synchronize()
            gc_s[0] = 0.0
            t0 = time.perf_counter()
            lm.generate_scan(model, cfg, cache, logits[:, -1:].argmax(-1), prompt_len, n)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / n * 1e3, gc_s[0] / n * 1e3

        run(2)  # warm-up: builds, handles, allocator
        out[arch], out["gc_ms"][arch] = [], []
        for _ in range(args.repeats):
            ms, gc_ms = run(gen_len)
            out[arch].append(ms)
            out["gc_ms"][arch].append(gc_ms)
        del model
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


def _profile(torch, lm, get_config, dev, steps: int) -> int:
    import cProfile
    import pstats

    batch, prompt_len, _ = CASES["qwen3-4b"]
    cfg = get_config("qwen3-4b", sqrt_unit="e2afs", decode_kernel="fused")
    model = lm.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len),
                           generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    cache = lm.init_cache(cfg, batch, prompt_len + 2 * steps + 2, device=dev)
    logits, cache = lm.prefill(model, cfg, cache, prompt, last_logit_only=True)
    tok = logits[:, -1:].argmax(-1)
    lm.generate_scan(model, cfg, cache, tok, prompt_len, 2)  # warm-up
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    lm.generate_scan(model, cfg, cache, tok, prompt_len + 2, steps)
    torch.cuda.synchronize()
    prof.disable()
    pstats.Stats(prof).sort_stats("tottime").print_stats(25)
    return 0


if __name__ == "__main__":
    sys.exit(main())
