"""Serving driver: one-shot batched prefill + greedy decode (torch port of
``repro.launch.serve``).

The fast path (``mode="scan"``) runs :func:`lm.prefill` over the whole prompt
and :func:`lm.generate_scan` for the decode, with the argmax on the device
and no host synchronisation per token.  The per-token loop (``mode="loop"``)
is the correctness baseline: it teacher-forces the prompt one decode step at
a time and reads each argmax back to the host.

Runs on the card unless ``device="cpu"``; the weights are random, drawn from
a generator seeded with 0, and the prompt from one seeded with ``seed``.
Every id of ``repro_torch.configs.ARCH_IDS`` serves (internvl2-76b through
its text path: prefill and decode take tokens only, as in the reference).
A mixture-of-experts prefill routes the prompt as one group a row, so its
drops can differ from the loop's, which routes a token at a time: the
stats' ``token_exact_vs_loop`` is False for such a model, as in the
reference.

An encoder-decoder (whisper-small) serves with audio: random frames (b,
n_ctx, d) drawn from a generator seeded with ``seed + 1`` go through the
encoder (:func:`lm.precompute_cross`, inside the timed prefill) and every
decode step attends to them.

``mesh=`` (a ``launch.mesh`` DeviceMesh; every rank of it calls
:func:`generate` alike) serves the scan path sharded by ``rules=``, every
model id, whisper-small's audio included (each rank's rows of it).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import lm

__all__ = ["MODES", "decode_loop", "generate", "main", "prefill_loop"]

MODES = ("scan", "loop")


def prefill_loop(decode, params, cache, prompt):
    """Baseline prefill: teacher-force the prompt one decode step at a time.
    ``decode(params, cache, tokens, pos) -> (logits, cache)``.  Returns
    (last logits, cache)."""
    logits = None
    for i in range(prompt.shape[1]):
        logits, cache = decode(params, cache, prompt[:, i : i + 1], i)
    return logits, cache


def decode_loop(decode, params, cache, tok, start, gen_len):
    """Baseline decode: a per-token loop with one host round-trip of the
    argmax per generated token.  Returns (tokens (b, gen_len), cache)."""
    out = []
    for i in range(gen_len):
        out.append(tok)
        logits, cache = decode(params, cache, tok, start + i)
        tok = torch.as_tensor(logits[:, -1:].argmax(dim=-1).cpu().numpy(), device=tok.device)
    return torch.cat(out, dim=1), cache


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(arch="qwen3-4b", *, batch=2, prompt_len=8, gen_len=16, sqrt_unit="e2afs",
             quantized_kv=False, seed=0, mode="scan", reps=3, verbose=True, mesh=None,
             rules=None, device=None):
    """Prefill a random prompt and greedily decode ``gen_len`` tokens at the
    smoke config of ``arch``.

    One untimed pass warms up (builds and loads the kernels on the card);
    then ``reps`` timed passes run, each on a fresh cache allocated before
    the clock starts, and the best is kept.  Returns (tokens (b, prompt +
    gen) as a CPU tensor, stats dict).

    ``mesh=`` runs the scan path sharded: the weights, the prompt and the
    cache are placed by ``rules`` (default ``serve_rules(cfg, mesh)``, tensor
    parallel; ``serve_rules(cfg, mesh, replicate_params=True)`` is the
    exact mode, each rank decoding its block of the batch) before the clock
    starts, prefill and decode run inside the rule scope, and every rank
    returns the whole batch's tokens.  Scan mode only."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mesh is not None and mode != "scan":
        raise ValueError("mesh serving is only wired into mode='scan'")
    if prompt_len < 1:
        raise ValueError(
            f"prompt_len must be >= 1 (got {prompt_len}): prefill needs at "
            f"least one prompt token to produce first-step logits"
        )
    dev = resolve_device(device)
    cfg = get_smoke_config(arch, sqrt_unit=sqrt_unit)
    token_exact = cfg.moe is None
    if mode == "scan" and not token_exact and verbose:
        print(f"[serve] note: {arch} is MoE: prefill routing is not token-exact vs "
              f"mode='loop' (capacity is per prompt)")
    model = lm.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len),
                           generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
    audio = None
    if cfg.kind == "encdec":
        audio = torch.randn((batch, cfg.encoder.n_ctx, cfg.d_model),
                            generator=torch.Generator(device=dev).manual_seed(seed + 1),
                            device=dev)

    feed = prompt
    if mesh is not None:  # this rank's blocks of the weights, the prompt and the cache
        from repro_torch.distributed import sharding as sh

        rules = rules if rules is not None else sh.serve_rules(cfg, mesh)
        model = sh.place_model(model, cfg, mesh, rules)
        cache_abs = lm.init_cache(cfg, batch, prompt_len + gen_len, quantized=quantized_kv,
                                  abstract=True)
        cache_sh = sh.shardings_for(lm.cache_specs(cfg, quantized=quantized_kv), mesh, rules,
                                    cache_abs)
        rows_sh = sh.shardings_for(("batch", None), mesh, rules, prompt)
        feed = sh.place(prompt, rows_sh).to_local()
        if audio is not None:
            audio = sh.place(audio, sh.shardings_for(("batch", None, None), mesh, rules,
                                                     audio)).to_local()

    def encode():
        if audio is None:
            return None
        return lm.precompute_cross(model, cfg, audio, mesh=mesh, rules=rules)[0]

    def new_cache():
        if mesh is None:
            return lm.init_cache(cfg, batch, prompt_len + gen_len, quantized=quantized_kv,
                                 device=dev)
        return sh.local_tree(sh.zeros_tree(cache_abs, cache_sh))

    if mode == "loop":
        def run_once(cache):
            t0 = time.perf_counter()
            cross_kv = encode()

            def decode(m, c, t, pos):
                return lm.decode_step(m, cfg, c, t, pos, cross_kv=cross_kv)

            logits, cache = prefill_loop(decode, model, cache, prompt)
            _sync(dev)
            t_pf = time.perf_counter()
            tok = logits[:, -1:].argmax(dim=-1)
            gen, _ = decode_loop(decode, model, cache, tok, prompt_len, gen_len)
            _sync(dev)
            return gen, t_pf - t0, time.perf_counter() - t_pf
    else:
        def run_once(cache):
            t0 = time.perf_counter()
            cross_kv = encode()
            logits, cache = lm.prefill(model, cfg, cache, feed, cross_kv=cross_kv,
                                       last_logit_only=True, mesh=mesh, rules=rules)
            _sync(dev)
            t_pf = time.perf_counter()
            tok = logits[:, -1:].argmax(dim=-1)
            gen, _, _ = lm.generate_scan(model, cfg, cache, tok, prompt_len, gen_len,
                                         cross_kv=cross_kv, mesh=mesh, rules=rules)
            _sync(dev)
            return gen, t_pf - t0, time.perf_counter() - t_pf

    run_once(new_cache())  # warmup
    prefill_s, decode_s = float("inf"), float("inf")
    for _ in range(max(1, reps)):
        cache = new_cache()
        _sync(dev)
        gen, dt_pf, dt_dec = run_once(cache)
        prefill_s = min(prefill_s, dt_pf)
        decode_s = min(decode_s, dt_dec)
    stats = {
        "mode": mode,
        "device": str(dev),
        "prefill_ms": prefill_s * 1e3,
        "decode_tok_s": gen_len * batch / decode_s,
        "decode_ms_per_token": decode_s / gen_len * 1e3,
        "token_exact_vs_loop": token_exact,
    }
    if mesh is not None:  # every rank's block of the batch
        gen = sh.gather(gen, rows_sh)
    toks = torch.cat([prompt, gen], dim=1).cpu()
    if verbose:
        print(f"[serve] {arch} mode={mode} on {dev}: prefill({prompt_len} tok x{batch}) "
              f"{stats['prefill_ms']:.1f} ms; decode {gen_len} tok x{batch} "
              f"({stats['decode_tok_s']:.1f} tok/s, quantized_kv={quantized_kv})")
    return toks, stats


def main(argv=None):
    """CLI wrapper over :func:`generate`:
    ``python -m repro_torch.launch.serve [--arch qwen3-4b] [--device cpu] ...``"""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--sqrt-unit", default="e2afs")
    ap.add_argument("--quantized-kv", action="store_true")
    ap.add_argument("--mode", choices=MODES, default="scan",
                    help="scan: batched prefill + device-side greedy decode; "
                         "loop: per-token baseline")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    toks, _ = generate(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                       gen_len=args.gen_len, sqrt_unit=args.sqrt_unit,
                       quantized_kv=args.quantized_kv, mode=args.mode, device=args.device)
    print(toks[:, :24])


if __name__ == "__main__":
    main()
