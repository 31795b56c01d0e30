"""The train, prefill and serve steps (torch port of ``repro.launch.steps``;
the dry run, ``launch/dryrun.py``, runs the last two).

``loss_fn(model, cfg, batch)`` is the masked next-token cross-entropy over
the padded vocab, computed in sequence chunks so the float32 (b, s, vocab)
logits are never whole.  ``make_train_step`` returns
``train_step(model, opt_state, batch) -> (model, opt_state, metrics)``,
which updates the model's parameters and the optimizer state IN PLACE.
``make_prefill_step(cfg)`` returns ``prefill_step(model, batch) -> logits``
of the last position (``lm.forward``); ``make_serve_step(cfg, with_cross=)``
returns ``serve_step(model, cache, tokens, pos[, cross_kv]) -> (logits,
cache)`` (``lm.decode_step``).
"""
from __future__ import annotations

import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, adamw_update, compress_decompress

__all__ = ["loss_fn", "make_train_step", "make_prefill_step", "make_serve_step", "LOSS_CHUNK"]

MOE_AUX_COEF = 0.01
LOSS_CHUNK = 1024


def loss_fn(model, cfg: ModelConfig, batch: dict):
    """Masked next-token cross-entropy (+ the MoE aux term, 0 for dense
    models).  ``logsumexp`` runs over every padded-vocab column, as the
    reference's does.  Returns (total, {"loss", "moe_aux"})."""
    (x, unembed), aux = lm.forward(model, cfg, batch, return_hidden=True)
    labels = batch["labels"].long()
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)

    s = x.shape[1]
    chunk = LOSS_CHUNK if s % LOSS_CHUNK == 0 else s
    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(s // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        logits = (x[:, sl] @ unembed).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        lab = torch.gather(logits, -1, labels[:, sl, None])[..., 0]
        nll_sum = nll_sum + ((lse - lab) * mask[:, sl]).sum()
    loss = nll_sum / torch.clamp(mask.sum(), min=1.0)
    total = loss + MOE_AUX_COEF * aux["moe_aux"]
    return total, {"loss": loss, "moe_aux": aux["moe_aux"]}


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *, compress_grads: bool = False,
                    microbatches: int = 1):
    """Returns ``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``.

    ``microbatches`` > 1 accumulates gradients over that many slices of the
    batch's leading axis (activation memory of one slice; the gradients are
    the float32 accumulator), then divides by the count.  With
    ``compress_grads`` the int8 error-feedback round trip runs on the
    gradients (``opt_state`` carries a "residual" entry).  The gradients are
    freed after the update.  Metrics are device tensors: ``loss``, ``total``,
    ``lr`` and, when clipping, ``grad_norm``."""

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        if microbatches == 1:
            t, metrics = loss_fn(model, cfg, batch)
            t.backward()
            t = t.detach()
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            per = batch["tokens"].shape[0] // microbatches
            t = None
            for i in range(microbatches):
                micro = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
                ti, _ = loss_fn(model, cfg, micro)
                ti.backward()  # sums into .grad, as the reference's accumulator
                t = ti.detach() if t is None else t + ti.detach()
            count = t.new_full((), float(microbatches))
            with torch.no_grad():
                for p in params.values():
                    p.grad.div_(count)
            t = t / count
            metrics = {"loss": t}
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        state = {k: v for k, v in opt_state.items() if k != "residual"}
        if compress_grads:
            compress_decompress(grads, opt_state["residual"])
        _, state, opt_metrics = adamw_update(opt_cfg, grads, state, params)
        if compress_grads:
            state["residual"] = opt_state["residual"]
        for p in params.values():
            p.grad = None
        return model, state, dict(metrics, total=t, **opt_metrics)

    return train_step


def make_prefill_step(cfg: ModelConfig):
    """Prefill as the reference's dry run prices it: the forward over the
    batch, returning the last position's logits (b, vocab_padded) (the
    cache fill is left out: the compute and memory are the forward's)."""

    @torch.no_grad()
    def prefill_step(model, batch):
        logits, _ = lm.forward(model, cfg, batch)
        return logits[:, -1]

    return prefill_step


def make_serve_step(cfg: ModelConfig, *, with_cross: bool = False):
    """``serve_step(model, cache, tokens, pos[, cross_kv]) -> (logits,
    cache)``: one ``lm.decode_step`` (the cache updated in place)."""
    if with_cross:
        def serve_step(model, cache, tokens, pos, cross_kv):
            return lm.decode_step(model, cfg, cache, tokens, pos, cross_kv=cross_kv)
    else:
        def serve_step(model, cache, tokens, pos):
            return lm.decode_step(model, cfg, cache, tokens, pos)
    return serve_step
