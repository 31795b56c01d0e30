"""The train, prefill and serve steps (torch port of ``repro.launch.steps``;
the dry run, ``launch/dryrun.py``, runs the last two).

``loss_fn(model, cfg, batch)`` is the masked next-token cross-entropy over
the padded vocab, computed in sequence chunks so the float32 (b, s, vocab)
logits are never whole.  ``make_train_step`` returns
``train_step(model, opt_state, batch) -> (model, opt_state, metrics)``,
which updates the model's parameters and the optimizer state IN PLACE.

With ``mesh=`` the train step runs in an ``axis_rules`` scope (default
``train_rules``, the reference's FSDP x TP x EP), as the reference's jit
under ``train_rules`` runs under GSPMD: the model and the optimizer state
are each rank's blocks (``distributed.sharding.place_train_state``), the
batch the rank's rows (``distributed.sharding.place_batch``).  Each
layer's weights are gathered over the data-parallel axes before it runs
and their gradients reduce-scattered after its backward
(``constraints.fsdp_param``); the loss sums its masked NLL and mask count
over the data axes and takes its logsumexp over the vocabulary blocks of
'model'; the clip's norm sums each leaf's squares over the axes that shard
it; AdamW updates each rank's blocks.  On a mesh
whose axes are all one wide every collective is skipped and the step runs
the unsharded step's ops.
``make_prefill_step(cfg)`` returns ``prefill_step(model, batch) -> logits``
of the last position (``lm.forward``); ``make_serve_step(cfg, with_cross=)``
returns ``serve_step(model, cache, tokens, pos[, cross_kv]) -> (logits,
cache)`` (``lm.decode_step``).
"""
from __future__ import annotations

import torch

from repro_torch.distributed.constraints import (block_index, data_axes, maybe_axis_rules,
                                                 reduce_max, reduce_sum)
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, adamw_update, compress_decompress

__all__ = ["loss_fn", "make_train_step", "make_prefill_step", "make_serve_step", "LOSS_CHUNK"]

MOE_AUX_COEF = 0.01
LOSS_CHUNK = 1024




def _vocab_block_nll(logits, labels, axes):
    """(logsumexp, the label's logit) of each row whose vocabulary is in
    blocks over the mesh axes ``axes``, ``logits`` this rank's block: the
    max, the sum of exponentials and the label's logit (nonzero on the
    rank holding it) summed over the blocks."""
    n = logits.shape[-1]
    top = reduce_max(logits.detach().amax(dim=-1), axes)
    lse = top + torch.log(reduce_sum(torch.exp(logits - top[..., None]).sum(dim=-1), axes))
    local = labels - block_index(axes) * n
    hit = (local >= 0) & (local < n)
    lab = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    return lse, reduce_sum(torch.where(hit, lab, 0.0), axes)


def loss_fn(model, cfg: ModelConfig, batch: dict):
    """Masked next-token cross-entropy (+ the MoE aux term, 0 for dense
    models).  ``logsumexp`` runs over every padded-vocab column, as the
    reference's does.  Returns (total, {"loss", "moe_aux"}).

    In a scope (see the module docstring) the rows are the rank's: the NLL
    sum and the mask count are summed over the data axes; where 'model'
    splits the vocabulary the hidden state enters the rank's block of the
    unembedding through ``tp_entry`` and the logsumexp runs over the
    blocks."""
    (x, unembed), aux = lm.forward(model, cfg, batch, return_hidden=True)
    labels = batch["labels"].long()
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)

    vocab = lm.unembed_axes(cfg)  # x entered its blocks in the forward
    s = x.shape[1]
    chunk = LOSS_CHUNK if s % LOSS_CHUNK == 0 else s
    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(s // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        logits = (x[:, sl] @ unembed).to(torch.float32)
        if vocab:
            lse, lab = _vocab_block_nll(logits, labels[:, sl], vocab)
        else:
            lse = torch.logsumexp(logits, dim=-1)
            lab = torch.gather(logits, -1, labels[:, sl, None])[..., 0]
        nll_sum = nll_sum + ((lse - lab) * mask[:, sl]).sum()
    data = data_axes()
    count = mask.sum()
    if data:
        nll_sum, count = reduce_sum(nll_sum, data), reduce_sum(count, data)
    loss = nll_sum / torch.clamp(count, min=1.0)
    total = loss + MOE_AUX_COEF * aux["moe_aux"]
    return total, {"loss": loss, "moe_aux": aux["moe_aux"]}


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *, compress_grads: bool = False,
                    microbatches: int = 1, mesh=None, rules=None):
    """Returns ``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``.

    ``microbatches`` > 1 accumulates gradients over that many slices of the
    batch's leading axis (activation memory of one slice; the gradients are
    the float32 accumulator), then divides by the count.  With
    ``compress_grads`` the int8 error-feedback round trip runs on the
    gradients (``opt_state`` carries a "residual" entry).  The gradients are
    freed after the update.  Metrics are device tensors: ``loss``, ``total``,
    ``lr`` and, when clipping, ``grad_norm``.

    ``mesh=`` (``rules=`` default ``train_rules(cfg, mesh)``) runs the step
    sharded (see the module docstring): ``model`` and ``opt_state`` from
    ``sharding.place_train_state``, ``batch`` the rank's rows as
    ``sharding.place_batch(..., microbatches=)`` lays them out: slice ``i``
    of them is the rank's block of the whole batch's microbatch ``i``, so
    each microbatch's loss and MoE aux are the unsharded step's.  The
    accumulated gradient is the rank's blocks."""
    if mesh is not None and rules is None:
        from repro_torch.distributed.sharding import train_rules

        rules = train_rules(cfg, mesh)

    def train_step(model, opt_state, batch):
        with maybe_axis_rules(mesh, rules):
            return _train_step(model, opt_state, batch)

    def _train_step(model, opt_state, batch):
        placement = getattr(model, "placement", None)
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
            compress_decompress(grads, opt_state["residual"], shardings=placement)
        _, state, opt_metrics = adamw_update(opt_cfg, grads, state, params, shardings=placement)
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
