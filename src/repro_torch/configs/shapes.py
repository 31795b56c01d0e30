"""The input shapes of the dry run's cells (torch port of
``repro.configs.shapes``), with meta tensors in place of ``ShapeDtypeStruct``.

Shape policy:
  * train_4k / prefill_32k: all 10 LM archs (the train step / the forward);
  * decode_32k: all 10 (the serve step; whisper decodes over a synthetic 32k
    decoder cache);
  * long_500k: the sub-quadratic-capable archs only (SSM, hybrid, windowed,
    mostly local); pure full-attention archs report skip(full-attn).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models.config import ModelConfig

__all__ = ["SHAPES", "SMOKE_SHAPES", "ShapeCase", "input_specs", "shape_applies",
           "cache_len_for"]


@dataclasses.dataclass(frozen=True)
class ShapeCase:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCase("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCase("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCase("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCase("long_500k", 524288, 1, "decode"),
}

# smoke-scale variants of the same four cases (CPU-sized; batch 4 divides the
# 2 x 2 [x 2] smoke meshes)
SMOKE_SHAPES = {
    "train_4k": ShapeCase("train_4k", 32, 4, "train"),
    "prefill_32k": ShapeCase("prefill_32k", 64, 4, "prefill"),
    "decode_32k": ShapeCase("decode_32k", 64, 4, "decode"),
    "long_500k": ShapeCase("long_500k", 128, 1, "decode"),
}


def shape_applies(cfg: ModelConfig, shape_name: str) -> Optional[str]:
    """None if the (arch, shape) cell runs; otherwise a skip reason."""
    if shape_name == "long_500k" and not cfg.long_context_capable:
        return "skip(full-attn)"
    return None


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, case: ShapeCase) -> dict:
    """Meta tensors (shape and dtype, no storage) for every model input of
    this cell.

    For train and prefill: the forward batch (and labels, loss mask for
    train).  For decode: the (b, 1) token batch; the cache is built by the
    dry run (``launch/dryrun.py``), which shards it on its own."""
    b, s = case.global_batch, case.seq_len
    tok = torch.int32
    if case.kind in ("train", "prefill"):
        batch = {}
        s_text = s
        if cfg.vision_tokens:
            s_text = s - cfg.vision_tokens
            batch["vision"] = _spec((b, cfg.vision_tokens, cfg.d_model), torch.bfloat16)
        batch["tokens"] = _spec((b, s_text), tok)
        if cfg.kind == "encdec":
            batch["audio"] = _spec((b, cfg.encoder.n_ctx, cfg.d_model), torch.bfloat16)
        if case.kind == "train":
            batch["labels"] = _spec((b, s_text), tok)
            batch["loss_mask"] = _spec((b, s_text), torch.float32)
        return batch
    # decode: one new token against a cache of seq_len lines
    return {"tokens": _spec((b, 1), tok)}


def cache_len_for(cfg: ModelConfig, case: ShapeCase) -> int:
    assert case.kind == "decode"
    return case.seq_len
