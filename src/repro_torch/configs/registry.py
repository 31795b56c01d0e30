"""Maps public arch ids to their config modules: every model the reference
runs, and the paper's own unit evaluation (``e2afs-fp16``, an
``E2AFSConfig``, not an LM)."""
from __future__ import annotations

import dataclasses
import importlib

ARCH_IDS = (
    "whisper-small",
    "qwen3-4b",
    "starcoder2-15b",
    "deepseek-67b",
    "gemma3-1b",
    "internvl2-76b",
    "mixtral-8x22b",
    "qwen3-moe-235b-a22b",
    "mamba2-2.7b",
    "recurrentgemma-2b",
    # the paper's own "architecture": the FP16 sqrt unit evaluation
    "e2afs-fp16",
)


def _module(arch_id: str):
    mod = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch_id: str, **overrides):
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    cfg = _module(arch_id).config()
    return dataclasses.replace(cfg, **overrides).validate() if overrides else cfg


def get_smoke_config(arch_id: str, **overrides):
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    cfg = _module(arch_id).smoke_config()
    return dataclasses.replace(cfg, **overrides).validate() if overrides else cfg
