"""Maps public arch ids to their config modules (the architectures the port
runs so far)."""
from __future__ import annotations

import importlib

ARCH_IDS = (
    "qwen3-4b",
    "starcoder2-15b",
    "deepseek-67b",
    "gemma3-1b",
    "internvl2-76b",
    "mixtral-8x22b",
    "qwen3-moe-235b-a22b",
    "mamba2-2.7b",
    "recurrentgemma-2b",
)


def _module(arch_id: str):
    mod = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch_id: str, **overrides):
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    cfg = _module(arch_id).config()
    return cfg.replace(**overrides).validate() if overrides else cfg


def get_smoke_config(arch_id: str, **overrides):
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    cfg = _module(arch_id).smoke_config()
    return cfg.replace(**overrides).validate() if overrides else cfg
