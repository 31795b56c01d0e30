"""Bridge from the JAX package's parameter tree to the port's modules.

``jax.random`` and ``torch.Generator`` draw different numbers from one seed,
so parity runs initialise with the reference (``repro.models.lm.init``),
turn its tree into numpy arrays, and load them here.  Nothing is
downloaded and JAX is not imported: the input is plain numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig

__all__ = ["params_from_numpy"]


def _tensor(a, dtype, device) -> torch.Tensor:
    # float32 first: the reference keeps float32 masters, and numpy has no
    # native bfloat16 that torch can read
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(
        device=device, dtype=dtype)


@torch.no_grad()
def params_from_numpy(cfg: ModelConfig, tree: dict, device=None) -> lm.LM:
    """Map the reference tree (``embed``, ``unembed``, ``ln_f`` and
    ``layers/{ln1, ln2, attn/{wq, wk, wv, wo, q_norm, k_norm},
    mlp/{wi_gate, wi_up, wo}}`` stacked on a leading L axis) into an
    :class:`~repro_torch.models.lm.LM`.  Each tensor is stored once in
    ``cfg.act_dtype``: the reference casts its float32 masters at every use,
    which gives the same values."""
    dev = resolve_device(device)
    model = lm.LM(cfg, device=dev)
    dtype = lm.act_dtype(cfg)
    loaded = set()

    def put(param: torch.nn.Parameter, name: str, a):
        if tuple(np.shape(a)) != tuple(param.shape):
            raise ValueError(f"{name}: shape {np.shape(a)} != {tuple(param.shape)}")
        param.copy_(_tensor(a, dtype, dev))
        loaded.add(name)

    for name in ("embed", "unembed", "ln_f"):
        if name in tree:
            put(getattr(model, name), name, tree[name])
    layers = tree["layers"]
    for i, block in enumerate(model.layers):
        for name in ("ln1", "ln2"):
            put(getattr(block, name), f"layers.{i}.{name}", layers[name][i])
        for sub, module in (("attn", block.attn), ("mlp", block.mlp)):
            for name, _ in module.named_parameters():
                put(getattr(module, name), f"layers.{i}.{sub}.{name}", layers[sub][name][i])
    missing = {n for n, _ in model.named_parameters()} - loaded
    if missing:
        raise ValueError(f"parameters missing from the tree: {sorted(missing)}")
    return model
