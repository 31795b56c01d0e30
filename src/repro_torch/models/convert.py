"""Bridge between the JAX package's parameter tree and the port's modules.

``jax.random`` and ``torch.Generator`` draw different numbers from one seed,
so parity runs initialise with the reference (``repro.models.lm.init``),
turn its tree into numpy arrays, and load them here.  Nothing is
downloaded and JAX is not imported: the input is plain numpy.

The reference's tree is ``embed``, ``unembed``, ``ln_f`` and
``layers/{ln1, ln2, attn/{wq, wk, wv, wo, q_norm, k_norm},
mlp/{wi_gate, wi_up, wo}}``, a recurrent layer's ``mixer/...`` in place of
``attn`` (an "ssd" layer has no ln2 or mlp): for a uniform model one dict
whose arrays are stacked on a leading L axis, for a mixed model (gemma3-1b's
window and global layers, recurrentgemma-2b's RG-LRU and window layers) a
list of L per-layer dicts, each with its own block's leaves.  An
encoder-decoder's decoder layers also hold ``xattn/...`` and ``lnx``, and the
tree has ``encoder/{ln1, attn, ln2, mlp}`` (always stacked on the encoder's
layers) and ``enc_extra/enc_ln_f``.  The port names the same tensors
``embed`` ... ``layers.<i>.attn.wq``, ``encoder.<i>.attn.wq``,
``enc_extra.enc_ln_f_scale``.  :func:`named_to_tree` and
:func:`tree_to_named` map any per-parameter state (the parameters, the
optimizer's moments) between the two, so checkpoints keep the reference's
leaf names (``layers_wq``-style stacked leaves, or ``layers_<i>_...``;
``encoder_attn_wq``, ``enc_extra_enc_ln_f_scale``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig

__all__ = ["named_to_tree", "params_from_numpy", "params_to_numpy", "tree_to_named"]


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy, never a view: a checkpoint written later from it must not
    see the in-place updates of the steps after.  numpy has no bfloat16:
    such tensors come out as float32 (exact)."""
    dtype = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
    return t.detach().to("cpu", dtype, copy=True).numpy()


def _put(node: dict, path, value) -> None:
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


def _stack_layers(per_layer: dict, n: int, stacked: bool, what: str):
    """{path: [array of layer i]} -> a dict of arrays stacked on a leading
    axis of ``n`` (every layer holding every leaf), or a list of ``n``
    per-layer dicts, each with the leaves it holds."""
    layers = {} if stacked else [{} for _ in range(n)]
    for path, arrays in per_layer.items():
        if stacked:
            if len(arrays) != n or any(a is None for a in arrays):
                raise ValueError(f"{what}.*.{'.'.join(path)}: not every layer is present")
            _put(layers, path, np.stack(arrays))
        else:  # a mixed stack's layers hold what their block holds
            for layer, a in zip(layers, arrays):
                if a is not None:
                    _put(layer, path, a)
    return layers


def named_to_tree(named: dict, n_layers: int, *, stacked: bool) -> dict:
    """``{port name: tensor}`` -> the reference's nested tree of numpy
    arrays: per-layer tensors stacked on a leading L axis (``stacked``: a
    uniform model, ``cfg.uniform``; every layer must hold every leaf), or a
    list of ``n_layers`` per-layer dicts (a mixed model, each layer with the
    leaves it holds).  An encoder's layers are always stacked, on as many
    layers as the names give."""
    tree, per_layer, per_enc = {}, {}, {}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] == "layers":
            per_layer.setdefault(tuple(parts[2:]), [None] * n_layers)[int(parts[1])] = _numpy(t)
        elif parts[0] == "encoder":
            arrays = per_enc.setdefault(tuple(parts[2:]), [])
            i = int(parts[1])
            arrays.extend([None] * (i + 1 - len(arrays)))
            arrays[i] = _numpy(t)
        else:
            _put(tree, parts, _numpy(t))
    if per_layer:
        tree["layers"] = _stack_layers(per_layer, n_layers, stacked, "layers")
    if per_enc:
        n_enc = max(len(a) for a in per_enc.values())
        tree["encoder"] = _stack_layers(per_enc, n_enc, True, "encoder")
    return tree


def tree_to_named(tree: dict, names) -> dict:
    """The reference's tree -> ``{port name: numpy array}`` for ``names``:
    per-layer slices of the stacked arrays, or the entries of the list of
    per-layer dicts, by the type of ``tree["layers"]`` (``tree["encoder"]``
    is stacked).  A name the tree lacks raises."""
    out = {}
    for name in names:
        parts = name.split(".")
        node = tree
        try:
            if parts[0] in ("layers", "encoder"):
                layers, i = node[parts[0]], int(parts[1])
                node = layers[i] if isinstance(layers, list) else layers
                for key in parts[2:]:
                    node = node[key]
                if not isinstance(layers, list):
                    node = node[i]
            else:
                for key in parts:
                    node = node[key]
        except (KeyError, IndexError):
            raise ValueError(f"parameter {name} is missing from the tree") from None
        out[name] = node
    return out


@torch.no_grad()
def params_from_numpy(cfg: ModelConfig, tree: dict, device=None, *,
                      trainable: bool = False) -> lm.LM:
    """Map the reference tree into an :class:`~repro_torch.models.lm.LM`.
    For serving each tensor is stored once in ``cfg.act_dtype`` (the
    reference casts its float32 masters at every use, which gives the same
    values); ``trainable=True`` keeps float32 masters that require
    gradients."""
    dev = resolve_device(device)
    model = lm.LM(cfg, device=dev, trainable=trainable)
    params = dict(model.named_parameters())
    for name, a in tree_to_named(tree, params).items():
        param = params[name]
        if tuple(np.shape(a)) != tuple(param.shape):
            raise ValueError(f"{name}: shape {np.shape(a)} != {tuple(param.shape)}")
        # float32 first: numpy has no native bfloat16 that torch can read
        param.copy_(torch.from_numpy(np.array(a, dtype=np.float32)).to(dev, param.dtype))
    return model


def params_to_numpy(model: lm.LM) -> dict:
    """The model's parameters as the reference's tree of numpy arrays (layers
    stacked, or a list for a mixed model), the inverse of
    :func:`params_from_numpy`."""
    return named_to_tree(dict(model.named_parameters()), len(model.layers),
                         stacked=model.stacked)
