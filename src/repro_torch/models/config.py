"""Architecture configuration (the port's own copy of
``repro.models.config``, with the same fields).

:meth:`ModelConfig.validate` checks the reference's rules (an accuracy-SLO
ladder has at least two rungs, rung 0 equal to ``sqrt_unit``, the last
"exact"; an encoder-decoder model has an encoder) as ``ValueError`` s, and
also rejects what the port does not run: an unknown unit, norm, MLP, block,
position or remat, activations other than bfloat16 or float32.  Every sqrt
unit runs ("exact", "e2afs", "esas", "cwaha4", "cwaha8"), with seeded
datapath faults (``sqrt_faults``) and a ladder, and remat "none", "block" or
"minimal"; patterns that mix "global" and "window" blocks run (gemma3-1b's
5:1); so do RMSNorm and LayerNorm, SwiGLU and GELU MLPs, mixture-of-experts
layers (``moe``), the vision stub's tokens (``vision_tokens``), the
recurrent blocks: "ssd" (mamba2-2.7b, with ``pos="none"``) and "rglru"
(recurrentgemma-2b's mix with "window"), and encoder-decoder models
(``kind="encdec"``, whisper-small: an ``encoder`` over the audio stub's
frames, cross-attention in every decoder layer, sinusoidal positions).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.faults import FaultConfig
from repro_torch.core.units import available_units

__all__ = ["ModelConfig", "MoESpec", "SSMSpec", "RGLRUSpec", "EncoderSpec"]


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    d_inner: int
    d_state: int
    head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class RGLRUSpec:
    d_rnn: int


@dataclasses.dataclass(frozen=True)
class EncoderSpec:
    n_layers: int
    n_ctx: int


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    kind: str = "decoder"  # "decoder" | "encdec"
    # per-layer block types, cycled over n_layers:
    #   "global" (causal full attn) | "window" (sliding) | "ssd" | "rglru"
    block_pattern: Tuple[str, ...] = ("global",)
    window: Optional[int] = None
    moe: Optional[MoESpec] = None
    ssm: Optional[SSMSpec] = None
    rglru: Optional[RGLRUSpec] = None
    qk_norm: bool = False
    norm: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    mlp_act: str = "swiglu"  # "swiglu" | "gelu"
    pos: str = "rope"  # "rope" | "sinusoidal" | "none"
    rope_theta: float = 10000.0
    encoder: Optional[EncoderSpec] = None
    vision_tokens: int = 0
    tie_embeddings: bool = False
    act_dtype: str = "bfloat16"
    scores_dtype: str = "float32"
    sqrt_unit: str = "exact"
    # seeded fault schedule for the sqrt datapath (core/faults.py); None = clean
    sqrt_faults: Optional[FaultConfig] = None
    # accuracy-SLO demotion ladder: decode entry points then take a per-row
    # ``unit_levels`` vector and route each row's norm rsqrt through
    # ladder[level]; rung 0 is ``sqrt_unit`` (the only rung that sees
    # ``sqrt_faults``), the last "exact".  None = one datapath
    sqrt_ladder: Optional[Tuple[str, ...]] = None
    remat: str = "block"  # "none" | "block" | "minimal"
    # decode-attention route: None = inline PyTorch path; "fused" = the CUDA
    # decode-attention kernel via the dispatch layer; "reference" = its plain
    # version
    decode_kernel: Optional[str] = None

    @property
    def padded_vocab(self) -> int:
        """Embedding tables pad the vocab to a 256 multiple; decode slices
        back to the true vocab."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def blocks(self) -> Tuple[str, ...]:
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    @property
    def uniform(self) -> bool:
        return len(set(self.blocks)) == 1

    @property
    def is_subquadratic(self) -> bool:
        """True if no layer needs an unbounded dense KV cache."""
        return all(b != "global" for b in self.blocks)

    @property
    def long_context_capable(self) -> bool:
        """Policy for the long_500k shape: SSM, hybrid and windowed archs run
        it, and so do mostly-local archs whose global layers are at most a
        quarter of the stack (a bounded count of global KV caches); pure
        full-attention archs skip."""
        n_global = sum(b == "global" for b in self.blocks)
        return n_global == 0 or (n_global / self.n_layers) <= 0.25

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def validate(self):
        if self.d_model <= 0 or self.n_layers <= 0:
            raise ValueError("d_model and n_layers must be positive")
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"n_heads {self.n_heads} not a multiple of "
                             f"n_kv_heads {self.n_kv_heads}")
        if "window" in self.blocks and not self.window:
            raise ValueError("window blocks need cfg.window")
        if self.decode_kernel not in (None, "fused", "reference"):
            raise ValueError(f"unknown decode kernel {self.decode_kernel!r}; "
                             f"expected None, 'fused' or 'reference'")
        units = available_units()
        if self.sqrt_unit not in units:
            raise ValueError(f"unknown sqrt unit {self.sqrt_unit!r}; expected one of {units}")
        if self.sqrt_ladder is not None:
            ladder = tuple(self.sqrt_ladder)
            if len(ladder) < 2:
                raise ValueError(f"a sqrt ladder needs >= 2 rungs (approx -> exact), got {ladder}")
            if ladder[0] != self.sqrt_unit:
                raise ValueError(f"sqrt ladder rung 0 must be sqrt_unit {self.sqrt_unit!r}, "
                                 f"got {ladder}")
            if ladder[-1] != "exact":
                raise ValueError(f"sqrt ladder must end at 'exact', got {ladder}")
            unknown = [n for n in ladder if n not in units]
            if unknown:
                raise ValueError(f"sqrt ladder {ladder}: unknown units {unknown}")
        if self.sqrt_faults is not None and not isinstance(self.sqrt_faults, FaultConfig):
            raise ValueError(f"sqrt_faults must be a FaultConfig, got {self.sqrt_faults!r}")
        if self.remat not in ("none", "block", "minimal"):
            raise ValueError(f"unknown remat {self.remat!r}; expected 'none', 'block' or "
                             f"'minimal'")
        if self.act_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"the port runs bfloat16 or float32 activations, "
                             f"got {self.act_dtype!r}")
        if self.norm not in ("rmsnorm", "layernorm"):
            raise ValueError(f"unknown norm {self.norm!r}; expected 'rmsnorm' or 'layernorm'")
        if self.mlp_act not in ("swiglu", "gelu"):
            raise ValueError(f"unknown MLP activation {self.mlp_act!r}; expected 'swiglu' or "
                             f"'gelu'")
        unknown = set(self.blocks) - {"global", "window", "ssd", "rglru"}
        if unknown:
            raise ValueError(f"unknown blocks {sorted(unknown)}; expected 'global', 'window', "
                             f"'ssd' or 'rglru'")
        if "ssd" in self.blocks and self.ssm is None:
            raise ValueError("ssd blocks need cfg.ssm")
        if "rglru" in self.blocks and self.rglru is None:
            raise ValueError("rglru blocks need cfg.rglru")
        if self.pos not in ("rope", "sinusoidal", "none"):
            raise ValueError(f"unknown positions {self.pos!r}; expected 'rope', 'sinusoidal' "
                             f"or 'none'")
        if self.pos == "sinusoidal" and self.d_model % 2:
            raise ValueError(f"sinusoidal positions need an even d_model, got {self.d_model}")
        if self.kind not in ("decoder", "encdec"):
            raise ValueError(f"unknown kind {self.kind!r}; expected 'decoder' or 'encdec'")
        if self.kind == "encdec" and self.encoder is None:
            raise ValueError("encoder-decoder models need cfg.encoder")
        return self
