"""mixtral-8x22b [moe]: 56L, d=6144, 48H GQA kv=8, 8 experts top-2 with
d_ff=16384 per expert, vocab=32768, sliding-window attention
[arXiv:2401.04088]."""
from repro_torch.models.config import ModelConfig, MoESpec


def config():
    return ModelConfig(
        name="mixtral-8x22b",
        n_layers=56,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_head=128,
        d_ff=16384,
        vocab=32768,
        block_pattern=("window",),
        window=4096,
        moe=MoESpec(n_experts=8, top_k=2, d_ff_expert=16384),
        rope_theta=1_000_000.0,
    ).validate()


def smoke_config():
    return config().replace(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=128,
        vocab=256,
        window=8,
        moe=MoESpec(n_experts=4, top_k=2, d_ff_expert=128),
    ).validate()
