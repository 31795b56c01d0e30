"""qwen3-moe-235b-a22b [moe]: 94L, d=4096, 64H GQA kv=4, 128 experts top-8
with d_ff=1536 per expert, vocab=151936, qk_norm [hf:Qwen/Qwen3-235B-A22B
family]."""
from repro_torch.models.config import ModelConfig, MoESpec


def config():
    return ModelConfig(
        name="qwen3-moe-235b-a22b",
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        d_head=128,
        d_ff=1536,
        vocab=151936,
        moe=MoESpec(n_experts=128, top_k=8, d_ff_expert=1536),
        qk_norm=True,
        rope_theta=1_000_000.0,
    ).validate()


def smoke_config():
    return config().replace(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=64,
        vocab=256,
        moe=MoESpec(n_experts=8, top_k=2, d_ff_expert=64),
    ).validate()
