"""starcoder2-15b [dense]: 40L, d=6144, 48H GQA kv=4, ff=24576, vocab=49152,
RoPE [arXiv:2402.19173].  StarCoder2 uses layernorm + GELU MLP."""
from repro_torch.models.config import ModelConfig


def config():
    return ModelConfig(
        name="starcoder2-15b",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=4,
        d_head=128,
        d_ff=24576,
        vocab=49152,
        norm="layernorm",
        mlp_act="gelu",
        rope_theta=100_000.0,
    ).validate()


def smoke_config():
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128, vocab=256
    ).validate()
