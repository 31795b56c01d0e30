"""qwen3-4b [dense]: 36L, d=2560, 32H GQA kv=8, ff=9728, vocab=151936,
qk_norm [hf:Qwen/Qwen3-8B family]."""
from repro_torch.models.config import ModelConfig


def config():
    return ModelConfig(
        name="qwen3-4b",
        n_layers=36,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=9728,
        vocab=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
    ).validate()


def smoke_config():
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128, vocab=256
    ).validate()
