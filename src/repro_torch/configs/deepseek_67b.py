"""deepseek-67b [dense]: 95L, d=8192, 64H GQA kv=8, ff=22016, vocab=102400,
llama-arch (rmsnorm + swiglu + rope) [arXiv:2401.02954]."""
from repro_torch.models.config import ModelConfig


def config():
    return ModelConfig(
        name="deepseek-67b",
        n_layers=95,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_head=128,
        d_ff=22016,
        vocab=102400,
    ).validate()


def smoke_config():
    return config().replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128, vocab=256
    ).validate()
