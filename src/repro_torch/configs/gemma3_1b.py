"""gemma3-1b [dense]: 26L, d=1152, 4H GQA kv=1, ff=6912, vocab=262144,
5:1 local:global attention (window 512), 128k-class context
[hf:google/gemma-3-1b-pt].  Tied embeddings, qk-norm."""
from repro_torch.models.config import ModelConfig


def config():
    return ModelConfig(
        name="gemma3-1b",
        n_layers=26,
        d_model=1152,
        n_heads=4,
        n_kv_heads=1,
        d_head=256,
        d_ff=6912,
        vocab=262144,
        block_pattern=("window", "window", "window", "window", "window", "global"),
        window=512,
        qk_norm=True,
        tie_embeddings=True,
        rope_theta=1_000_000.0,
    ).validate()


def smoke_config():
    return config().replace(
        n_layers=6,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_head=16,
        d_ff=128,
        vocab=256,
        window=8,
    ).validate()
