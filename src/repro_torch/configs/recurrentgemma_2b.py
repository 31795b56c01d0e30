"""recurrentgemma-2b [hybrid]: 26L, d=2560, RG-LRU + local attention 1:2
(pattern: rglru, rglru, window), 10H GQA kv=1, ff=7680, vocab=256000
[arXiv:2402.19427].  Window 2048, tied embeddings."""
from repro_torch.models.config import ModelConfig, RGLRUSpec


def config():
    return ModelConfig(
        name="recurrentgemma-2b",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        d_head=256,
        d_ff=7680,
        vocab=256000,
        block_pattern=("rglru", "rglru", "window"),
        window=2048,
        rglru=RGLRUSpec(d_rnn=2560),
        tie_embeddings=True,
    ).validate()


def smoke_config():
    return config().replace(
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_head=16,
        d_ff=128,
        vocab=256,
        window=8,
        rglru=RGLRUSpec(d_rnn=64),
    ).validate()
