"""internvl2-76b [vlm]: 80L, d=8192, 64H GQA kv=8, ff=28672, vocab=128256
[arXiv:2404.16821].  InternViT frontend is a STUB: the batch's ``vision``
supplies precomputed patch embeddings (B, 1024, d) which a projection folds
into the LM sequence; backbone is InternLM2/llama-like."""
from repro_torch.models.config import ModelConfig

VISION_TOKENS = 1024


def config():
    return ModelConfig(
        name="internvl2-76b",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_head=128,
        d_ff=28672,
        vocab=128256,
        vision_tokens=VISION_TOKENS,
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
        vision_tokens=4,
    ).validate()
