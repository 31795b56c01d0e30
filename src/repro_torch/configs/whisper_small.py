"""whisper-small [audio]: 12L enc + 12L dec, d=768, 12H (kv=12), ff=3072,
vocab=51865 [arXiv:2212.04356].  Encoder-decoder; the conv audio frontend
is a stub: ``batch["audio"]`` holds precomputed frame embeddings (B, 1500,
768).  Whisper uses sinusoidal (encoder) and learned (decoder) positions;
like the reference, both sides take sinusoidal ones here."""
from repro_torch.models.config import EncoderSpec, ModelConfig


def config():
    return ModelConfig(
        name="whisper-small",
        kind="encdec",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_head=64,
        d_ff=3072,
        vocab=51865,
        block_pattern=("global",),
        norm="layernorm",
        mlp_act="gelu",
        pos="sinusoidal",
        encoder=EncoderSpec(n_layers=12, n_ctx=1500),
    ).validate()


def smoke_config():
    return config().replace(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_head=16,
        d_ff=128,
        vocab=256,
        encoder=EncoderSpec(n_layers=2, n_ctx=8),
    ).validate()
