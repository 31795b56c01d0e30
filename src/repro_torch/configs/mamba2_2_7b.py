"""mamba2-2.7b [ssm]: 64L, d=2560, attention-free SSD (state-space duality),
d_state=128, vocab=50280 [arXiv:2405.21060].  d_inner = 2*d_model, head_dim
64 (80 SSD heads; ``n_heads`` mirrors the reference's field)."""
from repro_torch.models.config import ModelConfig, SSMSpec


def config():
    return ModelConfig(
        name="mamba2-2.7b",
        n_layers=64,
        d_model=2560,
        n_heads=40,
        n_kv_heads=40,
        d_head=64,
        d_ff=0,
        vocab=50280,
        block_pattern=("ssd",),
        ssm=SSMSpec(d_inner=5120, d_state=128, head_dim=64),
        pos="none",
    ).validate()


def smoke_config():
    return config().replace(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_head=16,
        vocab=256,
        ssm=SSMSpec(d_inner=128, d_state=16, head_dim=32),
    ).validate()
