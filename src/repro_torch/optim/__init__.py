"""AdamW with a pluggable sqrt unit, and int8 gradient compression."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update, cosine_lr,
                                    global_norm_clip, opt_state_specs)
from repro_torch.optim.compression import compress_decompress, compress_init

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "compress_decompress",
    "compress_init",
    "cosine_lr",
    "global_norm_clip",
    "opt_state_specs",
]
