"""Architecture registry: ``get_config("qwen3-4b")`` etc."""
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config

__all__ = ["ARCH_IDS", "get_config", "get_smoke_config"]
