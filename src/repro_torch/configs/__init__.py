"""Architecture registry: ``get_config("qwen3-4b")`` etc., and the dry run's
input shapes (``configs/shapes.py``)."""
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.shapes import (SHAPES, SMOKE_SHAPES, ShapeCase, cache_len_for,
                                        input_specs, shape_applies)

__all__ = ["ARCH_IDS", "get_config", "get_smoke_config", "SHAPES", "SMOKE_SHAPES", "ShapeCase",
           "cache_len_for", "input_specs", "shape_applies"]
