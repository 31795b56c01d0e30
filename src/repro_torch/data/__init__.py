"""Deterministic synthetic LM data."""
from repro_torch.data.pipeline import DataConfig, SyntheticLM, host_slice

__all__ = ["DataConfig", "SyntheticLM", "host_slice"]
