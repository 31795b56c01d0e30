"""Fused per-slot decode-attention kernel."""
