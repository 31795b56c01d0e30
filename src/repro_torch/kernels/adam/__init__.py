"""Fused AdamW step with the E2AFS sqrt denominator."""
