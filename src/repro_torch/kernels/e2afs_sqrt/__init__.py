"""Elementwise E2AFS sqrt / E2AFS-R rsqrt kernel."""
