"""Fused Sobel gradient magnitude through the E2AFS sqrt."""
