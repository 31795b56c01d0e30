"""Fused RMSNorm kernel with the E2AFS-R rsqrt."""
