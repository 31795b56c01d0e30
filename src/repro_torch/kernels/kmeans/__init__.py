"""Fused K-means assignment (one Lloyd iteration) through the E2AFS sqrt."""
