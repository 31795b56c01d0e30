"""Model configuration, the dense decoder, and the JAX-parameter bridge."""
