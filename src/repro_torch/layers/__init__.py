"""Layers of the dense decoder: parameters, norms, RoPE, MLP, attention."""
