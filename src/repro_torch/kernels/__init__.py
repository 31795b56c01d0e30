"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version; :mod:`repro_torch.kernels.dispatch` routes between them."""
