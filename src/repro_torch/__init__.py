"""PyTorch/CUDA port of the E2AFS reproduction (the JAX package ``repro`` is
the reference it is held against).

The layout mirrors ``repro``: ``core/`` (bit-level datapaths and the sqrt-unit
registry), ``kernels/`` (hand-written CUDA kernels for Hopper, each beside its
plain PyTorch version), ``layers/``, ``models/``, ``configs/`` and
``launch/``.  Public entry points run on ``cuda`` unless the caller passes
``device="cpu"``; see :func:`repro_torch.device.resolve_device`.
"""
