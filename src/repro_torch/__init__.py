"""Spot-on on PyTorch and CUDA: the port of the JAX package ``repro``.

Same module layout as the reference; checkpoints interchange byte-for-byte.
Entry points run on the GPU (``device="cuda"``) unless the caller passes
``device="cpu"``.
"""
