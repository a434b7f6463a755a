"""Hand-written CUDA kernels for the port's hot spots (Hopper, ``sm_90a``).

Each subpackage holds ``ops.py`` (the wrapper: the kernel for CUDA tensors,
the plain version for CPU tensors) and ``ref.py`` (the plain PyTorch
version); the CUDA sources live in ``csrc/`` and build through ``_lib``.
"""
