"""Device selection and bit-exact execution settings for the port.

Entry points run on the GPU unless the caller asks for the CPU: ``device``
defaults to ``"cuda"`` and a missing GPU is an error, never a silent
fallback.
"""

from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` (default ``"cuda"``) as a ``torch.device``; raises when
    CUDA is asked for and no GPU is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA GPU is available; pass device='cpu' to run on the CPU")
    return dev


def set_deterministic() -> None:
    """Settings that make a train step bitwise reproducible on CUDA — the
    premise of a bit-exact resume: cuBLAS with a fixed workspace (the
    variable takes effect if set before cuBLAS's first use), deterministic
    kernels (raising where an op has none), and full-precision float32
    matmuls and convolutions (no TF32)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
