"""Plain PyTorch versions of absmax-int8 quantize and dequantize.

Bit-compatible with ``checkpoint.serialize.quantize`` / ``finish_payload``:
the reduce result goes through ``serialize.int8_scale_inv`` (numpy float32)
on the host, and the elementwise steps are multiply-only in float32, rounded
half to even — the same bytes the CUDA kernels write.
"""

from __future__ import annotations

import numpy as np
import torch

from ...checkpoint.serialize import int8_scale_inv


def absmax_ref(x: torch.Tensor) -> torch.Tensor:
    """max|x| in float32 as a 0-d tensor; NaN propagates like ``np.max``."""
    if x.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=x.device)
    return torch.max(torch.abs(x.detach().to(torch.float32)))


def quantize_with_inv_ref(x: torch.Tensor, inv) -> torch.Tensor:
    """int8(clip(rint(f32(x) * inv), ±127)) with a float32 ``inv``."""
    y = x.detach().to(torch.float32) * torch.tensor(
        np.float32(inv), dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(y), -127.0, 127.0).to(torch.int8)


def quantize_int8_ref(x: torch.Tensor) -> tuple[torch.Tensor, float]:
    """x (float tensor) -> (q int8 of x.shape, float32 scale as a float)."""
    if x.numel() == 0:
        return torch.zeros(x.shape, dtype=torch.int8, device=x.device), 1.0
    scale, inv = int8_scale_inv(absmax_ref(x).cpu().numpy())
    return quantize_with_inv_ref(x, inv), float(scale)


def dequantize_int8_ref(q: torch.Tensor, scale, *, dtype: torch.dtype
                        ) -> torch.Tensor:
    """(q int8, absmax scale) -> tensor of ``dtype``; float32 multiply with
    a float32 scale, then one round-to-nearest-even cast."""
    s = torch.tensor(np.float32(scale), dtype=torch.float32, device=q.device)
    return (q.to(torch.float32) * s).to(dtype)
