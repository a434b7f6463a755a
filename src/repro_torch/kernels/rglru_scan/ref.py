"""Plain PyTorch version of the RG-LRU scan: the sequential recurrence
``h_t = a_t * h_{t-1} + b_t`` from ``h_{-1} = 0``, in float32, one multiply
and one add per step, each rounded (the CUDA kernel's arithmetic, so the
two agree bit for bit)."""

from __future__ import annotations

import torch


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """a, b: (B,S,W) -> (h (B,S,W) in a's dtype, h_last (B,W) float32)."""
    Bb, S, W = a.shape
    a32, b32 = a.to(torch.float32), b.to(torch.float32)
    h = torch.zeros((Bb, W), dtype=torch.float32, device=a.device)
    out = torch.empty((Bb, S, W), dtype=torch.float32, device=a.device)
    for t in range(S):
        h = a32[:, t] * h + b32[:, t]
        out[:, t] = h
    return out.to(a.dtype), h
