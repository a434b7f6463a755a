"""Plain PyTorch version of the selective scan: the sequential Mamba-1
recurrence, the counterpart of the reference's ``ssm_scan_ref``.

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) * B_t,   h_{-1} = 0
    y_t = sum_n h_t * C_t + u_t * D

in float32, each product and sum rounded on its own as the CUDA kernel
computes the state. Autograd runs through it: it is the backward of
``selective_scan``, as the reference differentiates its jnp version.
"""

from __future__ import annotations

import torch


def ssm_scan_ref(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, D: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """u, delta: (B,S,DI); A: (DI,N); B, C: (B,S,N); D: (DI,). Returns
    (y (B,S,DI) in u's dtype, h_last (B,DI,N) float32)."""
    f32 = torch.float32
    Bb, S, DI = u.shape
    u32, d32 = u.to(f32), delta.to(f32)
    A32, B32, C32 = A.to(f32), B.to(f32), C.to(f32)
    h = torch.zeros((Bb, DI, A.shape[1]), dtype=f32, device=u.device)
    ys = []
    for t in range(S):
        dA = torch.exp(d32[:, t, :, None] * A32[None])
        h = dA * h + (d32[:, t] * u32[:, t])[..., None] * B32[:, t, None, :]
        ys.append(torch.sum(h * C32[:, t, None, :], dim=2))
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(u32)
    return (y + u32 * D.to(f32)).to(u.dtype), h
