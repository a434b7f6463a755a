"""Mamba-1 block (falcon-mamba-7b): a gated selective state-space model.

The sequence path (training forward and prefill) runs the recurrence
``h_t = exp(Δ_t A) h_{t-1} + Δ_t B_t u_t`` through ``kernels.ssm_scan``
(the CUDA kernel on the card, its plain sequential version on the CPU)
where the reference runs a chunked associative scan; gradients flow through
the plain version, as the reference's kernel wrapper has them. Decode keeps
O(1) state, (conv window, ssm state), and is plain PyTorch, as the
reference's decode is plain jnp.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.sharding import reduce_partial
from ..kernels.ssm_scan import selective_scan
from .config import SSMConfig
from .layers import causal_conv1d, conv_state_update


def selective_scan_step(state: torch.Tensor, u_t: torch.Tensor,
                        delta_t: torch.Tensor, A: torch.Tensor,
                        B_t: torch.Tensor, C_t: torch.Tensor, D: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """One recurrence step. state: (B,DI,N) float32; u_t, delta_t: (B,DI);
    B_t, C_t: (B,N). Returns (y_t (B,DI) in u_t's dtype, new_state)."""
    f32 = torch.float32
    d32 = delta_t.to(f32)
    dA = torch.exp(d32[..., None] * A[None])                       # (B,DI,N)
    dBu = d32[..., None] * B_t[:, None, :].to(f32) * u_t.to(f32)[..., None]
    new_state = dA * state + dBu
    y = torch.einsum("bdn,bn->bd", new_state, C_t.to(f32))
    return (y + u_t.to(f32) * D[None]).to(u_t.dtype), new_state


def split_xdbc(xdbc: torch.Tensor, cfg: SSMConfig, d_model: int):
    """x_proj's output -> (dt, B, C)."""
    dt_rank = cfg.resolved_dt_rank(d_model)
    return torch.split(xdbc, [dt_rank, cfg.d_state, cfg.d_state], dim=-1)


def _project(x: torch.Tensor, w: dict, cfg: SSMConfig, d_model: int):
    """Shared input projections. x: (B,S,D) -> (u, gate, delta, B, C)."""
    u, gate = (x @ w["in_proj"]).chunk(2, dim=-1)                 # (B,S,DI)
    u = causal_conv1d(u, w["conv"]) if x.shape[1] > 1 else u      # seq path conv
    u = F.silu(u)
    dt, Bm, Cm = split_xdbc(reduce_partial(u @ w["x_proj"]), cfg, d_model)
    delta = F.softplus(dt @ w["dt_proj"] + w["dt_bias"])          # (B,S,DI)
    return u, gate, delta, Bm, Cm


def mamba_block(x: torch.Tensor, w: dict, cfg: SSMConfig) -> torch.Tensor:
    """Full-sequence mamba block. x: (B,S,D) -> (B,S,D)."""
    A = -torch.exp(w["A_log"].to(torch.float32))                  # (DI,N)
    u, gate, delta, Bm, Cm = _project(x, w, cfg, x.shape[-1])
    y = selective_scan(u, delta, A, Bm, Cm, w["D"])
    return (y * F.silu(gate)) @ w["out_proj"]


def mamba_init_state(batch: int, d_model: int, cfg: SSMConfig,
                     dtype: torch.dtype, device=None) -> dict:
    d_inner = cfg.expand * d_model
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, d_inner), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, d_inner, cfg.d_state), dtype=torch.float32,
                           device=device),
    }


def mamba_step(x_t: torch.Tensor, state: dict, w: dict, cfg: SSMConfig
               ) -> tuple[torch.Tensor, dict]:
    """Streaming decode. x_t: (B,1,D). Returns (y (B,1,D), new_state)."""
    A = -torch.exp(w["A_log"].to(torch.float32))
    u, gate = (x_t @ w["in_proj"]).chunk(2, dim=-1)               # (B,1,DI)
    u_conv, conv_state = conv_state_update(state["conv"], u, w["conv"])
    u_act = F.silu(u_conv)[:, 0]                                  # (B,DI)
    dt, Bm, Cm = split_xdbc(reduce_partial(u_act @ w["x_proj"]), cfg,
                            x_t.shape[-1])
    delta = F.softplus(dt @ w["dt_proj"] + w["dt_bias"])          # (B,DI)
    y, ssm_state = selective_scan_step(state["ssm"], u_act, delta, A, Bm, Cm,
                                       w["D"])
    y = y[:, None] * F.silu(gate)
    return y @ w["out_proj"], {"conv": conv_state, "ssm": ssm_state}
