"""RG-LRU recurrent block (RecurrentGemma / Griffin).

Recurrence (per channel):
    r_t = sigmoid(W_r x_t + b_r)           (recurrence gate, block-diag W)
    i_t = sigmoid(W_i x_t + b_i)           (input gate, block-diag W)
    a_t = exp(-c * softplus(Λ) * r_t)      (c = 8.0)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

The full recurrent block is: x -> [linear -> conv1d -> RG-LRU] ⊙ gelu(linear)
-> linear, mirroring Griffin's temporal-mixing block. The sequence path runs
the recurrence through ``kernels.rglru_scan.lru_scan`` (the CUDA kernel on
the card, its plain sequential version on the CPU; gradients through the
plain version, as the reference's kernel wrapper has them) where the
reference runs an associative scan; decode carries (conv window, h) — O(1)
state.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.rglru_scan import lru_scan
from .config import RGLRUConfig
from .layers import causal_conv1d, conv_state_update

_C = 8.0


def _block_diag_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                       ) -> torch.Tensor:
    """x: (...,W); w: (nb, W/nb, W/nb); b: (W,)."""
    nb, bs, _ = w.shape
    xs = x.reshape(*x.shape[:-1], nb, bs)
    y = torch.einsum("...nb,nbc->...nc", xs, w)
    return y.reshape(*x.shape[:-1], nb * bs) + b


def _gates(x: torch.Tensor, w: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (a_t, gated_input) for the recurrence, float32."""
    xf = x.to(torch.float32)
    f32 = torch.float32
    r = torch.sigmoid(_block_diag_linear(xf, w["w_r"].to(f32), w["b_r"].to(f32)))
    i = torch.sigmoid(_block_diag_linear(xf, w["w_i"].to(f32), w["b_i"].to(f32)))
    log_a = -_C * F.softplus(w["lam"].to(f32)) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 0.0, 1.0))
    return a, beta * (i * xf)


def rg_lru(x: torch.Tensor, w: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequence RG-LRU from a zero state. x: (B,S,W) -> (y (B,S,W),
    h_last (B,W) float32). The gates are float32, so the scan's float32
    h[:, -1] is its last state."""
    a, bx = _gates(x, w)
    h = lru_scan(a, bx)
    return h.to(x.dtype), h[:, -1]


def rg_lru_step(x_t: torch.Tensor, h: torch.Tensor, w: dict
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x_t: (B,W); h: (B,W) float32. Returns (y (B,W), h_new)."""
    a, bx = _gates(x_t, w)
    h_new = a * h + bx
    return h_new.to(x_t.dtype), h_new


def recurrent_block(x: torch.Tensor, w: dict, cfg: RGLRUConfig) -> torch.Tensor:
    """Griffin temporal-mixing block, sequence path. x: (B,S,D) -> (B,S,D)."""
    branch = causal_conv1d(x @ w["in_x"], w["conv"])          # (B,S,W)
    y, _ = rg_lru(branch, w["lru"])
    gate = F.gelu(x @ w["in_gate"], approximate="tanh")
    return (y * gate) @ w["out"]


def recurrent_init_state(batch: int, width: int, cfg: RGLRUConfig,
                         dtype: torch.dtype, device=None) -> dict:
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, width), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, width), dtype=torch.float32, device=device),
    }


def recurrent_step(x_t: torch.Tensor, state: dict, w: dict, cfg: RGLRUConfig
                   ) -> tuple[torch.Tensor, dict]:
    """x_t: (B,1,D). Returns (y (B,1,D), new_state)."""
    branch = x_t @ w["in_x"]                                  # (B,1,W)
    branch, conv_state = conv_state_update(state["conv"], branch, w["conv"])
    y, h = rg_lru_step(branch[:, 0], state["h"], w["lru"])
    gate = F.gelu(x_t @ w["in_gate"], approximate="tanh")
    out = (y[:, None] * gate) @ w["out"]
    return out, {"conv": conv_state, "h": h}
