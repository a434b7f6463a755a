"""Core neural layers of the dense global-attention path: RMSNorm, RoPE, the
gated MLP and causal GQA attention.

Softmax/normalization math runs in float32 whatever the parameter dtype, as
in the reference (``models/layers.py``); the attention scores are float32
products of the stored q/k values, with the reference's finite ``NEG_INF``
mask bias.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -2.0 ** 30  # large-but-finite; avoids NaNs from (-inf) - (-inf)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm scaled by ``1 + weight`` (weights stored as offsets from 1)."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + weight.to(torch.float32))).to(x.dtype)


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default
    if kind == "relu":
        return F.relu(x)
    if kind == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(f"unknown activation {kind!r}")


def mlp(x: torch.Tensor, w: dict, *, act: str, gated: bool) -> torch.Tensor:
    """w: {"up": (D,F), "down": (F,D)[, "gate": (D,F)]}; x: (..., D)."""
    up = x @ w["up"]
    h = activation(x @ w["gate"], act) * up if gated else activation(up, act)
    return h @ w["down"]


def rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float
         ) -> torch.Tensor:
    """Half-split rotary embedding. x: (..., S, H, hd); positions: (S,)."""
    hd = x.shape[-1]
    half = hd // 2
    freq = torch.exp(-math.log(theta)
                     * torch.arange(half, dtype=torch.float32, device=x.device)
                     / half)
    ang = positions.to(torch.float32)[:, None] * freq        # (S, half)
    sin = torch.sin(ang)[:, None, :]                          # (S, 1, half)
    cos = torch.cos(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def _mask_bias(qpos: torch.Tensor, kpos: torch.Tensor) -> torch.Tensor:
    """(C,S) additive causal bias."""
    m = kpos[None, :] <= qpos[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=qpos.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=qpos.device)
    return torch.where(m, zero, neg)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              q_offset: int = 0, scale: float | None = None) -> torch.Tensor:
    """Causal GQA attention with float32 scores.

    q: (B,Sq,H,hd); k,v: (B,Skv,KV,hd), H % KV == 0; query head h reads KV
    head h // (H // KV). ``q_offset`` is the global position of q[0].
    """
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = (q * scale).reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bckgh,bskh->bkgcs", qg.to(torch.float32),
                     k.to(torch.float32))
    qpos = q_offset + torch.arange(Sq, device=q.device)
    s = s + _mask_bias(qpos, torch.arange(Skv, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgcs,bskh->bckgh", p, v.to(torch.float32))
    return out.reshape(B, Sq, H, hd).to(q.dtype)
