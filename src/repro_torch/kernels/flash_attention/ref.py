"""Plain PyTorch version of the flash-attention forward: the naive
materialized softmax, the counterpart of the reference's ``attention_ref``,
also returning the log-sum-exp of each row as ``flash_attention_fwd`` does.

The query is widened to float32 and then scaled, masked scores take the
finite ``NEG_INF``, and the softmax runs in float32.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -2.0 ** 30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  scale: float | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """q: (B,Sq,H,hd); k,v: (B,Skv,KV,hd) -> (o (B,Sq,H,hd) in q's dtype,
    lse (B,H,Sq) float32). Query head h reads KV head h // (H // KV)."""
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Sq, KV, G, hd).to(torch.float32) * scale
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.to(torch.float32))
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, torch.full((), NEG_INF, dtype=torch.float32,
                                        device=q.device))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.to(torch.float32))
    return o.reshape(B, Sq, H, hd).to(q.dtype), lse.reshape(B, H, Sq)
