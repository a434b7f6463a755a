"""Plain PyTorch version of flash decode: one query token against a KV
cache, keys at or past ``valid_len`` masked with the finite ``NEG_INF``;
the counterpart of the reference's ``decode_attention_ref``."""

from __future__ import annotations

import math

import torch

NEG_INF = -2.0 ** 30


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         valid_len: int, *, scale: float | None = None
                         ) -> torch.Tensor:
    """q: (B,H,hd); k,v: (B,S,KV,hd) -> (B,H,hd) in q's dtype."""
    B, H, hd = q.shape
    _, S, KV, _ = k.shape
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, KV, G, hd).to(torch.float32) * scale
    s = torch.einsum("bkgh,bskh->bkgs", qg, k.to(torch.float32))
    mask = torch.arange(S, device=q.device) < valid_len
    s = torch.where(mask, s, torch.full((), NEG_INF, dtype=torch.float32,
                                        device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p, v.to(torch.float32))
    return o.reshape(B, H, hd).to(q.dtype)
