"""Plain PyTorch versions of flash decode.

``decode_attention_ref``: one query token against a KV cache, keys at or
past ``valid_len`` masked with the finite ``NEG_INF``; the counterpart of
the reference's ``decode_attention_ref``, and what ``flash_decode`` runs
for CPU tensors.

``decode_partials_ref`` / ``decode_merge_ref``: the CUDA kernels'
algorithm step by step (split over the cache, one online-softmax rescale
per key tile in the log2 domain, each dot product scaled by
scale * log2(e), then the partials merged in split order), so the CPU tests can hold the split and
merge arithmetic against the reference and its Pallas kernel.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -2.0 ** 30
LOG2E = 1.4426950408889634


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


def decode_partials_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        valid_len: int, splits: int, keys_per_split: int,
                        tile: int) -> torch.Tensor:
    """The split pass: split s reduces keys [s * keys_per_split,
    min((s + 1) * keys_per_split, valid_len)) in tiles of ``tile`` keys.
    Returns float32 partials (B, H, splits, hd + 2): the unnormalised
    accumulator, then the running max m and sum l, both in the log2
    domain (each dot product scaled by log2(e) / sqrt(hd) as the kernel
    scales it)."""
    B, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qscale = torch.tensor(LOG2E / math.sqrt(hd), dtype=torch.float32)
    qf = q.reshape(B, KV, G, hd).to(torch.float32)
    ws = torch.empty((B, KV, G, splits, hd + 2), dtype=torch.float32,
                     device=q.device)
    for s in range(splits):
        lo, hi = s * keys_per_split, min((s + 1) * keys_per_split, valid_len)
        m = torch.full((B, KV, G), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, KV, G), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, KV, G, hd), dtype=torch.float32, device=q.device)
        for t in range(lo, hi, tile):
            kt = k[:, t:min(t + tile, hi)].to(torch.float32)
            vt = v[:, t:min(t + tile, hi)].to(torch.float32)
            st = torch.einsum("bkgh,bnkh->bkgn", qf, kt) * qscale
            m_new = torch.maximum(m, st.amax(dim=-1))
            p = torch.exp2(st - m_new[..., None])
            alpha = torch.exp2(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bkgn,bnkh->bkgh", p, vt)
            m = m_new
        ws[..., s, :hd] = acc
        ws[..., s, hd] = m
        ws[..., s, hd + 1] = l
    return ws.reshape(B, H, splits, hd + 2)


def decode_merge_ref(ws: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The merge pass: (B, H, splits, hd + 2) float32 partials -> (B, H, hd)
    of ``dtype``, the splits summed in order with weights 2^(m_s - max m)
    and the reference's guard (a sum of 0 divides by 1)."""
    hd = ws.shape[-1] - 2
    mx = ws[..., hd].amax(dim=-1)
    acc = torch.zeros(ws.shape[:2] + (hd,), dtype=torch.float32, device=ws.device)
    l = torch.zeros(ws.shape[:2], dtype=torch.float32, device=ws.device)
    for s in range(ws.shape[2]):
        f = torch.exp2(ws[:, :, s, hd] - mx)
        l = l + ws[:, :, s, hd + 1] * f
        acc = acc + ws[:, :, s, :hd] * f[..., None]
    l = torch.where(l == 0, torch.ones_like(l), l)
    return (acc / l[..., None]).to(dtype)
