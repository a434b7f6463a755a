"""Plain PyTorch versions of the flash-attention kernels, with the scores
materialised: the forward (the counterpart of the reference's
``attention_ref``, also returning the log-sum-exp of each row as
``flash_attention_fwd`` does) and the two passes of the backward (dkv and
dq, from the forward's log-sum-exp and ``D = rowsum(dO * O)``).

The query is widened to float32 and then scaled, masked scores take the
finite ``NEG_INF`` (the backward's masked probabilities are 0), and every
product and softmax runs in float32.
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
    mask = _mask(Sq, Skv, causal, window, q.device)
    s = torch.where(mask, s, torch.full((), NEG_INF, dtype=torch.float32,
                                        device=q.device))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.to(torch.float32))
    return o.reshape(B, Sq, H, hd).to(q.dtype), lse.reshape(B, H, Sq)


def _mask(Sq: int, Skv: int, causal: bool, window: int, device
          ) -> torch.Tensor:
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return mask


def _grads(q, k, v, do, lse, dsum, causal, window, scale):
    """The backward's materialised pieces: the scaled float32 q and the
    float32 dO as (B,Sq,KV,G,hd), and P = exp(S - lse) (0 where masked) and
    dS = P * (dP - D) as (B,KV,G,Sq,Skv)."""
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    f32 = torch.float32
    qg = q.reshape(B, Sq, KV, G, hd).to(f32) * scale
    dog = do.reshape(B, Sq, KV, G, hd).to(f32)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.to(f32))
    mask = _mask(Sq, Skv, causal, window, q.device)
    p = torch.where(mask, torch.exp(s - lse.reshape(B, KV, G, Sq)[..., None]),
                    torch.zeros((), dtype=f32, device=q.device))
    dp = torch.einsum("bqkgh,bskh->bkgqs", dog, v.to(f32))
    ds = p * (dp - dsum.reshape(B, KV, G, Sq)[..., None])
    return qg, dog, p, ds, scale


def attention_dkv_ref(q, k, v, do, lse, dsum, *, causal: bool = True,
                      window: int = 0, scale: float | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The dkv pass: dK = dS^T (q * scale), dV = P^T dO per *query* head,
    float32 (B,Skv,H,hd). lse, dsum: (B,H,Sq) float32."""
    qg, dog, p, ds, _ = _grads(q, k, v, do, lse, dsum, causal, window, scale)
    B, Skv, H, hd = k.shape[0], k.shape[1], q.shape[2], q.shape[3]
    dk = torch.einsum("bkgqs,bqkgh->bskgh", ds, qg).reshape(B, Skv, H, hd)
    dv = torch.einsum("bkgqs,bqkgh->bskgh", p, dog).reshape(B, Skv, H, hd)
    return dk, dv


def attention_dq_ref(q, k, v, do, lse, dsum, *, causal: bool = True,
                     window: int = 0, scale: float | None = None
                     ) -> torch.Tensor:
    """The dq pass: dQ = (dS K) * scale in q's dtype, (B,Sq,H,hd)."""
    _qg, _dog, _p, ds, scale = _grads(q, k, v, do, lse, dsum, causal, window,
                                      scale)
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, k.to(torch.float32)) * scale
    return dq.reshape(q.shape).to(q.dtype)


def attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                      window: int = 0, scale: float | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain two-pass backward with the scores materialised, the
    counterpart of the reference's ``flash_attention_bwd``: from the
    forward's ``o`` and ``lse`` (B,H,Sq) and the output gradient ``do``,
    returns (dq in q's dtype, dk and dv summed over each KV head's group of
    query heads, in k's and v's dtypes)."""
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    dsum = torch.sum(do.to(torch.float32) * o.to(torch.float32), dim=-1)
    dsum = dsum.transpose(1, 2)                                  # (B,H,Sq)
    qg, dog, p, ds, scale = _grads(q, k, v, do, lse, dsum, causal, window,
                                   scale)
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qg)
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, dog)
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, k.to(torch.float32)) * scale
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
