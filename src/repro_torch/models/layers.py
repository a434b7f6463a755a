"""Core neural layers: RMSNorm, RoPE, the gated MLP, causal (optionally
sliding-window) GQA attention, the KV caches (full and ring-buffer) and the
depthwise causal convolution of the recurrent blocks.

Softmax/normalization math runs in float32 whatever the parameter dtype, as
in the reference (``models/layers.py``); the attention scores are float32
products of the stored q/k values, with the reference's finite ``NEG_INF``
mask bias. ``attention`` here is the plain counterpart of the reference's
(the reference model trains through it); the port's model calls the flash
kernels instead, on both the training and the serving path.

The cache updates are functional, as the reference's: each returns new
tensors and leaves the cache it was given unchanged, so a serving state
handed to a checkpoint save is never written by a later decode step.
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


def rope(x: torch.Tensor, positions, *, theta: float) -> torch.Tensor:
    """Half-split rotary embedding. x: (..., S, H, hd); positions: (S,), or
    a scalar (an int or a 0-d tensor) for one decode position."""
    hd = x.shape[-1]
    half = hd // 2
    freq = torch.exp(-math.log(theta)
                     * torch.arange(half, dtype=torch.float32, device=x.device)
                     / half)
    if isinstance(positions, torch.Tensor):
        positions = positions.to(x.device).reshape(-1)
    else:   # a decode position: filled on the device, no host-to-device copy
        positions = torch.full((1,), int(positions), device=x.device)
    ang = positions.to(torch.float32)[:, None] * freq        # (S, half)
    sin = torch.sin(ang)[:, None, :]                          # (S, 1, half)
    cos = torch.cos(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def _mask_bias(qpos: torch.Tensor, kpos: torch.Tensor, *, window: int = 0,
               kv_valid_len=None) -> torch.Tensor:
    """(C,S) additive bias: causal + optional sliding window + cache
    validity."""
    m = kpos[None, :] <= qpos[:, None]
    if window:
        m &= kpos[None, :] > qpos[:, None] - window
    if kv_valid_len is not None:
        m &= kpos[None, :] < kv_valid_len
    zero = torch.zeros((), dtype=torch.float32, device=qpos.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=qpos.device)
    return torch.where(m, zero, neg)


def _gqa_scores(qg: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """qg: (B,C,KV,G,hd), k: (B,S,KV,hd) -> (B,KV,G,C,S) float32."""
    return torch.einsum("bckgh,bskh->bkgcs", qg.to(torch.float32),
                        k.to(torch.float32))


def _gqa_out(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p: (B,KV,G,C,S) float32, v: (B,S,KV,hd) -> (B,C,KV,G,hd)."""
    return torch.einsum("bkgcs,bskh->bckgh", p, v.to(torch.float32))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              q_offset: int = 0, window: int = 0, kv_valid_len=None,
              scale: float | None = None) -> torch.Tensor:
    """Causal (optionally sliding-window) GQA attention with float32 scores.

    q: (B,Sq,H,hd); k,v: (B,Skv,KV,hd), H % KV == 0; query head h reads KV
    head h // (H // KV). ``q_offset`` is the global position of q[0];
    keys at or past ``kv_valid_len`` are masked.
    """
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = (q * scale).reshape(B, Sq, KV, G, hd)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    bias = _mask_bias(qpos, torch.arange(Skv, device=q.device), window=window,
                      kv_valid_len=kv_valid_len)
    p = torch.softmax(_gqa_scores(qg, k) + bias, dim=-1)
    return _gqa_out(p, v).reshape(B, Sq, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# KV caches: full and ring-buffer (sliding window)
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, max_len: int, n_kv: int, hd: int,
                  dtype: torch.dtype, device=None) -> dict:
    shape = (batch, max_len, n_kv, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _write_rows(buf: torch.Tensor, new: torch.Tensor, start: int
                ) -> torch.Tensor:
    """A copy of ``buf`` with ``new`` written at rows ``start`` of axis 1."""
    out = buf.clone()
    out[:, start:start + new.shape[1]] = new
    return out


def cache_update_full(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                      pos: int) -> dict:
    """Insert (B,S_new,KV,hd) at position ``pos``."""
    pos = int(pos)
    return {"k": _write_rows(cache["k"], k_new, pos),
            "v": _write_rows(cache["v"], v_new, pos)}


def ring_positions(pos, window: int) -> torch.Tensor:
    """Global position held by each ring slot when the newest token is at
    global position ``pos``: slot i holds pos_i = pos - ((pos - i) mod window)."""
    i = torch.arange(window)
    return pos - torch.remainder(pos - i, window)


def cache_update_ring(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                      pos: int) -> dict:
    """Decode-time single-token ring insert at slot pos % window."""
    slot = int(pos) % cache["k"].shape[1]
    return {"k": _write_rows(cache["k"], k_new, slot),
            "v": _write_rows(cache["v"], v_new, slot)}


def ring_fill_from_prefill(k_full: torch.Tensor, v_full: torch.Tensor,
                           window: int) -> dict:
    """After prefilling S tokens, load the trailing ``window`` of them into
    ring slots (slot of global position p is p % window). With S < window
    the future slots stay zero (masked out by ring validity)."""
    B, S, KV, hd = k_full.shape
    if S < window:
        pad = (0, 0, 0, 0, 0, window - S)
        return {"k": F.pad(k_full, pad), "v": F.pad(v_full, pad)}
    base = S - window
    perm = base + torch.remainder(
        torch.arange(window, device=k_full.device) - base, window)
    return {"k": k_full.index_select(1, perm), "v": v_full.index_select(1, perm)}


def ring_valid_len(pos: int, window: int) -> int:
    """Filled slots of a ring of size ``window`` whose newest token is at
    ``pos``: every slot i < min(pos + 1, window) holds a position in
    (pos - window, pos], the others nothing yet."""
    return min(int(pos) + 1, window)


def decode_attention_ring(q: torch.Tensor, cache: dict, pos: int, *,
                          window: int, scale: float | None = None
                          ) -> torch.Tensor:
    """Single-token attention against a ring-buffer cache (the plain
    version of the reference's ``decode_attention_ring``)."""
    B, _, H, hd = q.shape
    KV = cache["k"].shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kpos = ring_positions(int(pos), window).to(q.device)
    valid = (kpos >= 0) & (kpos > pos - window) & (kpos <= pos)
    bias = torch.where(valid, 0.0, NEG_INF).to(torch.float32)
    qg = (q * scale).reshape(B, 1, KV, G, hd)
    p = torch.softmax(_gqa_scores(qg, cache["k"]) + bias, dim=-1)
    return _gqa_out(p, cache["v"]).reshape(B, 1, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# depthwise causal conv (rglru)
# ---------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B,S,C), w: (C,K) depthwise causal conv, no bias."""
    K = w.shape[-1]
    S = x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(K):                  # K is 4: unrolled shifted adds
        shift = K - 1 - i
        xi = F.pad(x, (0, 0, shift, 0))[:, :S]
        out = out + xi.to(torch.float32) * w[:, i].to(torch.float32)
    return out.to(x.dtype)


def conv_state_update(state: torch.Tensor, x_new: torch.Tensor,
                      w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming conv: state (B,K-1,C) holds the last K-1 inputs.
    x_new: (B,1,C). Returns (y (B,1,C), new_state)."""
    window = torch.cat([state, x_new], dim=1)                  # (B,K,C)
    y = torch.einsum("bkc,ck->bc", window.to(torch.float32),
                     w.to(torch.float32))[:, None]
    return y.to(x_new.dtype), window[:, 1:]
