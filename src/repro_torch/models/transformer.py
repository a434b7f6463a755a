"""Decoder assembly: global and sliding-window attention layers with dense
(gated) MLPs, RG-LRU recurrent layers and Mamba-1 layers.

Layers are grouped into **period segments** exactly as the reference
(``models/transformer.py``) groups them: the config's ``block_pattern`` is
one period (gemma3's 5 local + 1 global, recurrentgemma's rglru, rglru,
local), and each parameter and cache is stacked over the period's repeats,
so leaf names and shapes (``params/segments/0/pos0/attn/wq`` of shape
``(n_repeats, d_model, q_dim)``, ``caches/0/pos0/k``) match the reference's
and checkpoints interchange. A Python loop over the repeats takes the place
of ``lax.scan``.

Three entry points, as in the reference: ``forward`` (teacher-forced
logits; training), ``prefill`` (the sequence plus caches; serving) and
``decode_step`` (one token). The sequence path runs attention through the
differentiable flash-attention kernels (forward, and the dkv and dq kernels
in backward), the RG-LRU through its scan kernel and Mamba through the
selective-scan kernel; decode runs attention through the flash-decode
kernel. MoE layers come with their slice and raise.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..kernels.decode_attention import flash_decode
from ..kernels.flash_attention import flash_attention
from ..kernels.ssm_scan import ssm_scan
from . import layers as L
from . import rglru as RG
from . import ssm as SSM
from .config import ModelConfig, RGLRUConfig, SSMConfig


@dataclass(frozen=True)
class Segment:
    pattern: tuple[str, ...]   # kinds at each position of one period
    n_repeats: int
    prelude: bool = False


def plan_segments(cfg: ModelConfig) -> tuple[Segment, ...]:
    """The reference's segmentation (dense configs: no MoE prelude)."""
    if cfg.moe is not None:
        raise NotImplementedError("MoE layers are not ported yet")
    kinds = list(cfg.layer_kinds())
    segs: list[Segment] = []
    p = len(cfg.block_pattern)
    n_full = len(kinds) // p
    if n_full:
        segs.append(Segment(tuple(cfg.block_pattern), n_full))
    r = len(kinds) % p
    if r:
        segs.append(Segment(tuple(kinds[-r:]), 1))
    return tuple(segs)


def _check_supported(cfg: ModelConfig) -> None:
    unsupported = set(cfg.layer_kinds()) - {"global", "local", "rglru",
                                            "mamba"}
    if unsupported:
        raise NotImplementedError(
            f"layer kinds {sorted(unsupported)} are not ported yet")
    if not cfg.embed_inputs:
        raise NotImplementedError("only token-embedding inputs are ported")


def _kind_window(cfg: ModelConfig, kind: str) -> int:
    return cfg.window if kind == "local" else 0


def _kind_theta(cfg: ModelConfig, kind: str) -> float:
    if kind == "global" and cfg.rope_theta_global:
        return cfg.rope_theta_global
    return cfg.rope_theta


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, *, seed: int = 0, device=None) -> dict:
    """Random parameters in the reference's layout, from ``seed``.

    Same distributions as the reference (normal / sqrt(fan_in), zero norm
    offsets, RG-LRU ``lam`` uniform in [0.3, 1.5), Mamba's ``A_log``,
    ``D`` and ``dt_bias`` as constants) but not its numbers:
    ``jax.random`` streams cannot be reproduced, so parity tests carry the
    reference's parameters across with ``train.state_from_numpy``. With tied
    embeddings there is no ``lm_head`` leaf.
    """
    _check_supported(cfg)
    device = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    f32 = torch.float32
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def dense(shape, fan_in=None, dt=dtype):
        fan_in = fan_in if fan_in is not None else shape[-2]
        w = torch.randn(shape, generator=gen, dtype=f32, device=device)
        return (w / math.sqrt(fan_in)).to(dt)

    def zeros(*shape):
        return torch.zeros(shape, dtype=f32, device=device)

    def mlp_params(n):
        w = {"up": dense((n, D, F_)), "down": dense((n, F_, D))}
        if cfg.mlp_gated:
            w["gate"] = dense((n, D, F_))
        return w

    def mamba_params(n, s: SSMConfig):
        DI, dt = s.expand * D, s.resolved_dt_rank(D)
        A = torch.arange(1, s.d_state + 1, dtype=f32, device=device)
        return {
            "in_proj": dense((n, D, 2 * DI)),
            "conv": dense((n, DI, s.d_conv), fan_in=s.d_conv),
            "x_proj": dense((n, DI, dt + 2 * s.d_state)),
            "dt_proj": dense((n, dt, DI)),
            "dt_bias": torch.full((n, DI), -4.6, dtype=dtype,
                                  device=device),   # softplus^-1(0.01)
            "A_log": torch.log(A).expand(n, DI, s.d_state).contiguous(),
            "D": torch.ones((n, DI), dtype=f32, device=device),
            "out_proj": dense((n, DI, D)),
        }

    D, F_ = cfg.d_model, cfg.d_ff
    params: dict[str, Any] = {"segments": []}
    for seg in plan_segments(cfg):
        n = seg.n_repeats
        seg_params = {}
        for pi, kind in enumerate(seg.pattern):
            if kind == "mamba":
                layer = {"norm1": zeros(n, D),
                         "mamba": mamba_params(n, cfg.ssm or SSMConfig())}
            elif kind == "rglru":
                r = cfg.rglru or RGLRUConfig()
                W = r.lru_width or D
                nb = r.n_blocks or cfg.n_heads
                bs = W // nb
                lam = torch.rand((n, W), generator=gen, dtype=f32,
                                 device=device) * 1.2 + 0.3
                layer = {
                    "norm1": zeros(n, D),
                    "rec": {
                        "in_x": dense((n, D, W)),
                        "in_gate": dense((n, D, W)),
                        "conv": dense((n, W, r.d_conv), fan_in=r.d_conv),
                        "lru": {"w_r": dense((n, nb, bs, bs), bs, f32),
                                "w_i": dense((n, nb, bs, bs), bs, f32),
                                "b_r": zeros(n, W), "b_i": zeros(n, W),
                                "lam": lam},
                        "out": dense((n, W, D)),
                    },
                    "norm2": zeros(n, D),
                    "mlp": mlp_params(n),
                }
            else:
                layer = {
                    "norm1": zeros(n, D),
                    "attn": {
                        "wq": dense((n, D, cfg.q_dim)),
                        "wk": dense((n, D, cfg.kv_dim)),
                        "wv": dense((n, D, cfg.kv_dim)),
                        "wo": dense((n, cfg.q_dim, D)),
                    },
                    "norm2": zeros(n, D),
                    "mlp": mlp_params(n),
                }
            seg_params[f"pos{pi}"] = layer
        params["segments"].append(seg_params)
    params["embed"] = dense((cfg.vocab_size, D), fan_in=D)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((D, cfg.vocab_size))
    params["final_norm"] = zeros(D)
    return params


# ---------------------------------------------------------------------------
# sequence path: the training forward and the prefill
# ---------------------------------------------------------------------------

def _qkv(x, w, cfg: ModelConfig, kind: str, positions):
    """Projected, rotated q (B,S,H,hd) and k, v (B,S,KV,hd)."""
    B, S, _D = x.shape
    q = (x @ w["wq"]).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = (x @ w["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ w["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    theta = _kind_theta(cfg, kind)
    return (L.rope(q, positions, theta=theta), L.rope(k, positions, theta=theta),
            v)


def _conv_window(raw: torch.Tensor, K: int) -> torch.Tensor:
    """The last K - 1 conv inputs of a sequence (zero-padded in front when
    it is shorter): the decode conv state after a prefill."""
    S = raw.shape[1]
    if S >= K - 1:
        return raw[:, S - (K - 1):]
    return F.pad(raw, (0, 0, K - 1 - S, 0))


def _mamba_seq_with_cache(x, w, scfg: SSMConfig):
    """Mamba block over the sequence, and its decode state: the raw conv
    inputs' window and the scan's last state (prefill, no gradients)."""
    A = -torch.exp(w["A_log"].to(torch.float32))
    u_raw, gate = (x @ w["in_proj"]).chunk(2, dim=-1)
    conv_state = _conv_window(u_raw, scfg.d_conv)
    u = F.silu(L.causal_conv1d(u_raw, w["conv"]))
    dt, Bm, Cm = SSM.split_xdbc(u @ w["x_proj"], scfg, x.shape[-1])
    delta = F.softplus(dt @ w["dt_proj"] + w["dt_bias"])
    y, h_last = ssm_scan(u, delta, A, Bm, Cm, w["D"])
    y = y * F.silu(gate)
    return y @ w["out_proj"], {"conv": conv_state, "ssm": h_last}


def _rglru_seq_with_cache(x, w, rcfg: RGLRUConfig):
    branch_raw = x @ w["in_x"]
    conv_state = _conv_window(branch_raw, rcfg.d_conv)
    branch = L.causal_conv1d(branch_raw, w["conv"])
    y, h_last = RG.rg_lru(branch, w["lru"])
    gate = F.gelu(x @ w["in_gate"], approximate="tanh")
    return (y * gate) @ w["out"], {"conv": conv_state, "h": h_last}


def _apply_block_seq(kind: str, w: dict, x, cfg: ModelConfig, positions, *,
                     collect_cache: bool, cache_len: int | None):
    """One layer, full sequence. Returns (x, cache or None).

    Attention of both kinds runs through the differentiable flash-attention
    kernels, Mamba through the selective-scan kernel. ``collect_cache``
    selects the prefill path, which also builds the layer's decode cache;
    without it this is the training forward."""
    cache = None
    h = L.rms_norm(x, w["norm1"], eps=cfg.norm_eps)
    if kind == "mamba":    # no channel mix: the block is the whole layer
        scfg = cfg.ssm or SSMConfig()
        if collect_cache:
            delta, cache = _mamba_seq_with_cache(h, w["mamba"], scfg)
        else:
            delta = SSM.mamba_block(h, w["mamba"], scfg)
        return x + delta, cache
    if kind in ("global", "local"):
        B, S, _ = x.shape
        q, k, v = _qkv(h, w["attn"], cfg, kind, positions)
        window = _kind_window(cfg, kind)
        out = flash_attention(q, k, v, True, window)
        x = x + out.reshape(B, S, cfg.q_dim) @ w["attn"]["wo"]
        if collect_cache:
            if kind == "local" and cfg.window:
                cache = L.ring_fill_from_prefill(k, v, cfg.window)
            else:
                pad = (cache_len or S) - S
                cache = {"k": F.pad(k, (0, 0, 0, 0, 0, max(pad, 0))),
                         "v": F.pad(v, (0, 0, 0, 0, 0, max(pad, 0)))}
    else:   # rglru
        rcfg = cfg.rglru or RGLRUConfig()
        if collect_cache:
            delta, cache = _rglru_seq_with_cache(h, w["rec"], rcfg)
        else:
            delta = RG.recurrent_block(h, w["rec"], rcfg)
        x = x + delta
    h2 = L.rms_norm(x, w["norm2"], eps=cfg.norm_eps)
    return x + L.mlp(h2, w["mlp"], act=cfg.act, gated=cfg.mlp_gated), cache


def _select(tree, r: int):
    """Layer ``r`` of a stacked subtree (views, autograd flows to the
    stacked leaves)."""
    if isinstance(tree, dict):
        return {k: _select(v, r) for k, v in tree.items()}
    return tree[r]


def _stack(trees: list):
    """Per-layer trees -> one tree stacked on a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _embed(params: dict, inputs: torch.Tensor) -> torch.Tensor:
    # index_select, whose CUDA backward (index_add_) has a deterministic
    # implementation under torch.use_deterministic_algorithms
    x = params["embed"].index_select(0, inputs.reshape(-1).to(torch.int64))
    return x.reshape(*inputs.shape, -1)


def unembed_weights(params: dict, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings and cfg.embed_inputs:
        return params["embed"].T
    return params["lm_head"]


def _sequence(params: dict, cfg: ModelConfig, inputs: torch.Tensor, *,
              collect_cache: bool, cache_len: int | None):
    """Every layer over the sequence. Returns (x before the final norm,
    caches stacked per segment and position, or None)."""
    _check_supported(cfg)
    x = _embed(params, inputs)
    positions = torch.arange(x.shape[1], device=x.device)
    caches: list[dict] = []
    for seg, seg_params in zip(plan_segments(cfg), params["segments"]):
        per_pos: dict[str, list] = {f"pos{i}": [] for i in range(len(seg.pattern))}
        for r in range(seg.n_repeats):
            for i, kind in enumerate(seg.pattern):
                x, cache = _apply_block_seq(
                    kind, _select(seg_params[f"pos{i}"], r), x, cfg, positions,
                    collect_cache=collect_cache, cache_len=cache_len)
                per_pos[f"pos{i}"].append(cache)
        if collect_cache:
            caches.append({name: _stack(cs) for name, cs in per_pos.items()})
    return x, (caches if collect_cache else None)


def forward(params: dict, cfg: ModelConfig, inputs: torch.Tensor, *,
            return_hidden: bool = False):
    """Teacher-forced training forward. inputs: token ids (B,S). Returns
    (logits (B,S,V), aux_loss), or the final-norm output in place of the
    logits with ``return_hidden`` (the fused unembed+CE owns the head).
    Every attention layer runs through the differentiable flash attention,
    so its backward is the dkv and dq kernels on the card; every Mamba and
    RG-LRU layer through its scan kernel, differentiated through the plain
    version. The cache-building path is ``prefill``."""
    x, _ = _sequence(params, cfg, inputs, collect_cache=False, cache_len=None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = L.rms_norm(x, params["final_norm"], eps=cfg.norm_eps)
    out = x if return_hidden else x @ unembed_weights(params, cfg)
    return out, aux


@torch.no_grad()
def prefill(params: dict, cfg: ModelConfig, inputs: torch.Tensor, *,
            cache_len: int | None = None):
    """Returns (logits_last (B,V), caches, next_pos). Caches are stacked per
    segment/position exactly as ``decode_step`` consumes them; pass
    ``cache_len`` > S to leave room for decoded tokens. Only the last
    position is unembedded (the reference slices it from the full logits;
    the value is the same, without a (B,S,V) tensor)."""
    x, caches = _sequence(params, cfg, inputs, collect_cache=True,
                          cache_len=cache_len)
    x = L.rms_norm(x[:, -1:], params["final_norm"], eps=cfg.norm_eps)
    return (x @ unembed_weights(params, cfg))[:, 0], caches, inputs.shape[1]


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, dtype=None,
               device=None) -> list[dict]:
    """Empty caches shaped like prefill output (stacked per segment/pos)."""
    _check_supported(cfg)
    device = resolve_device(device)
    dtype = dtype or getattr(torch, cfg.dtype)
    caches = []
    for seg in plan_segments(cfg):
        seg_cache = {}
        for pi, kind in enumerate(seg.pattern):
            if kind == "global":
                c = L.init_kv_cache(batch, max_len, cfg.n_kv_heads,
                                    cfg.head_dim, dtype, device)
            elif kind == "local":
                c = L.init_kv_cache(batch, min(cfg.window or max_len, max_len),
                                    cfg.n_kv_heads, cfg.head_dim, dtype, device)
            elif kind == "mamba":
                c = SSM.mamba_init_state(batch, cfg.d_model,
                                         cfg.ssm or SSMConfig(), dtype, device)
            else:
                r = cfg.rglru or RGLRUConfig()
                c = RG.recurrent_init_state(batch, r.lru_width or cfg.d_model,
                                            r, dtype, device)
            seg_cache[f"pos{pi}"] = _stack([c] * seg.n_repeats)
        caches.append(seg_cache)
    return caches


def _apply_block_decode(kind: str, w: dict, x, cache: dict, pos: int,
                        cfg: ModelConfig):
    """One layer, one token. x: (B,1,D). Returns (x, new_cache). Attention
    of both kinds runs through the flash-decode kernel: a full cache with
    ``pos + 1`` valid rows, a ring with its filled slots. Mamba and RG-LRU
    layers step their recurrence in plain PyTorch."""
    h = L.rms_norm(x, w["norm1"], eps=cfg.norm_eps)
    if kind == "mamba":    # no channel mix: the block is the whole layer
        delta, cache = SSM.mamba_step(h, cache, w["mamba"],
                                      cfg.ssm or SSMConfig())
        return x + delta, cache
    if kind in ("global", "local"):
        B = x.shape[0]
        q, k, v = _qkv(h, w["attn"], cfg, kind, pos)
        if kind == "local" and cfg.window:
            cache = L.cache_update_ring(cache, k, v, pos)
            valid = L.ring_valid_len(pos, cache["k"].shape[1])
        else:
            cache = L.cache_update_full(cache, k, v, pos)
            valid = pos + 1
        out = flash_decode(q, cache["k"], cache["v"], valid)
        x = x + out.reshape(B, 1, cfg.q_dim) @ w["attn"]["wo"]
    else:   # rglru
        delta, cache = RG.recurrent_step(h, cache, w["rec"],
                                         cfg.rglru or RGLRUConfig())
        x = x + delta
    h2 = L.rms_norm(x, w["norm2"], eps=cfg.norm_eps)
    return x + L.mlp(h2, w["mlp"], act=cfg.act, gated=cfg.mlp_gated), cache


@torch.no_grad()
def decode_step(params: dict, cfg: ModelConfig, inputs: torch.Tensor,
                caches: list[dict], pos: int):
    """One decode step. inputs: token ids (B,1); ``pos`` is the global
    position being written. Returns (logits (B,V), new_caches); the caches
    given are not written."""
    _check_supported(cfg)
    pos = int(pos)
    x = _embed(params, inputs)
    new_caches = []
    for seg, seg_params, seg_cache in zip(plan_segments(cfg),
                                          params["segments"], caches):
        per_pos: dict[str, list] = {f"pos{i}": [] for i in range(len(seg.pattern))}
        for r in range(seg.n_repeats):
            for i, kind in enumerate(seg.pattern):
                x, c = _apply_block_decode(
                    kind, _select(seg_params[f"pos{i}"], r), x,
                    _select(seg_cache[f"pos{i}"], r), pos, cfg)
                per_pos[f"pos{i}"].append(c)
        new_caches.append({name: _stack(cs) for name, cs in per_pos.items()})
    x = L.rms_norm(x, params["final_norm"], eps=cfg.norm_eps)
    return (x @ unembed_weights(params, cfg))[:, 0], new_caches
