"""Decoder assembly: the dense global-attention path.

Layers are grouped into **period segments** exactly as the reference
(``models/transformer.py``) groups them: the config's ``block_pattern`` is
one period, and each parameter is stacked over the period's repeats, so leaf
names and shapes (``params/segments/0/pos0/attn/wq`` of shape
``(n_layers, d_model, q_dim)``) match the reference's and checkpoints
interchange. A Python loop over the repeats takes the place of ``lax.scan``.

This slice runs the ``"global"`` layer kind with a dense (gated) MLP and
untied input embeddings; other kinds come with their slices and raise.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from ..device import resolve_device
from . import layers as L
from .config import ModelConfig


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
    unsupported = set(cfg.layer_kinds()) - {"global"}
    if unsupported:
        raise NotImplementedError(
            f"layer kinds {sorted(unsupported)} are not ported yet")
    if not cfg.embed_inputs or cfg.tie_embeddings:
        raise NotImplementedError("only untied token embeddings are ported")


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
    offsets) but not its numbers: ``jax.random`` streams cannot be
    reproduced, so parity tests carry the reference's parameters across
    with ``train.state_from_numpy``.
    """
    _check_supported(cfg)
    device = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def dense(shape, fan_in=None, dt=dtype):
        fan_in = fan_in if fan_in is not None else shape[-2]
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return (w / math.sqrt(fan_in)).to(dt)

    D, F_ = cfg.d_model, cfg.d_ff
    params: dict[str, Any] = {"segments": []}
    for seg in plan_segments(cfg):
        n = seg.n_repeats
        seg_params = {}
        for pi, _kind in enumerate(seg.pattern):
            layer = {
                "norm1": torch.zeros((n, D), dtype=torch.float32, device=device),
                "attn": {
                    "wq": dense((n, D, cfg.q_dim)),
                    "wk": dense((n, D, cfg.kv_dim)),
                    "wv": dense((n, D, cfg.kv_dim)),
                    "wo": dense((n, cfg.q_dim, D)),
                },
                "norm2": torch.zeros((n, D), dtype=torch.float32, device=device),
                "mlp": {"up": dense((n, D, F_)), "down": dense((n, F_, D))},
            }
            if cfg.mlp_gated:
                layer["mlp"]["gate"] = dense((n, D, F_))
            seg_params[f"pos{pi}"] = layer
        params["segments"].append(seg_params)
    params["embed"] = dense((cfg.vocab_size, D), fan_in=D)
    params["lm_head"] = dense((D, cfg.vocab_size))
    params["final_norm"] = torch.zeros((D,), dtype=torch.float32, device=device)
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _attn_mix(x, w, cfg: ModelConfig, kind: str, positions):
    B, S, _D = x.shape
    q = (x @ w["wq"]).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = (x @ w["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ w["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    theta = _kind_theta(cfg, kind)
    q = L.rope(q, positions, theta=theta)
    k = L.rope(k, positions, theta=theta)
    out = L.attention(q, k, v)
    return out.reshape(B, S, cfg.q_dim) @ w["wo"]


def _apply_block(kind: str, w: dict, x, cfg: ModelConfig, positions):
    h = L.rms_norm(x, w["norm1"], eps=cfg.norm_eps)
    x = x + _attn_mix(h, w["attn"], cfg, kind, positions)
    h2 = L.rms_norm(x, w["norm2"], eps=cfg.norm_eps)
    return x + L.mlp(h2, w["mlp"], act=cfg.act, gated=cfg.mlp_gated)


def _select(tree, r: int):
    """Layer ``r`` of a stacked parameter subtree (views, autograd flows to
    the stacked leaves)."""
    if isinstance(tree, dict):
        return {k: _select(v, r) for k, v in tree.items()}
    return tree[r]


def unembed_weights(params: dict, cfg: ModelConfig) -> torch.Tensor:
    return params["lm_head"]


def forward(params: dict, cfg: ModelConfig, inputs: torch.Tensor, *,
            return_hidden: bool = False):
    """Teacher-forced forward. inputs: token ids (B,S). Returns
    (logits (B,S,V), aux_loss), or the final-norm output in place of the
    logits with ``return_hidden`` (the fused unembed+CE owns the head)."""
    _check_supported(cfg)
    # index_select, whose CUDA backward (index_add_) has a deterministic
    # implementation under torch.use_deterministic_algorithms
    x = params["embed"].index_select(0, inputs.reshape(-1).to(torch.int64))
    x = x.reshape(*inputs.shape, -1)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    for seg, seg_params in zip(plan_segments(cfg), params["segments"]):
        for r in range(seg.n_repeats):
            for i, kind in enumerate(seg.pattern):
                x = _apply_block(kind, _select(seg_params[f"pos{i}"], r), x,
                                 cfg, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = L.rms_norm(x, params["final_norm"], eps=cfg.norm_eps)
    if return_hidden:
        return x, aux
    return x @ unembed_weights(params, cfg), aux
