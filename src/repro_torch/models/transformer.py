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
kernel. MoE layers route their tokens through ``moe.moe_block`` on the
sequence path and evaluate every expert (``moe.moe_block_dense``, exact
and dropless) in decode; a dense-MLP prelude (DeepSeek-MoE's first layer)
is its own segment. Archs without token embeddings (``embed_inputs=False``:
musicgen, llava) take ``(B, S, D)`` frontend embeddings, cast to the
model's dtype, and always have an ``lm_head``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.utils.checkpoint import (checkpoint,
                                     create_selective_checkpoint_contexts)

from ..device import resolve_device
from ..distributed.sharding import (addressable_shard_spans, gather_for_use,
                                    keep_rules, reduce_partial, shard_act)
from ..kernels import _local
from ..kernels.decode_attention import flash_decode
from ..kernels.flash_attention import flash_attention
from ..kernels.ssm_scan import ssm_scan
from . import layers as L
from . import moe as MOE
from . import rglru as RG
from . import ssm as SSM
from .config import ModelConfig, MoEConfig, RGLRUConfig, SSMConfig


@dataclass(frozen=True)
class Segment:
    pattern: tuple[str, ...]   # kinds at each position of one period
    n_repeats: int
    prelude: bool = False


def plan_segments(cfg: ModelConfig) -> tuple[Segment, ...]:
    """The reference's segmentation: a dense-MLP prelude segment for MoE
    configs that have one, then the period's repeats, then its remainder."""
    kinds = list(cfg.layer_kinds())
    segs: list[Segment] = []
    start = 0
    if cfg.moe is not None and cfg.moe.dense_prelude_layers:
        start = cfg.moe.dense_prelude_layers
        segs.append(Segment(tuple(kinds[:start]), 1, prelude=True))
    rest = kinds[start:]
    p = len(cfg.block_pattern)
    n_full = len(rest) // p
    if n_full:
        segs.append(Segment(tuple(cfg.block_pattern), n_full))
    r = len(rest) % p
    if r:
        segs.append(Segment(tuple(rest[-r:]), 1))
    return tuple(segs)


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
    embeddings there is no ``lm_head`` leaf; without token embeddings there
    is no ``embed`` leaf. Every stacked leaf is drawn one repeat at a time,
    so the float32 draw of a leaf never exists whole (at deepseek-moe-16b's
    width one expert leaf is 19.9 GB in float32, at minitron-8b's one MLP
    leaf 8.6 GB). On the meta device nothing is drawn or allocated
    (``model.param_specs``).
    """
    device = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    f32 = torch.float32
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)

    def draw(shape, fan_in, dt):
        w = torch.randn(shape, generator=gen, dtype=f32, device=device)
        return w.div_(math.sqrt(fan_in)).to(dt)

    def dense(shape, fan_in=None, dt=dtype):
        """normal / sqrt(fan_in); a stacked (n, ...) leaf a repeat at a time"""
        fan_in = fan_in if fan_in is not None else shape[-2]
        if len(shape) == 2:                      # embed, lm_head: not stacked
            return draw(shape, fan_in, dt)
        out = torch.empty(shape, dtype=dt, device=device)
        for r in range(shape[0]):
            out[r] = draw(shape[1:], fan_in, dt)
        return out

    def zeros(*shape):
        return torch.zeros(shape, dtype=f32, device=device)

    def mlp_params(n, d_ff):
        w = {"up": dense((n, D, d_ff)), "down": dense((n, d_ff, D))}
        if cfg.mlp_gated:
            w["gate"] = dense((n, D, d_ff))
        return w

    def moe_params(n, m: MoEConfig):
        E, Fe = m.n_experts, m.d_expert
        w = {"router": dense((n, D, E), dt=f32),
             "experts": {"up": dense((n, E, D, Fe), D),
                         "down": dense((n, E, Fe, D), Fe)}}
        if cfg.mlp_gated:
            w["experts"]["gate"] = dense((n, E, D, Fe), D)
        if m.n_shared:
            w["shared"] = mlp_params(n, m.n_shared * Fe)
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
                    "mlp": mlp_params(n, F_),
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
                }
                if cfg.moe is not None and not seg.prelude:
                    layer["moe"] = moe_params(n, cfg.moe)
                else:
                    layer["mlp"] = mlp_params(
                        n, cfg.moe.d_ff_prelude if seg.prelude else F_)
            seg_params[f"pos{pi}"] = layer
        params["segments"].append(seg_params)
    if cfg.embed_inputs:
        params["embed"] = dense((cfg.vocab_size, D), fan_in=D)
    if not (cfg.tie_embeddings and cfg.embed_inputs):
        params["lm_head"] = dense((D, cfg.vocab_size))
    params["final_norm"] = zeros(D)
    return params


# ---------------------------------------------------------------------------
# sequence path: the training forward and the prefill
# ---------------------------------------------------------------------------

def _qkv(x, w, cfg: ModelConfig, kind: str, positions):
    """Projected, rotated q (B,S,H,hd) and k, v (B,S,KV,hd)."""
    x = _local.whole_rows(x)
    q = _local.split_heads(x @ w["wq"], cfg.n_heads)
    k = _local.split_heads(x @ w["wk"], cfg.n_kv_heads)
    v = _local.split_heads(x @ w["wv"], cfg.n_kv_heads)
    theta = _kind_theta(cfg, kind)
    return (L.rope(q, positions, theta=theta), L.rope(k, positions, theta=theta),
            v)


def _conv_window(raw: torch.Tensor, K: int) -> torch.Tensor:
    """The last K - 1 conv inputs of a sequence (zero-padded in front when
    it is shorter): the decode conv state after a prefill. A copy: a view
    would keep the whole (B, S, C) projection alive in the cache, every
    layer's until its segment's caches are stacked."""
    S = raw.shape[1]
    if S >= K - 1:
        return raw[:, S - (K - 1):].clone()
    return F.pad(raw, (0, 0, K - 1 - S, 0))


def _mamba_seq_with_cache(x, w, scfg: SSMConfig):
    """Mamba block over the sequence, and its decode state: the raw conv
    inputs' window and the scan's last state (prefill, no gradients)."""
    A = -torch.exp(w["A_log"].to(torch.float32))
    u_raw, gate = (x @ w["in_proj"]).chunk(2, dim=-1)
    conv_state = _conv_window(u_raw, scfg.d_conv)
    u = F.silu(L.causal_conv1d(u_raw, w["conv"]))
    dt, Bm, Cm = SSM.split_xdbc(reduce_partial(u @ w["x_proj"]), scfg,
                                x.shape[-1])
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


def _channel_mix(x, w: dict, cfg: ModelConfig, *, decode: bool = False):
    """MLP or MoE residual branch. Returns (delta, aux loss or None). A
    decode step runs the exact, dropless MoE."""
    if "moe" not in w:
        return L.mlp(_local.whole_rows(x), w["mlp"], act=cfg.act,
                     gated=cfg.mlp_gated), None
    if decode:
        return MOE.moe_block_dense(x, w["moe"], cfg.moe, act=cfg.act,
                                   gated=cfg.mlp_gated), None
    return MOE.moe_block(x, w["moe"], cfg.moe, act=cfg.act,
                         gated=cfg.mlp_gated)


def _apply_block_seq(kind: str, w: dict, x, cfg: ModelConfig, positions, *,
                     collect_cache: bool, cache_len: int | None):
    """One layer, full sequence. Returns (x, aux loss or None, cache or
    None).

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
        return shard_act(x + delta, "residual"), None, cache
    if kind in ("global", "local"):
        B, S, _ = x.shape
        q, k, v = _qkv(h, w["attn"], cfg, kind, positions)
        q = shard_act(q, "heads")
        k = shard_act(k, "kv_heads")
        v = shard_act(v, "kv_heads")
        window = _kind_window(cfg, kind)
        out = flash_attention(q, k, v, True, window)
        x = shard_act(x + _local.merge_heads(out) @ w["attn"]["wo"],
                      "residual")
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
        x = shard_act(x + delta, "residual")
    h2 = L.rms_norm(x, w["norm2"], eps=cfg.norm_eps)
    delta, aux = _channel_mix(h2, w, cfg)
    return shard_act(x + delta, "residual"), aux, cache


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


def _embed(params: dict, cfg: ModelConfig, inputs: torch.Tensor
           ) -> torch.Tensor:
    """Token ids (B,S) through the embedding, or frontend embeddings
    (B,S,D) cast to the model's dtype (``embed_inputs=False``)."""
    if not cfg.embed_inputs:
        return shard_act(inputs.to(getattr(torch, cfg.dtype)), "residual")
    if _local.any_dtensor(params["embed"], inputs):
        return shard_act(_embed_sharded(params["embed"], inputs), "residual")
    # index_select, whose CUDA backward (index_add_) has a deterministic
    # implementation under torch.use_deterministic_algorithms
    x = params["embed"].index_select(0, inputs.reshape(-1).to(torch.int64))
    return x.reshape(*inputs.shape, -1)


def _embed_sharded(table, inputs):
    """The lookup on local shards, as the reference's partitioner runs it.
    On a mesh dim that shards the table (its vocabulary rows on the model
    axis; under FSDP its columns on the data axes) each rank takes every id
    of that dim and looks them up in its own shard: its columns are a shard
    of the output's last dim, and its rows give zeros for the ids they do
    not hold, summed over that dim (a ``Partial`` result, the reference's
    one-hot gather under SPMD). On a dim that replicates the table each
    rank looks up its own ids. So the table is never gathered, and its
    gradient is reduced only over the dims that split the ids and
    replicate the table (the data ranks' partial sums)."""
    mesh = _local.mesh_of((table, inputs))
    table, inputs = _local.as_dtensor(table, mesh), _local.as_dtensor(inputs, mesh)
    ids_pl, out_pl, grad_pl = [], [], []
    for t, i in zip(table.placements, inputs.placements):
        batch = isinstance(i, Shard) and i.dim == 0
        if isinstance(t, Shard):
            ids_pl.append(Replicate())
            out_pl.append(Partial() if t.dim == 0 else Shard(inputs.ndim))
            grad_pl.append(t)
        else:
            ids_pl.append(Shard(0) if batch else Replicate())
            out_pl.append(Shard(0) if batch else Replicate())
            grad_pl.append(Partial() if batch else Replicate())
    tl = _local.local_of(table, table.placements, grad_pl)
    il = _local.local_of(inputs, ids_pl)
    (region,) = addressable_shard_spans(mesh, table.placements, table.shape)
    v0, v1 = region[0]
    ids = il.reshape(-1).to(torch.int64)
    rows = (v0, v1) != (0, table.shape[0])
    if rows:
        hit = (ids >= v0) & (ids < v1)
        ids = torch.where(hit, ids - v0, 0)
    x = tl.index_select(0, ids)
    if rows:
        x = x * hit[:, None].to(x.dtype)
    return _local.wrap(x.reshape(*il.shape, -1), mesh, out_pl,
                       (*inputs.shape, table.shape[1]))


def unembed_weights(params: dict, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings and cfg.embed_inputs:
        return params["embed"].T
    return params["lm_head"]


REMAT_MODES = ("none", "dots", "full")

# the products whose outputs ``remat="dots"`` keeps: unbatched matmuls, the
# counterpart of jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims
# (a (B, S, D) @ (D, F) product runs as one aten.mm on the flattened rows)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_context():
    return create_selective_checkpoint_contexts(list(_DOTS))


def _period(seg: Segment, cfg: ModelConfig, positions, *, collect_cache: bool,
            cache_len: int | None):
    """One repeat of ``seg``'s pattern (the reference's ``period_body``):
    (x, the period's layer params {pos{i}: ...}) -> (x, each layer's aux
    loss or None, each layer's cache or None)."""
    def body(x, layer_params):
        # FSDP's gather at use: inside the (checkpointed) period, so remat
        # gathers again in backward, as the reference's scan body does
        layer_params = gather_for_use(layer_params)
        auxes, caches = [], []
        for i, kind in enumerate(seg.pattern):
            x, aux, cache = _apply_block_seq(
                kind, layer_params[f"pos{i}"], x, cfg, positions,
                collect_cache=collect_cache, cache_len=cache_len)
            auxes.append(aux)
            caches.append(cache)
        return x, auxes, caches
    return body


def _sequence(params: dict, cfg: ModelConfig, inputs: torch.Tensor, *,
              collect_cache: bool, cache_len: int | None,
              remat: str = "none"):
    """Every layer over the sequence. Returns (x before the final norm,
    the MoE layers' summed aux loss, caches stacked per segment and
    position, or None).

    With ``remat`` other than ``"none"`` each period runs under a
    non-reentrant checkpoint: ``"full"`` keeps only the period's input and
    recomputes the rest in backward, ``"dots"`` also keeps the outputs of
    its unbatched products and recomputes everything else, attention
    included. The backward graph, its ops and their order are those of
    ``"none"``; only where each saved tensor comes from changes."""
    if remat not in REMAT_MODES:
        raise ValueError(f"remat must be one of {REMAT_MODES}, got {remat!r}")
    x = _embed(params, cfg, inputs)
    positions = torch.arange(x.shape[1], device=x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    caches: list[dict] = []
    for seg, seg_params in zip(plan_segments(cfg), params["segments"]):
        body = keep_rules(_period(seg, cfg, positions,
                                  collect_cache=collect_cache,
                                  cache_len=cache_len))
        per_pos: dict[str, list] = {f"pos{i}": [] for i in range(len(seg.pattern))}
        seg_params = gather_for_use(seg_params, dims={0})
        for r in range(seg.n_repeats):
            layer_params = {name: _select(sub, r)
                            for name, sub in seg_params.items()}
            if remat == "none":
                x, auxes, cs = body(x, layer_params)
            else:
                kw = {"context_fn": _dots_context} if remat == "dots" else {}
                # no randomness in a period: no RNG state to replay
                x, auxes, cs = checkpoint(body, x, layer_params,
                                          use_reentrant=False,
                                          preserve_rng_state=False, **kw)
            for i, (aux, cache) in enumerate(zip(auxes, cs)):
                if aux is not None:
                    aux_total = aux_total + aux
                per_pos[f"pos{i}"].append(cache)
        if collect_cache:
            caches.append({name: _stack(cs) for name, cs in per_pos.items()})
    return x, aux_total, (caches if collect_cache else None)


def forward(params: dict, cfg: ModelConfig, inputs: torch.Tensor, *,
            remat: str = "none", return_hidden: bool = False):
    """Teacher-forced training forward. inputs: token ids (B,S), or
    embeddings (B,S,D) for archs without token embeddings. Returns
    (logits (B,S,V), aux_loss summed over the MoE layers), or the
    final-norm output in place of the logits with ``return_hidden`` (the
    fused unembed+CE owns the head).
    Every attention layer runs through the differentiable flash attention,
    so its backward is the dkv and dq kernels on the card; every Mamba and
    RG-LRU layer through its scan kernel, differentiated through the plain
    version. ``remat`` (``"none"``, ``"dots"`` or ``"full"``) recomputes
    each period in backward (``_sequence``); a recomputed attention layer
    launches its forward kernel again. The cache-building path is
    ``prefill``."""
    x, aux, _ = _sequence(params, cfg, inputs, collect_cache=False,
                          cache_len=None, remat=remat)
    x = L.rms_norm(x, gather_for_use(params["final_norm"]), eps=cfg.norm_eps)
    out = x if return_hidden else shard_act(
        x @ gather_for_use(unembed_weights(params, cfg)), "logits")
    return out, aux


@torch.no_grad()
def prefill(params: dict, cfg: ModelConfig, inputs: torch.Tensor, *,
            cache_len: int | None = None):
    """Returns (logits_last (B,V), caches, next_pos). Caches are stacked per
    segment/position exactly as ``decode_step`` consumes them; pass
    ``cache_len`` > S to leave room for decoded tokens. Only the last
    position is unembedded (the reference slices it from the full logits;
    the value is the same, without a (B,S,V) tensor)."""
    x, _aux, caches = _sequence(params, cfg, inputs, collect_cache=True,
                                cache_len=cache_len)
    x = L.rms_norm(x[:, -1:], gather_for_use(params["final_norm"]),
                   eps=cfg.norm_eps)
    logits = shard_act(x @ gather_for_use(unembed_weights(params, cfg)),
                       "logits")
    return logits[:, 0], caches, inputs.shape[1]


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, dtype=None,
               device=None) -> list[dict]:
    """Empty caches shaped like prefill output (stacked per segment/pos)."""
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
                        cfg: ModelConfig, donate: bool = False):
    """One layer, one token. x: (B,1,D). Returns (x, new_cache). Attention
    of both kinds runs through the flash-decode kernel: a full cache with
    ``pos + 1`` valid rows, a ring with its filled slots; with ``donate``
    the new row goes into ``cache`` itself. Mamba and RG-LRU layers step
    their recurrence in plain PyTorch and return new states. The residual,
    query and new key and value rows are constrained as on the sequence
    path (the reference leaves them to its partitioner, which keeps them
    so)."""
    h = L.rms_norm(x, w["norm1"], eps=cfg.norm_eps)
    if kind == "mamba":    # no channel mix: the block is the whole layer
        delta, cache = SSM.mamba_step(h, cache, w["mamba"],
                                      cfg.ssm or SSMConfig())
        return shard_act(x + delta, "residual"), cache
    if kind in ("global", "local"):
        q, k, v = _qkv(h, w["attn"], cfg, kind, pos)
        # the token's batch stays on the data axes, as the cache's does:
        # a query replicated there gathers every rank's cache
        q = shard_act(q, "heads")
        k = shard_act(k, "kv_heads")
        v = shard_act(v, "kv_heads")
        if kind == "local" and cfg.window:
            cache = L.cache_update_ring(cache, k, v, pos, donate)
            valid = L.ring_valid_len(pos, cache["k"].shape[1])
        else:
            cache = L.cache_update_full(cache, k, v, pos, donate)
            valid = pos + 1
        out = flash_decode(q, cache["k"], cache["v"], valid)
        x = shard_act(x + _local.merge_heads(out) @ w["attn"]["wo"],
                      "residual")
    else:   # rglru
        delta, cache = RG.recurrent_step(h, cache, w["rec"],
                                         cfg.rglru or RGLRUConfig())
        x = shard_act(x + delta, "residual")
    h2 = L.rms_norm(x, w["norm2"], eps=cfg.norm_eps)
    delta, _ = _channel_mix(h2, w, cfg, decode=True)
    return shard_act(x + delta, "residual"), cache


def _write_back(dst, src) -> None:
    """Copies each leaf of ``src`` into the same leaf of ``dst`` (views of
    the stacked caches) where it is not that view already."""
    if isinstance(dst, dict):
        for k in dst:
            _write_back(dst[k], src[k])
    elif src is not dst:
        dst.copy_(src)


@torch.no_grad()
def decode_step(params: dict, cfg: ModelConfig, inputs: torch.Tensor,
                caches: list[dict], pos: int, *, donate: bool = False):
    """One decode step. inputs: token ids (B,1), or embeddings (B,1,D) for
    archs without token embeddings; ``pos`` is the global position being
    written. Returns (logits (B,V), new_caches).

    By default the caches given are not written: the step returns new
    ones. With ``donate`` the step writes into the caches it was given and
    returns those very tensors, the counterpart of the reference's
    ``donate_argnums``: each attention layer writes its new row into its
    layer's view of the stacked cache, nothing is cloned and nothing is
    stacked again; the small Mamba and RG-LRU states are computed as
    before, functionally, and copied into their views."""
    pos = int(pos)
    x = _embed(params, cfg, inputs)
    new_caches = []
    for seg, seg_params, seg_cache in zip(plan_segments(cfg),
                                          params["segments"], caches):
        per_pos: dict[str, list] = {f"pos{i}": [] for i in range(len(seg.pattern))}
        seg_params = gather_for_use(seg_params, dims={0})
        for r in range(seg.n_repeats):
            for i, kind in enumerate(seg.pattern):
                view = _select(seg_cache[f"pos{i}"], r)
                x, c = _apply_block_decode(
                    kind, gather_for_use(_select(seg_params[f"pos{i}"], r)),
                    x, view, pos, cfg, donate)
                if donate:
                    _write_back(view, c)
                else:
                    per_pos[f"pos{i}"].append(c)
        if not donate:
            new_caches.append({name: _stack(cs) for name, cs in per_pos.items()})
    x = L.rms_norm(x, gather_for_use(params["final_norm"]), eps=cfg.norm_eps)
    logits = shard_act(x @ gather_for_use(unembed_weights(params, cfg)),
                       "logits")
    return logits[:, 0], (caches if donate else new_caches)
