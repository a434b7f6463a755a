"""Mixture-of-Experts layer: shared + routed experts, top-k gating with
capacity-bounded dispatch by index.

Covers both MoE archs of the registry: deepseek-moe-16b (64 fine-grained
routed experts, top-6, 2 shared, a dense prelude layer) and grok-1-314b (8
experts, top-2, no shared).

The semantics are the reference's (``models/moe.py``): a float32 softmax
router, the top k with ties going to the lower expert index, the selected
gates renormalised, each (token, k) pair queued at its expert in token
order (k-major within a token), pairs past the capacity
``ceil(top_k * T_g * capacity_factor / E)`` dropped, and the Switch
auxiliary loss ``E * sum_e f_e * p_e``, all within local groups of about
``GROUP_TOKENS_TARGET`` tokens. The reference contracts one-hot
``(G, T_g, E, C)`` dispatch and combine tensors; here the same slots are a
``(G, E, C)`` table of token rows: the kept rows are gathered, run through
their experts, and each token sums its at most k expert outputs times
their gates in float32. Positions, drops and gates are the reference's;
only the order of those at most k nonzero terms differs. The gathers are
``index_select``, whose backward (``index_add_``) is deterministic on CUDA.
One function, ``moe_block``, serves the CPU and the card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard

from ..kernels import _local
from .config import MoEConfig
from .layers import activation, mlp

GROUP_TOKENS_TARGET = 4096


def router_capacity(n_tokens: int, cfg: MoEConfig) -> int:
    cap = int(math.ceil(cfg.top_k * n_tokens * cfg.capacity_factor
                        / cfg.n_experts))
    return max(cap, 1)


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest probabilities and their expert indices, ties going to
    the lower index as ``jax.lax.top_k`` breaks them (``torch.topk``
    promises no order among ties on CUDA). Gates renormalised over the k."""
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :k]
    top_p = probs.gather(-1, idx)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return top_p, idx


def top_k_routing(logits: torch.Tensor, cfg: MoEConfig):
    """logits: (G, T, E) float32 router logits of G groups. Returns

    - ``slot`` (G, T, K) int64: each (token, k) pair's slot ``e * C + pos``
      in its group's expert buffers, ``E * C`` where the pair overflowed
      its expert's capacity and was dropped;
    - ``gate`` (G, T, K) float32: the renormalised gates, 0 where dropped;
    - ``aux`` (G,) float32: each group's Switch load-balancing loss;
    - ``C``, the capacity of one expert in one group.
    """
    G, T, E = logits.shape
    K = cfg.top_k
    C = router_capacity(T, cfg)
    probs = torch.softmax(logits, dim=-1)
    top_p, idx = _top_k(probs, K)
    # position of each (t, k) in its expert's queue: the pairs routed to the
    # same expert before it, in token order, k-major within a token
    onehot = F.one_hot(idx.reshape(G, T * K), E)                 # (G, T*K, E)
    before = torch.cumsum(onehot, dim=1) - onehot
    pos = torch.sum(before * onehot, dim=-1).reshape(G, T, K)
    keep = pos < C
    slot = torch.where(keep, idx * C + pos, torch.full_like(pos, E * C))
    gate = top_p * keep
    # Switch: E * sum_e f_e * p_e, f the fraction of pairs routed to e
    f = onehot.sum(dim=1).to(torch.float32) / T
    p = probs.mean(dim=1)
    aux = E * torch.sum(f * p, dim=-1)
    return slot, gate, aux, C


def expert_ffn(xe: torch.Tensor, w: dict, *, act: str, gated: bool
               ) -> torch.Tensor:
    """xe: (E, N, D) rows queued at each expert; w leaves (E, D, F) /
    (E, F, D). Returns (E, N, D) in the compute dtype."""
    up = torch.bmm(xe, w["up"])
    h = activation(torch.bmm(xe, w["gate"]), act) * up if gated \
        else activation(up, act)
    return torch.bmm(h, w["down"])


def _shared(xt: torch.Tensor, w: dict, *, act: str, gated: bool
            ) -> torch.Tensor:
    return mlp(xt, w["shared"], act=act, gated=gated).to(torch.float32)


def moe_block_dense(x: torch.Tensor, w: dict, cfg: MoEConfig, *, act: str,
                    gated: bool) -> torch.Tensor:
    """Exact (dropless) MoE for decode: every expert evaluated on every
    token, combined with the renormalised top-k gates. For a decode step's
    few tokens this costs what routed dispatch costs (reading every
    expert's weights) and never drops a token."""
    B, S, D = x.shape
    if _local.any_dtensor(x):
        return _moe_block_dense_sharded(x, w, cfg, act=act, gated=gated)
    xt = x.reshape(B * S, D)
    logits = xt.to(torch.float32) @ w["router"].to(torch.float32)
    top_p, idx = _top_k(torch.softmax(logits, dim=-1), cfg.top_k)
    gates = torch.zeros_like(logits).scatter(-1, idx, top_p)     # (T, E)
    ye = expert_ffn(xt.expand(cfg.n_experts, -1, -1), w["experts"],
                    act=act, gated=gated)                        # (E, T, D)
    y = torch.einsum("te,etd->td", gates, ye.to(torch.float32))
    if "shared" in w:
        y = y + _shared(xt, w, act=act, gated=gated)
    return y.to(x.dtype).reshape(B, S, D)


def _moe_block_dense_sharded(x, w: dict, cfg: MoEConfig, *, act: str,
                             gated: bool):
    """``moe_block_dense`` on local shards: each model rank evaluates the
    experts it holds on its batch rows; the output is a partial sum over
    the model axis where experts or their width are split across it."""
    B, S, D = x.shape
    mesh = x.device_mesh
    md = _tp_dim(mesh)
    pl = [Shard(0) if isinstance(p, Shard) and p.dim == 0 and m != md
          else Replicate() for m, p in enumerate(x.placements)]
    w_l, e0, e1, partial = _expert_shards(w, mesh, pl)
    xl = _local.local_of(x, pl)
    Bl = xl.shape[0]
    xt = xl.reshape(Bl * S, D)
    router = _local.local_of(_local.as_dtensor(w["router"], mesh),
                             [Replicate()] * mesh.ndim)
    logits = xt.to(torch.float32) @ router.to(torch.float32)
    top_p, idx = _top_k(torch.softmax(logits, dim=-1), cfg.top_k)
    gates = torch.zeros_like(logits).scatter(-1, idx, top_p)[:, e0:e1]
    ye = expert_ffn(xt.expand(e1 - e0, -1, -1), w_l["experts"], act=act,
                    gated=gated)
    y = torch.einsum("te,etd->td", gates, ye.to(torch.float32))
    if "shared" in w_l:
        y = y + _shared(xt, w_l, act=act, gated=gated)
    out_pl = [Partial() if m == md and partial else p
              for m, p in enumerate(pl)]
    return _local.wrap(y.to(x.dtype).reshape(Bl, S, D), mesh, out_pl,
                       (B, S, D))


def _n_groups(total_tokens: int) -> int:
    """GShard local groups: tokens route within groups of at most
    ``GROUP_TOKENS_TARGET`` where the count halves evenly, so the capacity
    follows the group's token count, not the batch's. G starts from the
    data-parallel degree of the installed sharding rules (1 without), so
    groups never straddle data shards."""
    from ..distributed.sharding import current_rules
    r = current_rules()
    g = r.dp_size if r is not None else 1
    while total_tokens % g != 0 or total_tokens // g < 1:
        g //= 2
    g = max(g, 1)
    while (total_tokens // g > GROUP_TOKENS_TARGET
           and total_tokens % (g * 2) == 0):
        g *= 2
    return g


def _dispatch(xg, w, cfg: MoEConfig, slot, gate, C, e0: int, e1: int, *,
              act: str, gated: bool) -> torch.Tensor:
    """The routed experts ``e0 .. e1 - 1`` of ``slot``'s pairs on groups
    ``xg`` (G, Tg, D), ``w["experts"]`` holding exactly those experts:
    each pair's expert output times its gate, summed over k in float32;
    (G*Tg, D), zero for pairs routed elsewhere or dropped."""
    G, Tg, D = xg.shape
    E, El = cfg.n_experts, e1 - e0
    dev = xg.device
    # the (G, E*C) table of each slot's token row in xg padded with one
    # zero row per group (row Tg): empty slots read zeros, as the
    # reference's one-hot dispatch leaves them
    tok = torch.arange(Tg, device=dev).view(1, Tg, 1).expand_as(slot)
    table = torch.full((G, E * C + 1), Tg, dtype=torch.int64, device=dev)
    table.scatter_(1, slot.reshape(G, -1), tok.reshape(G, -1))
    table = table[:, e0 * C:e1 * C] \
        + (Tg + 1) * torch.arange(G, device=dev)[:, None]
    xpad = F.pad(xg, (0, 0, 0, 1)).reshape(G * (Tg + 1), D)
    xe = xpad.index_select(0, table.reshape(-1))                 # (G*El*C, D)
    xe = xe.reshape(G, El, C, D).transpose(0, 1).reshape(El, G * C, D)
    ye = expert_ffn(xe, w["experts"], act=act, gated=gated)
    ye = ye.reshape(El, G, C, D).transpose(0, 1).reshape(G * El * C, D)
    # combine: each pair's expert row (a zero row where dropped or routed
    # elsewhere) times its gate, summed over k in float32
    ye = F.pad(ye.to(torch.float32), (0, 0, 0, 1))
    mine = (slot >= e0 * C) & (slot < e1 * C)
    rows = slot - e0 * C + (El * C) * torch.arange(G, device=dev).view(G, 1, 1)
    rows = torch.where(mine, rows, G * El * C)
    picked = ye.index_select(0, rows.reshape(-1)).reshape(G, Tg, cfg.top_k, D)
    return torch.sum(picked * gate[..., None], dim=2).reshape(G * Tg, D)


def moe_block(x: torch.Tensor, w: dict, cfg: MoEConfig, *, act: str,
              gated: bool, n_groups: int | None = None):
    """x: (B, S, D); w: {"router": (D, E), "experts": {...}[, "shared":
    {...}]}. Returns (y (B, S, D), aux loss averaged over groups). On
    ``DTensor``s the groups and experts run on local shards
    (``_moe_block_sharded``)."""
    B, S, D = x.shape
    T = B * S
    G = n_groups or _n_groups(T)
    if _local.any_dtensor(x):
        return _moe_block_sharded(x, w, cfg, G, act=act, gated=gated)
    xg = x.reshape(G, T // G, D)
    logits = xg.to(torch.float32) @ w["router"].to(torch.float32)
    slot, gate, aux, C = top_k_routing(logits, cfg)
    y = _dispatch(xg, w, cfg, slot, gate, C, 0, cfg.n_experts, act=act,
                  gated=gated)
    if "shared" in w:
        y = y + _shared(x.reshape(T, D), w, act=act, gated=gated)
    return y.to(x.dtype).reshape(B, S, D), aux.mean()


def _tp_dim(mesh) -> int | None:
    """The mesh dim that splits experts or their width: the model axis,
    unless the rules make it a data axis too (pure FSDP: weights are
    gathered whole and tokens stay sharded over every axis)."""
    from ..distributed.sharding import current_rules
    r = current_rules()
    return None if r is not None and r.model_in_dp else _local.model_dim(mesh)


def _expert_shards(w: dict, mesh, tokens, experts_on_model: bool = False
                   ) -> tuple[dict, int, int, bool]:
    """The expert and shared weights as local tensors with their model-axis
    shards kept (FSDP shards gathered), the experts split over the model
    axis where ``experts_on_model``: (local tree, e0, e1, partial): experts
    ``e0 .. e1 - 1`` live here; ``partial`` when each rank's output is a
    partial sum over the model axis (experts or their hidden width split
    across it). ``tokens``: the placements of the tokens they run on; a
    weight's gradient is a partial sum over the mesh dims that split
    them."""
    md = _tp_dim(mesh)
    out = {}
    e0, e1 = 0, None
    partial = False
    for group in ("experts", "shared"):
        if group not in w:
            continue
        out[group] = {}
        for name, t in w[group].items():
            t = _local.as_dtensor(t, mesh)
            # the dims a model-axis shard may split: the expert dim, and
            # the hidden width (the last of up and gate, the first of down)
            hidden = t.ndim - (2 if name == "down" else 1)
            keep = {0, hidden} if group == "experts" else {hidden}
            pl = [p if m == md else Replicate()
                  for m, p in enumerate(_local.keep_shards(t, keep))]
            if group == "experts" and experts_on_model:
                pl[md] = Shard(0)
            local = _local.local_of(t, pl, _over_tokens(pl, tokens))
            out[group][name] = local
            if md is not None and isinstance(pl[md], Shard):
                partial = True
                if group == "experts" and pl[md].dim == 0:
                    e0 = _local.coordinate(mesh, md) * local.shape[0]
                    e1 = e0 + local.shape[0]
        if group == "experts" and e1 is None:
            e1 = next(iter(out[group].values())).shape[0]
    return out, e0, e1, partial


def _over_tokens(pl, tokens) -> list:
    """Gradient placements of a weight placed ``pl`` that runs on tokens
    placed ``tokens``: a partial sum over each mesh dim that shards them."""
    return [Partial() if isinstance(t, Shard) else p
            for p, t in zip(pl, tokens)]


def _moe_block_sharded(x, w: dict, cfg: MoEConfig, G: int, *, act: str,
                       gated: bool):
    """``moe_block`` on local shards. The groups stay data-sharded (the
    reference's ``"moe_groups"`` cut); every model rank routes its groups
    alike and runs the experts it holds, in the reference's
    ``"moe_experts"`` layout (groups on the data axes, experts on the model
    axis; with tensor parallelism inside experts, each rank's share of
    their hidden width). Each rank's output and its share of the aux loss
    are partial sums over the model axis (the aux loss counted on model
    rank 0), and over the data axes for the aux loss's group mean."""
    from ..distributed.sharding import act_spec, current_rules, shard_act
    B, S, D = x.shape
    T = B * S
    xg = shard_act(x.reshape(G, T // G, D), "moe_groups")
    mesh = xg.device_mesh
    md = _tp_dim(mesh)
    # the expert buffers' layout: the reference's "moe_experts" spec of
    # its (G, E, C, D) buffers, experts on the model axis where they
    # divide it
    rules = current_rules()
    ep = (rules is not None and md is not None and act_spec(
        (G, cfg.n_experts, 1, D), "moe_experts", rules)[1] is not None)
    pl = [Shard(0) if isinstance(p, Shard) and p.dim == 0 and m != md
          else Replicate() for m, p in enumerate(xg.placements)]
    w_l, e0, e1, partial = _expert_shards(w, mesh, pl, experts_on_model=ep)
    grad_pl = [Partial() if m == md and partial else p
               for m, p in enumerate(pl)]
    xl = _local.local_of(xg, pl, grad_pl)
    router = _local.local_of(_local.as_dtensor(w["router"], mesh),
                             [Replicate()] * mesh.ndim,
                             [Partial() if m == md else g for m, g in
                              enumerate(_over_tokens([Replicate()] * mesh.ndim,
                                                     pl))])
    logits = xl.to(torch.float32) @ router.to(torch.float32)
    slot, gate, aux, C = top_k_routing(logits, cfg)
    Gl, Tg = xl.shape[:2]
    y = _dispatch(xl, w_l, cfg, slot, gate, C, e0, e1, act=act, gated=gated)
    if "shared" in w_l:
        y = y + _shared(xl.reshape(Gl * Tg, D), w_l, act=act, gated=gated)
    out_pl = [Partial() if m == md and partial else p
              for m, p in enumerate(pl)]
    y = _local.wrap(y.to(x.dtype).reshape(Gl, Tg, D), mesh, out_pl,
                    (G, T // G, D)).reshape(B, S, D)
    share = aux.sum() / G
    if md is not None and _local.coordinate(mesh, md) != 0:
        share = share * 0.0
    aux_pl = [Partial() if (m == md or isinstance(p, Shard)) else Replicate()
              for m, p in enumerate(pl)]
    return y, _local.wrap(share, mesh, aux_pl, ())
