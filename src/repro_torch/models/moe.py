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


def _n_groups(total_tokens: int) -> int:
    """Local routing groups on one device: tokens route within groups of
    at most ``GROUP_TOKENS_TARGET`` where the count halves evenly, so the
    capacity follows the group's token count, not the batch's."""
    g = 1
    while (total_tokens // g > GROUP_TOKENS_TARGET
           and total_tokens % (g * 2) == 0):
        g *= 2
    return g


def moe_block(x: torch.Tensor, w: dict, cfg: MoEConfig, *, act: str,
              gated: bool, n_groups: int | None = None):
    """x: (B, S, D); w: {"router": (D, E), "experts": {...}[, "shared":
    {...}]}. Returns (y (B, S, D), aux loss averaged over groups)."""
    B, S, D = x.shape
    T = B * S
    G = n_groups or _n_groups(T)
    Tg, E = T // G, cfg.n_experts
    xg = x.reshape(G, Tg, D)
    logits = xg.to(torch.float32) @ w["router"].to(torch.float32)
    slot, gate, aux, C = top_k_routing(logits, cfg)
    dev = x.device
    # the (G, E*C) table of each slot's token row in x padded with one zero
    # row per group (row Tg): empty slots read zeros, as the reference's
    # one-hot dispatch leaves them
    tok = torch.arange(Tg, device=dev).view(1, Tg, 1).expand_as(slot)
    table = torch.full((G, E * C + 1), Tg, dtype=torch.int64, device=dev)
    table.scatter_(1, slot.reshape(G, -1), tok.reshape(G, -1))
    table = table[:, :E * C] + (Tg + 1) * torch.arange(G, device=dev)[:, None]
    xpad = F.pad(xg, (0, 0, 0, 1)).reshape(G * (Tg + 1), D)
    xe = xpad.index_select(0, table.reshape(-1))                  # (G*E*C, D)
    xe = xe.reshape(G, E, C, D).transpose(0, 1).reshape(E, G * C, D)
    ye = expert_ffn(xe, w["experts"], act=act, gated=gated)
    ye = ye.reshape(E, G, C, D).transpose(0, 1).reshape(G * E * C, D)
    # combine: each pair's expert row (a zero row where dropped) times its
    # gate, summed over k in float32
    ye = F.pad(ye.to(torch.float32), (0, 0, 0, 1))
    rows = slot + (E * C) * torch.arange(G, device=dev).view(G, 1, 1)
    rows = torch.where(slot == E * C, G * E * C, rows)
    picked = ye.index_select(0, rows.reshape(-1)).reshape(G, Tg, cfg.top_k, D)
    y = torch.sum(picked * gate[..., None], dim=2).reshape(T, D)
    if "shared" in w:
        y = y + _shared(x.reshape(T, D), w, act=act, gated=gated)
    return y.to(x.dtype).reshape(B, S, D), aux.mean()
