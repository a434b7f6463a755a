"""AdamW + linear-warmup cosine schedule + global-norm clipping.

Functional: ``adamw_update`` returns new parameter and moment tensors and
never writes its inputs, so a checkpoint copy still reading the previous
state is never raced by the next step. Moments are float32 regardless of
parameter dtype; the update is computed in float32 and cast back. With
``factored_second_moment`` a matrix leaf's second moment is the
reference's Adafactor-style ``{row, col}`` pair of float32 means.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..checkpoint.serialize import flatten_state, unflatten_like


@dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    factored_second_moment: bool = False


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.peak_lr * (cfg.min_lr_frac
                         + (1 - cfg.min_lr_frac) * 0.5
                         * (1 + torch.cos(math.pi * t)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def _factorable(shape) -> bool:
    """Factor the trailing two dims when both are >= 64 (matrix params;
    stacked-layer leading dims ride along)."""
    return len(shape) >= 2 and shape[-1] >= 64 and shape[-2] >= 64


def init_opt_state(params: dict, *, factored: bool = False) -> dict:
    named = flatten_state(params)

    def zeros(shape, device):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    def nu(p):
        if factored and _factorable(p.shape):
            return {"row": zeros(p.shape[:-1], p.device),
                    "col": zeros(p.shape[:-2] + p.shape[-1:], p.device)}
        return zeros(p.shape, p.device)

    device = next(iter(named.values())).device
    return {
        "mu": unflatten_like(params, {n: zeros(p.shape, p.device)
                                      for n, p in named.items()}),
        "nu": unflatten_like(params, {n: nu(p) for n, p in named.items()}),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def _flatten_nu(nu, params: dict) -> dict:
    """nu as one entry per parameter name: a tensor, or a factored
    ``{row, col}`` pair kept whole."""
    return {n: _at(nu, n.split("/")) for n in flatten_state(params)}


def _at(tree, path: list[str]):
    for key in path:
        tree = tree[int(key)] if isinstance(tree, (list, tuple)) else tree[key]
    return tree


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the float32 sum of squares, summed leaf by leaf in key order."""
    total = 0
    for x in tensors:
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads: dict, opt_state: dict, params: dict, cfg: AdamWConfig):
    """(grads, opt state, params) -> (new params, new opt state, metrics).
    A factored ``{row, col}`` entry of nu takes the reference's Adafactor
    update; a dense one the plain second moment."""
    count = opt_state["count"] + 1
    lr = lr_at(cfg, count)
    flat_p = flatten_state(params)
    flat_g = flatten_state(grads)
    flat_m = flatten_state(opt_state["mu"])
    flat_v = _flatten_nu(opt_state["nu"], params)
    gnorm = global_norm(flat_g[n] for n in flat_p)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    cnt = count.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                     device=cnt.device), cnt)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                     device=cnt.device), cnt)
    new_p, new_m, new_v = {}, {}, {}
    for n, p in flat_p.items():
        g32 = flat_g[n].to(torch.float32) * scale
        m = cfg.b1 * flat_m[n] + (1 - cfg.b1) * g32
        v = flat_v[n]
        if isinstance(v, dict):   # factored second moment (Adafactor)
            g2 = g32 * g32 + 1e-30
            row = cfg.b2 * v["row"] + (1 - cfg.b2) * torch.mean(g2, dim=-1)
            col = cfg.b2 * v["col"] + (1 - cfg.b2) * torch.mean(g2, dim=-2)
            v = {"row": row, "col": col}
            denom = torch.mean(row, dim=-1, keepdim=True) + 1e-30
            vhat = (row[..., :, None] * col[..., None, :]
                    / denom[..., None]) / b2c
        else:
            v = cfg.b2 * v + (1 - cfg.b2) * g32 * g32
            vhat = v / b2c
        step = (m / b1c) / (torch.sqrt(vhat) + cfg.eps)
        p32 = p.to(torch.float32)
        new_p[n] = (p32 - lr * (step + cfg.weight_decay * p32)).to(p.dtype)
        new_m[n], new_v[n] = m, v
    metrics = {"lr": lr, "grad_norm": gnorm}
    return (unflatten_like(params, new_p),
            {"mu": unflatten_like(params, new_m),
             "nu": unflatten_like(params, new_v), "count": count},
            metrics)
