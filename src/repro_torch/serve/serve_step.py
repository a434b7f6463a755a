"""Serving entry points: batched prefill, single-token decode and a greedy
generation loop, on the GPU unless the caller passes ``device="cpu"``.

Sampling is greedy (argmax). The serving state (caches, cursor, tokens
generated so far) is an ordinary nested dict/list of tensors, so a Spot-on
``CheckpointStore`` saves and restores a serving session mid-generation as
it does a training state, and either package restores the other's:
``state_from_numpy`` builds it from ``{keypath: array}`` in the reference's
names (``caches/0/pos0/k``...). Decode steps are functional, so a state
handed to a save is never written by a later step.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models import decode_step, prefill
from ..models.config import ModelConfig
from ..train.train_step import state_from_numpy  # re-exported: builds serving states


def sample_greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _tokens(x, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
    return t.to(device)


def make_prefill(cfg: ModelConfig, *, cache_len: int | None = None,
                 device=None):
    """Returns prefill_fn(params, inputs) -> (tokens (B,), caches, pos)."""
    dev = resolve_device(device)

    def prefill_fn(params, inputs):
        last_logits, caches, pos = prefill(params, cfg, _tokens(inputs, dev),
                                           cache_len=cache_len)
        return sample_greedy(last_logits), caches, pos
    return prefill_fn


def make_decode_step(cfg: ModelConfig, *, device=None):
    """Returns serve_step(params, inputs, caches, pos) -> (tokens (B,),
    logits (B,V), new_caches)."""
    dev = resolve_device(device)

    def serve_step(params, inputs, caches, pos):
        logits, new_caches = decode_step(params, cfg, _tokens(inputs, dev),
                                         caches, pos)
        return sample_greedy(logits), logits, new_caches
    return serve_step


def generate(params, cfg: ModelConfig, prompt, n_tokens: int, *,
             cache_len: int | None = None, device=None) -> torch.Tensor:
    """Greedy generation: prefill the prompt (B,S), then decode. Returns
    (B, n_tokens) int32 tokens on ``device``."""
    S = prompt.shape[1]
    cache_len = cache_len or (S + n_tokens)
    pre = make_prefill(cfg, cache_len=cache_len, device=device)
    step = make_decode_step(cfg, device=device)
    tok, caches, pos = pre(params, prompt)
    out = [tok]
    for i in range(n_tokens - 1):
        tok, _, caches = step(params, out[-1][:, None], caches, pos + i)
        out.append(tok)
    return torch.stack(out, dim=1)
