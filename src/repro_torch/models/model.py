"""Model facade: shape templates (``input_specs``, ``param_specs``,
``cache_specs``) for sizing and for checkpoint restore templates.

Each spec is a tensor on the meta device: it carries the shape and dtype
of the tensor it stands for, under the reference's leaf names, and
allocates nothing, so the specs of a full 314B config cost no memory.
"""

from __future__ import annotations

import torch

from . import transformer as T
from .config import ModelConfig

_META = torch.device("meta")


def _spec(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=_META)


def input_specs(cfg: ModelConfig, *, kind: str, seq_len: int, batch: int
                ) -> dict:
    """Every model input of a step function.

    kind: "train" (inputs + labels), "prefill" (inputs), "decode" (one
    input + the cache position). Archs without token embeddings take
    frontend embeddings (B, S, d_model) in the model's dtype.
    """
    if cfg.embed_inputs:
        def inp(b, s):
            return _spec((b, s), torch.int32)
    else:
        def inp(b, s):
            return _spec((b, s, cfg.d_model), getattr(torch, cfg.dtype))
    if kind == "train":
        return {"inputs": inp(batch, seq_len),
                "labels": _spec((batch, seq_len), torch.int32)}
    if kind == "prefill":
        return {"inputs": inp(batch, seq_len)}
    if kind == "decode":
        return {"inputs": inp(batch, 1), "pos": _spec((), torch.int32)}
    raise ValueError(kind)


def param_specs(cfg: ModelConfig) -> dict:
    """The parameter tree of ``init_params``, on the meta device."""
    return T.init_params(cfg, device=_META)


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> list[dict]:
    """The decode caches of ``init_cache``, on the meta device."""
    return T.init_cache(cfg, batch, max_len, device=_META)
