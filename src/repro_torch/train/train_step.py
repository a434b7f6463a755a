"""Training step: loss, grads, AdamW update.

TrainState is a plain nested dict whose key paths, shapes and dtypes match
the reference's (``params``, ``opt/{mu,nu,count}``, ``step``, ``rng``,
``data/next_batch_index``) — the transparent checkpoint is exactly this
state, and either package restores the other's. ``rng`` holds the
reference's uint32 key data and is carried unchanged.

The step is functional: it returns new tensors and never writes the state
it was given, so a device→host copy of the previous state that is still in
flight reads unchanged bytes.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..checkpoint import serialize as ser
from ..checkpoint.sharded import TensorSpec
from ..device import resolve_device
from ..models import forward, init_params
from ..models.config import ModelConfig
from ..models.transformer import unembed_weights
from ..optim import AdamWConfig, adamw_update, init_opt_state

TrainState = dict  # {"params", "opt", "step", "rng", "data"}


def _chunk_xent(hidden_c: torch.Tensor, head32: torch.Tensor,
                labels_c: torch.Tensor) -> torch.Tensor:
    """One sequence chunk's loss sum from float32 logits."""
    logits = hidden_c.to(torch.float32) @ head32
    lse = torch.logsumexp(logits, dim=-1)
    # the gold logit as a one-hot contraction: its gradient is elementwise,
    # where gather's CUDA backward accumulates atomically
    onehot = F.one_hot(labels_c, logits.shape[-1])
    gold = torch.sum(logits * onehot.to(logits.dtype), dim=-1)
    return torch.sum(lse - gold)


def fused_unembed_xent(hidden: torch.Tensor, head: torch.Tensor,
                       labels: torch.Tensor, *, seq_chunks: int = 8
                       ) -> torch.Tensor:
    """Chunked unembed + cross-entropy: per sequence chunk, float32 logits
    (products of the stored values, float32 sums), reduced to a loss sum;
    the full (B, S, V) logits never exist at once. Each chunk's logits and
    one-hot mask are recomputed in backward (a non-reentrant checkpoint, as
    the reference's ``jax.checkpoint``), so a step keeps none of them: the
    same graph, ops and order as without the checkpoint, hence the same
    loss and gradients bit for bit."""
    B, S, _D = hidden.shape
    n = min(seq_chunks, S)
    while S % n != 0:
        n -= 1
    head32 = head.to(torch.float32)
    labels = labels.to(torch.int64)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    c = S // n
    for i in range(n):
        part = checkpoint(_chunk_xent, hidden[:, i * c:(i + 1) * c], head32,
                          labels[:, i * c:(i + 1) * c], use_reentrant=False,
                          preserve_rng_state=False)
        total = total + part
    return total / (B * S)


def init_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig, seed: int = 0,
                     *, device=None) -> TrainState:
    device = resolve_device(device)
    params = init_params(cfg, seed=seed, device=device)
    # the reference's jax.random.key_data(key(seed + 1)) under the default
    # threefry implementation: the seed's high and low 32-bit words
    rng = np.array([(seed + 1) >> 32, (seed + 1) & 0xFFFFFFFF], dtype=np.uint32)
    return {
        "params": params,
        "opt": init_opt_state(params, factored=opt_cfg.factored_second_moment),
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "rng": torch.from_numpy(rng).to(device),
        "data": {"next_batch_index": torch.zeros((), dtype=torch.int32,
                                                 device=device)},
    }


def batch_to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def loss_and_grads(cfg: ModelConfig, params: dict, inputs: torch.Tensor,
                   labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                                  dict]:
    """The train step's loss (mean cross-entropy), aux loss and gradients
    (a tree like ``params``): the forward with the hidden state, then the
    fused unembed + cross-entropy, differentiated."""
    named = ser.flatten_state(params)
    leaves = {n: p.detach().requires_grad_(True) for n, p in named.items()}
    with torch.enable_grad():
        tree = ser.unflatten_like(params, leaves)
        hidden, aux = forward(tree, cfg, inputs, return_hidden=True)
        ce = fused_unembed_xent(hidden, unembed_weights(tree, cfg), labels)
        grads = torch.autograd.grad(ce, list(leaves.values()))
    return (ce.detach(), aux, ser.unflatten_like(params,
                                                 dict(zip(leaves, grads))))


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig):
    """Returns train_step(state, batch) -> (state, metrics)."""

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        params = state["params"]
        loss, aux, grads = loss_and_grads(cfg, params, batch["inputs"],
                                          batch["labels"])
        new_params, new_opt, opt_metrics = adamw_update(
            grads, state["opt"], params, opt_cfg)
        new_state = {
            "params": new_params,
            "opt": new_opt,
            "step": state["step"] + 1,
            "rng": state["rng"],
            "data": {"next_batch_index": state["data"]["next_batch_index"] + 1},
        }
        metrics = {"loss": loss, "ce": loss, "aux": aux, **opt_metrics}
        return new_state, metrics

    return train_step


def state_template(state: TrainState):
    """Allocation-free template with identical structure/shapes/dtypes,
    each tensor leaf on its current device (restore)."""
    return state_template_on_device(state, device=None)


def state_template_on_device(state, device="cuda"):
    """Restore template whose tensor leaves land on ``device`` (default
    ``"cuda"``; None keeps each leaf's own device). Handing it to a
    streaming restore makes tensors land on the device, int8 payloads
    widened there."""
    dev = resolve_device(device) if device is not None else None

    def spec(x):
        if isinstance(x, (torch.Tensor, TensorSpec)):
            return TensorSpec(tuple(x.shape), x.dtype,
                              dev if dev is not None else torch.device(x.device))
        return x
    named = ser.flatten_state(state)
    return ser.unflatten_like(state, {n: spec(x) for n, x in named.items()})


def _nest(named: dict[str, Any]) -> dict:
    root: dict = {}
    for name, val in named.items():
        node = root
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(t):
        if not isinstance(t, dict):
            return t
        t = {k: listify(v) for k, v in t.items()}
        if t and all(k.isdigit() for k in t):
            return [t[str(i)] for i in range(len(t))]
        return t
    return listify(root)


def state_from_numpy(named: dict[str, np.ndarray], device=None) -> TrainState:
    """Nested torch state from ``{keypath: array}`` in the reference's names
    (``params/segments/0/pos0/attn/wq``...). bfloat16 arrays (recognised by
    ``arr.dtype.name == "bfloat16"``) keep their bits; scalars stay 0-d."""
    device = resolve_device(device)
    out = {}
    for name, arr in named.items():
        arr = np.asarray(arr)
        dtype_name = arr.dtype.name
        out[name] = ser.numpy_to_tensor(arr, dtype_name).to(device)
    return _nest(out)
