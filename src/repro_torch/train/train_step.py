"""Training step: loss, grads, AdamW update; microbatch gradient accumulation
and activation rematerialization (``models.forward``'s ``remat``).

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
from torch.utils.checkpoint import checkpoint

from ..checkpoint import serialize as ser
from ..checkpoint.sharded import TensorSpec
from ..device import resolve_device
from ..distributed.sharding import keep_rules
from ..kernels import _local
from ..models import forward, init_params
from ..models.config import ModelConfig
from ..models.transformer import REMAT_MODES, unembed_weights
from ..optim import AdamWConfig, adamw_update, init_opt_state

TrainState = dict  # {"params", "opt", "step", "rng", "data"}


def _chunk_xent(hidden_c: torch.Tensor, head32: torch.Tensor,
                labels_c: torch.Tensor) -> torch.Tensor:
    """One sequence chunk's loss sum from float32 logits."""
    if _local.any_dtensor(hidden_c, head32, labels_c):
        return _chunk_xent_sharded(hidden_c, head32, labels_c)
    logits = hidden_c.to(torch.float32) @ head32
    lse = torch.logsumexp(logits, dim=-1)
    # the gold logit through a mask: its gradient is elementwise, where
    # gather's CUDA backward accumulates atomically, and the mask is a byte
    # an element where a one-hot would take eight
    hit = labels_c[..., None] == torch.arange(logits.shape[-1],
                                              device=logits.device)
    gold = torch.sum(torch.where(hit, logits, 0.0), dim=-1)
    return torch.sum(lse - gold)


def _chunk_xent_sharded(hidden_c, head32, labels_c):
    """``_chunk_xent`` on local shards, the logits in the reference's
    ``"logits"`` layout (``act_spec``: batch on the data axes; under
    sequence parallelism the chunk's positions on the model axis, else the
    vocabulary there where it divides it): each rank's logits of its rows
    and vocabulary slice; a sliced vocabulary's row maximum, sum of
    exponentials and gold logit reduced over the model axis (a max and two
    sums of (rows, chunk) values), so no rank holds a row's whole
    vocabulary. Returns the loss sum, a partial sum over the axes that
    shard the rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = _local.mesh_of((hidden_c, head32, labels_c))
    md = _local.model_dim(mesh)
    hidden_c, head32, labels_c = (_local.as_dtensor(t, mesh)
                                  for t in (hidden_c, head32, labels_c))
    from ..distributed.sharding import act_spec, current_rules
    V = head32.shape[1]
    rules = current_rules()
    spec = act_spec((hidden_c.shape[0], hidden_c.shape[1], V), "logits",
                    rules) if rules is not None else None
    seq = md is not None and spec is not None and spec[1] is not None
    rows = [Shard(1) if m == md and seq
            else Shard(0) if isinstance(p, Shard) and p.dim == 0 and m != md
            else Replicate() for m, p in enumerate(hidden_c.placements)]
    vocab = [Shard(1) if m == md and spec is not None and spec[2] is not None
             else Replicate() for m in range(mesh.ndim)]
    grad_rows = [Partial() if m == md and vocab[m] != Replicate() else p
                 for m, p in enumerate(rows)]
    # each rank's rows give a partial sum of the head's gradient
    grad_vocab = [Partial() if isinstance(r, Shard) else p
                  for r, p in zip(rows, vocab)]
    h = _local.local_of(hidden_c, rows, grad_rows)
    w = _local.local_of(head32, vocab, grad_vocab)
    y = _local.local_of(labels_c, rows)
    logits = h.to(torch.float32) @ w                     # (b, c, V_local)
    split = md is not None and vocab[md] != Replicate()
    v0 = _local.coordinate(mesh, md) * w.shape[1] if split else 0
    shape = (hidden_c.shape[0], hidden_c.shape[1])

    def over_vocab(t, op):
        """``t`` (b, c) reduced over the model axis by ``op``."""
        if not split:
            return t
        pl = [Partial(op) if m == md else p for m, p in enumerate(rows)]
        return _local.wrap(t, mesh, pl, shape).redistribute(
            mesh, rows).to_local()
    m = over_vocab(logits.detach().amax(dim=-1), "max")
    s = over_vocab(torch.sum(torch.exp(logits - m[..., None]), dim=-1), "sum")
    lse = m + torch.log(s)
    hit = (y - v0)[..., None] == torch.arange(w.shape[1], device=logits.device)
    gold = over_vocab(torch.sum(torch.where(hit, logits, 0.0), dim=-1), "sum")
    part = torch.sum(lse - gold)
    pl = [Partial() if isinstance(p, Shard) else Replicate() for p in rows]
    return _local.wrap(part, mesh, pl, ())


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
    chunk_xent = keep_rules(_chunk_xent)
    for i in range(n):
        part = checkpoint(chunk_xent, hidden[:, i * c:(i + 1) * c], head32,
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


def batch_to_device(batch: dict, device, cfg: ModelConfig) -> dict:
    """Host batch arrays as tensors on ``device``. Frontend embeddings
    (floating inputs) land in ``cfg``'s dtype, the one the model casts
    them to."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        dtype = getattr(torch, cfg.dtype) if t.is_floating_point() else None
        out[k] = t.to(device, dtype=dtype)
    return out


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  chunk_tokens: int = 32768) -> torch.Tensor:
    """Mean cross-entropy over tokens in float32 (the unfused loss, over
    given logits), computed in token chunks as the reference's ``lax.map``
    does, so the float32 upcast of the (T, V) logits never exists at once:
    the number of chunks is the largest divisor of T not above
    ``T // chunk_tokens``; the chunks' sums are summed in order and divided
    by T."""
    B, S, V = logits.shape
    T = B * S
    lf = logits.reshape(T, V)
    yf = labels.reshape(T).to(torch.int64)
    n_chunks = max(1, T // chunk_tokens)
    while T % n_chunks != 0:
        n_chunks -= 1

    def chunk_sum(lc, yc):
        l32 = lc.to(torch.float32)
        lse = torch.logsumexp(l32, dim=-1)
        # the gold logit through a mask, not gather: an elementwise
        # gradient, and one byte of mask an element where a one-hot
        # would take eight
        hit = yc[:, None] == torch.arange(V, device=yc.device)
        gold = torch.sum(torch.where(hit, l32, 0.0), dim=-1)
        return torch.sum(lse - gold)

    if n_chunks <= 1:
        return chunk_sum(lf, yf) / T
    c = T // n_chunks
    parts = [chunk_sum(lf[i * c:(i + 1) * c], yf[i * c:(i + 1) * c])
             for i in range(n_chunks)]
    return torch.sum(torch.stack(parts)) / T


def _aux_weight(cfg: ModelConfig) -> float:
    return cfg.moe.aux_loss_weight if cfg.moe is not None else 0.0


def loss_and_grads(cfg: ModelConfig, params: dict, inputs: torch.Tensor,
                   labels: torch.Tensor, *, remat: str = "none",
                   aux_weight: float | None = None, fused_ce: bool = True
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, dict]:
    """The train step's loss, its mean cross-entropy, the MoE aux loss and
    the gradients (a tree like ``params``) of ``ce + aux_w * aux``
    (``aux_w`` is ``aux_weight``, by default the config's
    ``aux_loss_weight``, 0 without MoE): the forward with the hidden state,
    then the fused unembed + cross-entropy, differentiated; with
    ``fused_ce=False`` the forward's logits through ``cross_entropy``.
    ``remat`` is the forward's."""
    aux_w = aux_weight if aux_weight is not None else _aux_weight(cfg)
    named = ser.flatten_state(params)
    leaves = {n: p.detach().requires_grad_(True) for n, p in named.items()}
    with torch.enable_grad():
        tree = ser.unflatten_like(params, leaves)
        if fused_ce:
            hidden, aux = forward(tree, cfg, inputs, remat=remat,
                                  return_hidden=True)
            ce = fused_unembed_xent(hidden, unembed_weights(tree, cfg), labels)
        else:
            logits, aux = forward(tree, cfg, inputs, remat=remat)
            ce = cross_entropy(logits, labels)
        loss = ce + aux_w * aux
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return (loss.detach(), ce.detach(), aux.detach(),
            ser.unflatten_like(params, dict(zip(leaves, grads))))


def _split_local(v, n: int):
    """A batch-sharded DTensor (B, ...) as (n, B/n, ...) with dim 1 on the
    data axes (``shard_microbatched``'s layout), each rank splitting its own
    rows: microbatch i holds the i-th n-th of every rank's rows, so no row
    moves between ranks. The rows a microbatch groups differ from the
    contiguous split's; the accumulated loss and gradients are their sum
    over all microbatches either way."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = v.device_mesh
    pl = [Shard(0) if p == Shard(0) else Replicate() for p in v.placements]
    local = _local.local_of(v, pl)
    local = local.reshape(n, local.shape[0] // n, *local.shape[1:])
    return _local.wrap(local, mesh, [Shard(1) if p == Shard(0) else p
                                     for p in pl],
                       (n, v.shape[0] // n, *v.shape[1:]))


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    remat: str = "none", microbatches: int = 1,
                    aux_weight: float | None = None, fused_ce: bool = True):
    """Returns train_step(state, batch) -> (state, metrics).

    With ``microbatches`` > 1 the batch's dim 0 is split into that many
    equal microbatches (``shard_microbatched`` keeps them data-sharded
    under sharding rules; a no-op without; a DTensor batch is split on
    each rank, ``_split_local``), each microbatch's loss, ce, aux
    and float32 gradients are summed in microbatch order onto zeros, and
    the sums are multiplied by ``1 / microbatches``, as the reference's
    ``lax.scan`` accumulates them."""
    if remat not in REMAT_MODES:
        raise ValueError(f"remat must be one of {REMAT_MODES}, got {remat!r}")
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")

    def single(params, inputs, labels):
        return loss_and_grads(cfg, params, inputs, labels, remat=remat,
                              aux_weight=aux_weight, fused_ce=fused_ce)

    def accumulate(params, batch):
        from ..distributed.sharding import shard_microbatched
        B = batch["inputs"].shape[0]
        assert B % microbatches == 0, (B, microbatches)
        if _local.any_dtensor(*batch.values()):
            mb = {k: _split_local(v, microbatches) for k, v in batch.items()}
        else:
            mb = shard_microbatched({
                k: v.reshape(microbatches, B // microbatches, *v.shape[1:])
                for k, v in batch.items()})
        dev = batch["inputs"].device
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        loss_s, ce_s, aux_s = zero, zero, zero
        named = ser.flatten_state(params)
        acc = {n: torch.zeros_like(p, dtype=torch.float32)
               for n, p in named.items()}
        for i in range(microbatches):
            loss, ce, aux, grads = single(params, mb["inputs"][i],
                                          mb["labels"][i])
            loss_s, ce_s, aux_s = loss_s + loss, ce_s + ce, aux_s + aux
            for n, g in ser.flatten_state(grads).items():
                acc[n] = acc[n] + g.to(torch.float32)
            del grads
        inv = 1.0 / microbatches
        return (loss_s * inv, ce_s * inv, aux_s * inv,
                ser.unflatten_like(params, {n: g * inv
                                            for n, g in acc.items()}))

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        params = state["params"]
        if microbatches > 1:
            loss, ce, aux, grads = accumulate(params, batch)
        else:
            loss, ce, aux, grads = single(params, batch["inputs"],
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
        metrics = {"loss": loss, "ce": ce, "aux": aux, **opt_metrics}
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
