"""The kernel ops on ``DTensor``s: each rank runs the op on its local
shards, batch on the data axes and heads or channels on the model axis.

A kernel sees whole rows of what it reduces over: attention sees every key
of its query rows, a scan every step of its channels. So each operand is
first redistributed to keep its batch shards and its head or channel
shards, and to replicate every other dim (a sequence-sharded operand is
gathered; a collective the trace counts). The op then runs on
``to_local()`` views and its outputs are wrapped back with the placements
of the operand they follow. ``to_local`` and ``from_local`` carry
gradients, so the ops' backward runs on the same shards.

The GQA case: where the query heads are sharded over the model axis and
the KV heads are not (their count does not divide it), every rank holds
all KV heads and slices out those its own query heads read: query head
``h`` reads KV head ``h // (H // KV)``, so local query head ``j`` on shard
``i`` reads KV head ``(i * H_local + j) // (H // KV)``, not local KV head
``j // (H_local // KV)``. That slice's gradient is a partial sum over the
model axis.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


def any_dtensor(*tensors) -> bool:
    return any(isinstance(t, DTensor) for t in tensors)


def mesh_of(tensors):
    return next(t for t in tensors if isinstance(t, DTensor)).device_mesh


def model_dim(mesh) -> int | None:
    """Index of the model axis among the mesh dims: the installed rules'
    ``model_axis``, else a dim named ``"model"``, else None."""
    from ..distributed.sharding import current_rules
    r = current_rules()
    name = r.model_axis if r is not None else "model"
    names = tuple(mesh.mesh_dim_names or ())
    return names.index(name) if name in names else None


def as_dtensor(t, mesh) -> DTensor:
    """``t`` as a DTensor on ``mesh``: a plain tensor is the same on every
    rank, so it is replicated."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def wrap(local: torch.Tensor, mesh, placements, shape) -> DTensor:
    stride, acc = [], 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= int(s)
    return DTensor.from_local(local, mesh, tuple(placements), run_check=False,
                              shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))


def local_of(x: DTensor, placements, grad_placements=None) -> torch.Tensor:
    """``x``'s local shard in ``placements``, its gradient taken as
    ``grad_placements`` (by default the same). Where ``x`` already lies so,
    the gradient reaches ``x`` as it is given: a partial sum stays partial
    until whatever made ``x`` reduces it (an FSDP gather's reduce-scatter),
    where a redistribute to the same placements would all-reduce it."""
    pl = tuple(placements)
    if tuple(x.placements) != pl:
        x = x.redistribute(x.device_mesh, pl)
    return x.to_local(grad_placements=None if grad_placements is None
                      else tuple(grad_placements))


def for_split(x, dim: int, outer: int):
    """``x`` ready to have dim ``dim`` split into (``outer``, rest): a
    DTensor shard of that dim over a mesh dim whose size does not divide
    ``outer`` is gathered (DTensor cannot split it); anything else is
    returned as it is."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    mesh = x.device_mesh
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim
          and outer % mesh.size(m) else p for m, p in enumerate(x.placements)]
    return x if tuple(pl) == tuple(x.placements) else x.redistribute(mesh, pl)


class _SplitLast(torch.autograd.Function):
    """A DTensor's last dim split into (n, rest); its gradient merged back.
    DTensor cannot split a dim whose shards the outer size does not divide,
    so such a shard is gathered first (``for_split``)."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.shape = x.shape
        return for_split(x, -1, n).reshape(*x.shape[:-1], n, x.shape[-1] // n)

    @staticmethod
    def backward(ctx, g):
        return g.reshape(ctx.shape), None


class _MergeLast(torch.autograd.Function):
    """A DTensor's last two dims merged; its gradient split back with
    ``for_split``."""

    @staticmethod
    def forward(ctx, x):
        ctx.shape = x.shape
        return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])

    @staticmethod
    def backward(ctx, g):
        return for_split(g, -1, ctx.shape[-2]).reshape(ctx.shape)


def split_heads(y, n: int):
    """(..., n * hd) -> (..., n, hd): a plain reshape, or on a DTensor one
    whose forward and backward both gather a shard the head count does not
    divide."""
    if isinstance(y, DTensor):
        return _SplitLast.apply(y, n)
    return y.reshape(*y.shape[:-1], n, y.shape[-1] // n)


def merge_heads(o):
    """(..., n, hd) -> (..., n * hd), the inverse of ``split_heads``."""
    if isinstance(o, DTensor):
        return _MergeLast.apply(o)
    return o.reshape(*o.shape[:-2], o.shape[-2] * o.shape[-1])


def whole_rows(x):
    """``x`` (B, S, D) with its sequence dim gathered where a mesh dim
    shards it (sequence parallelism), as Megatron gathers it before the
    column-parallel products; its gradient is reduce-scattered back. A
    product flattens (B, S) into its rows, which some torch releases (2.11)
    refuse for a sharded S. Anything else is returned as it is."""
    if not isinstance(x, DTensor):
        return x
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p
               for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(
        x.device_mesh, pl)


def keep_shards(x: DTensor, keep) -> list:
    """``x``'s placements with each ``Shard`` of a dim in ``keep`` kept and
    every other placement replicated (FSDP shards of other dims
    gathered)."""
    return [p if isinstance(p, Shard) and p.dim in keep else Replicate()
            for p in x.placements]


def coordinate(mesh, dim: int | None) -> int:
    """This rank's coordinate on mesh dim ``dim`` (0 for None)."""
    return 0 if dim is None else int(mesh.get_coordinate()[dim])


def batch_and(x: DTensor, dim: int, size: int, mesh) -> list:
    """Placements keeping ``x``'s batch shards (dim 0) and a shard of
    ``dim`` (of length ``size``) on the model axis where it divides;
    everything else replicated."""
    md = model_dim(mesh)
    out = []
    for m, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == 0 and m != md:
            out.append(Shard(0))
        elif m == md and size % mesh.size(m) == 0:
            out.append(Shard(dim))
        else:
            out.append(Replicate())
    return out


def attention(fn, q, k, v):
    """``fn(q, k, v)`` (flash attention or flash decode) on local shards.
    q: (B,S,H,hd) or (B,H,hd); k, v: (B,S,KV,hd). Query heads follow q's
    head shards; KV heads are sharded with them where KV divides the model
    axis and are sliced per rank (the GQA case) where it does not."""
    mesh = mesh_of((q, k, v))
    q, k, v = (as_dtensor(t, mesh) for t in (q, k, v))
    hq = q.ndim - 2
    H, KV = q.shape[hq], k.shape[2]
    qp, kp, kgrad = [], [], []
    sliced = None
    for m, p in enumerate(q.placements):
        n = mesh.size(m)
        if isinstance(p, Shard) and p.dim == 0:
            qp.append(Shard(0))
            kp.append(Shard(0))
            kgrad.append(Shard(0))
        elif isinstance(p, Shard) and p.dim == hq and H % n == 0:
            qp.append(Shard(hq))
            if KV % n == 0:
                kp.append(Shard(2))
                kgrad.append(Shard(2))
            else:                                   # the GQA case
                kp.append(Replicate())
                kgrad.append(Partial())
                sliced = m
        else:
            qp.append(Replicate())
            kp.append(Replicate())
            kgrad.append(Replicate())
    ql = local_of(q, qp)
    if sliced is None:
        kl, vl = local_of(k, kp), local_of(v, kp)
    else:
        kl, vl = local_of(k, kp, kgrad), local_of(v, kp, kgrad)
        n = mesh.size(sliced)
        i = int(mesh.get_coordinate()[sliced])
        Hl, G = H // n, H // KV
        if Hl % G == 0:
            j0, j1 = i * Hl // G, (i + 1) * Hl // G
        elif G % Hl == 0:
            j0 = i * Hl // G
            j1 = j0 + 1
        else:      # heads straddle KV groups: one KV head per query head
            kl = kl.repeat_interleave(G, dim=2)
            vl = vl.repeat_interleave(G, dim=2)
            j0, j1 = i * Hl, (i + 1) * Hl
        kl, vl = kl[:, :, j0:j1], vl[:, :, j0:j1]
    # DTensor views its local shards: hand it a contiguous output
    return wrap(fn(ql, kl, vl).contiguous(), mesh, qp, q.shape)


def selective_scan(op, u, delta, A, B, C, D):
    """The selective-scan op on local shards: channels (DI) on the model
    axis where they divide it; B and C, read by every channel, replicated
    there (their gradient a partial sum). A and D, the same on every rank
    of a batch-sharded dim, take a partial sum of the rows' gradients
    there. Returns (y, h_last) DTensors."""
    mesh = mesh_of((u, delta, A, B, C, D))
    u, delta, A, B, C, D = (as_dtensor(t, mesh) for t in (u, delta, A, B, C, D))
    DI = u.shape[2]
    up = batch_and(u, 2, DI, mesh)
    chan = [Shard(0) if p == Shard(2) else Replicate() for p in up]
    bc = [Shard(0) if p == Shard(0) else Replicate() for p in up]
    bc_grad = [Shard(0) if p == Shard(0) else Partial() if p == Shard(2)
               else Replicate() for p in up]
    chan_grad = [Partial() if p == Shard(0) else c for p, c in zip(up, chan)]
    y, h = op(local_of(u, up), local_of(delta, up),
              local_of(A, chan, chan_grad),
              local_of(B, bc, bc_grad), local_of(C, bc, bc_grad),
              local_of(D, chan, chan_grad))
    hp = [Shard(1) if p == Shard(2) else p for p in up]
    return (wrap(y, mesh, up, u.shape),
            wrap(h, mesh, hp, (u.shape[0], DI, A.shape[1])))


def lru_scan(op, a, b):
    """The RG-LRU scan op on local shards: channels (W) on the model axis
    where they divide it. Returns (h, h_last) DTensors."""
    mesh = mesh_of((a, b))
    a, b = as_dtensor(a, mesh), as_dtensor(b, mesh)
    W = a.shape[2]
    ap = batch_and(a, 2, W, mesh)
    h, h_last = op(local_of(a, ap), local_of(b, ap))
    lp = [Shard(1) if p == Shard(2) else p for p in ap]
    return (wrap(h, mesh, ap, a.shape),
            wrap(h_last, mesh, lp, (a.shape[0], W)))
