"""Sharding rules: DP over ("pod","data"), TP/EP over "model", optional FSDP.

A JAX ``Mesh`` becomes a ``torch.distributed.device_mesh.DeviceMesh``, a
sharded ``jax.Array`` a ``DTensor`` with ``Shard``/``Replicate`` placements,
and a process is one rank on one device: "addressable" means this rank's
local shard.

* **Parameter specs** — ``param_pspec(path, shape, rules)`` gives a leaf's
  spec from its key path and shape, one entry per tensor dim: a mesh axis
  name, a tuple of axis names, or None (the entries of the reference's
  ``PartitionSpec``). Megatron-style column/row parallel projections,
  expert-parallel MoE when the expert count divides the model axis
  (DeepSeek: 64/16) and tensor parallelism *inside* experts otherwise (Grok:
  8 experts, d_expert 32768/16), vocab-sharded embedding/head. ``fsdp=True``
  additionally shards the first free, divisible dimension over the data
  axes. Every rule checks divisibility and falls back to replication.
  ``placements(spec, mesh)`` turns a spec into DTensor placements, and
  ``tree_shardings`` / ``cache_shardings`` give a ``Sharding`` per leaf.

* **Activation specs** — ``shard_act(x, name)`` at the canonical cut points
  (residual stream, attention heads, logits). Rules are installed with
  ``use_sharding_rules(...)``; without rules, or for a plain tensor, it is a
  no-op; a ``DTensor`` is redistributed to the spec.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
from dataclasses import dataclass

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..checkpoint import serialize as ser

Spec = tuple            # one entry per tensor dim: str | tuple[str, ...] | None
Region = tuple[tuple[int, int], ...]

_RULES: contextvars.ContextVar["ShardingRules | None"] = \
    contextvars.ContextVar("sharding_rules", default=None)


def _canon(spec) -> Spec:
    """``spec`` as the reference's ``PartitionSpec`` holds it: an entry of
    one axis name is the name itself."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """Size of the mesh dimension named ``axis``."""
    return int(mesh.size(mesh.mesh_dim_names.index(axis)))


@dataclass(frozen=True)
class ShardingRules:
    mesh: DeviceMesh
    data_axes: tuple[str, ...] = ("data",)   # ("pod","data") multi-pod
    model_axis: str = "model"
    fsdp: bool = False
    seq_parallel: bool = False               # Megatron-SP: residual S-sharded
    seq_shard_logits: bool = True            # shard logits seq dim too (memory)
    pure_fsdp: bool = False                  # ZeRO-3: weights 2D-sharded over
                                             # (data, model); activations pure DP

    @property
    def dp_size(self) -> int:
        n = 1
        for a in self.data_axes:
            n *= axis_size(self.mesh, a)
        return n

    @property
    def tp_size(self) -> int:
        return axis_size(self.mesh, self.model_axis)

    def dp_axes_for(self, dim: int):
        """Data axes if batch divides, else None (e.g. batch=1 long-context)."""
        return self.data_axes if dim % self.dp_size == 0 else None

    @property
    def model_in_dp(self) -> bool:
        return self.model_axis in self.data_axes

    def tp_axis_for(self, dim: int):
        if self.pure_fsdp or self.model_in_dp:
            return None                      # activations stay data-parallel
        return self.model_axis if dim % self.tp_size == 0 else None


def elastic_rules(mesh: DeviceMesh, *, model_axis: str = "model",
                  fsdp: bool = False, seq_parallel: bool = False) -> ShardingRules:
    """ShardingRules for a freshly re-planned (elastic-rescale) mesh: every
    mesh axis except ``model_axis`` carries data parallelism (the shape of
    ``core.elastic.plan_mesh_for`` / ``fleet_mesh_plan``)."""
    names = tuple(mesh.mesh_dim_names)
    data_axes = tuple(a for a in names if a != model_axis)
    if not data_axes:  # degenerate 1-axis mesh: model axis doubles as data
        data_axes = names
    return ShardingRules(mesh=mesh, data_axes=data_axes, model_axis=model_axis,
                         fsdp=fsdp, seq_parallel=seq_parallel)


def use_sharding_rules(rules: ShardingRules | None):
    @contextlib.contextmanager
    def cm():
        token = _RULES.set(rules)
        try:
            yield rules
        finally:
            _RULES.reset(token)
    return cm()


def current_rules() -> ShardingRules | None:
    return _RULES.get()


# ---------------------------------------------------------------------------
# specs -> DTensor placements, and this rank's region
# ---------------------------------------------------------------------------

def placements(spec: Spec, mesh: DeviceMesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dim that tensor dim ``d``'s entry names, ``Replicate()`` elsewhere. A dim
    sharded over several axes (``("pod", "data")``) must name them in mesh
    order: DTensor splits by mesh dims left to right, which then gives the
    reference's row-major offsets."""
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry!r} is not in mesh order {names}")
        for i in dims:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} used twice in {spec}")
            out[i] = Shard(d)
    return tuple(out)


def addressable_shard_spans(mesh: DeviceMesh, placements_, shape) -> list[Region]:
    """This rank's region of a leaf of ``shape`` placed as ``placements_`` on
    ``mesh``: ``[((start, stop), ...)]``, the whole leaf on a one-rank mesh,
    ``[]`` for a rank outside the mesh. Each ``Shard(d)`` splits dim ``d``'s
    current span by its mesh dim, left to right, in ``torch.chunk`` pieces
    (the split ``DTensor.from_local`` expects)."""
    region = [[0, int(s)] for s in shape]
    coord = mesh.get_coordinate()
    if coord is None:
        return []
    for i, p in enumerate(placements_):
        if isinstance(p, Replicate):
            continue
        if not isinstance(p, Shard):
            raise ValueError(f"unsupported placement {p!r}")
        lo, hi = region[p.dim]
        n, c = int(mesh.size(i)), int(coord[i])
        step = -(-(hi - lo) // n)
        region[p.dim] = [min(lo + c * step, hi), min(lo + (c + 1) * step, hi)]
    return [tuple((a, b) for a, b in region)]


def is_writer(mesh: DeviceMesh, placements_) -> bool:
    """True on the one rank that writes its shard of a leaf: coordinate 0 on
    every mesh dim that does not shard it (the reference's ``replica_id ==
    0``). A fully replicated leaf is written by the rank at coordinate 0."""
    coord = mesh.get_coordinate()
    return coord is not None and all(
        c == 0 for c, p in zip(coord, placements_) if not isinstance(p, Shard))


def piece_number(mesh: DeviceMesh, placements_) -> int:
    """Index of this rank's piece among a leaf's written pieces: its place
    among the writing ranks in mesh (row-major) order, as the reference
    numbers a single controller's ``replica_id == 0`` shards."""
    coord = tuple(mesh.get_coordinate())
    k = 0
    for c in itertools.product(*(range(int(s)) for s in mesh.shape)):
        if c == coord:
            return k
        if all(x == 0 for x, p in zip(c, placements_) if not isinstance(p, Shard)):
            k += 1
    raise ValueError("this rank is not in the mesh")


@dataclass(frozen=True)
class Sharding:
    """Where a leaf lives: its mesh and DTensor placements (the port's
    ``NamedSharding``), with the spec they came from."""

    mesh: DeviceMesh
    placements: tuple
    spec: Spec = ()


def _sharding(spec: Spec, rules: ShardingRules) -> Sharding:
    return Sharding(rules.mesh, placements(spec, rules.mesh), tuple(spec))


# ---------------------------------------------------------------------------
# activation constraints
# ---------------------------------------------------------------------------

def act_spec(shape, name: str, rules: ShardingRules) -> Spec | None:
    """The spec ``shard_act`` constrains an activation of ``shape`` named
    ``name`` to, or None for a name it leaves alone."""
    spec = _act_spec(tuple(shape), name, rules)
    return None if spec is None else _canon(spec)


def _act_spec(shape, name: str, rules: ShardingRules):
    dp = rules.dp_axes_for(shape[0])
    ndim = len(shape)
    if name == "residual":            # (B,S,D)
        # Megatron sequence parallelism: between blocks the residual stream
        # is sharded over tokens
        sp = rules.tp_axis_for(shape[1]) if (rules.seq_parallel and shape[1] > 1) else None
        return (dp, sp, None)
    if name in ("heads", "kv_heads"):  # (B,S,H,hd)
        tp_h = rules.tp_axis_for(shape[2])
        if tp_h is not None or shape[1] == 1:
            return (dp, None, tp_h, None)
        # head count doesn't divide the model axis: context-parallel
        # fallback, shard the sequence dim
        return (dp, rules.tp_axis_for(shape[1]), None, None)
    if name == "logits":              # (B,S,V) or (B,V)
        tp_v = rules.model_axis if (shape[-1] % rules.tp_size == 0
                                    and not rules.model_in_dp) else None
        if ndim == 3:
            sp = rules.tp_axis_for(shape[1]) if (rules.seq_parallel and shape[1] > 1) else None
            return (dp, sp, tp_v if sp is None else None)
        return (dp, tp_v)
    if name == "ffn":                 # (B,S,F)
        return (dp, None, rules.tp_axis_for(shape[-1]))
    if name == "moe_groups":          # (G, T/G, D)
        return (rules.dp_axes_for(shape[0]), None, None)
    if name == "moe_experts":         # (G, E, C, D) — EP over experts
        return (rules.dp_axes_for(shape[0]), rules.tp_axis_for(shape[1]),
                None, None)
    return None


def _constrain(x, spec: Spec, rules: ShardingRules):
    return x.redistribute(rules.mesh, placements(spec, rules.mesh))


def shard_act(x, name: str):
    r = _RULES.get()
    if r is None or not isinstance(x, DTensor):
        return x
    spec = act_spec(tuple(x.shape), name, r)
    return x if spec is None else _constrain(x, spec, r)


def batch_spec(rules: ShardingRules, batch: int) -> Spec:
    return _canon((rules.dp_axes_for(batch),))


def microbatch_spec(shape, rules: ShardingRules) -> Spec | None:
    """(n_microbatch, B/n, ...) arrays shard dim 1 over data; None below 2-D."""
    if len(shape) < 2:
        return None
    return _canon((None, rules.dp_axes_for(shape[1]),
                   *([None] * (len(shape) - 2))))


def shard_microbatched(tree):
    """Constrain (n_microbatch, B/n, ...) leaves to shard dim 1 over data."""
    r = _RULES.get()
    if r is None:
        return tree
    named = ser.flatten_state(tree)
    out = {}
    for n, x in named.items():
        spec = microbatch_spec(tuple(x.shape), r) if isinstance(x, DTensor) else None
        out[n] = x if spec is None else _constrain(x, spec, r)
    return ser.unflatten_like(tree, out)


# ---------------------------------------------------------------------------
# parameter shardings
# ---------------------------------------------------------------------------

def _with_fsdp(spec: tuple, shape: tuple[int, ...], rules: ShardingRules) -> tuple:
    """Shard the first free, divisible dim over the data axes (FSDP/ZeRO-3).
    For stacked layer params (ndim>=3, leading scan dim) the scan dim is
    never claimed."""
    if not rules.fsdp:
        return spec
    spec = list(spec)
    start = 1 if len(shape) >= 3 else 0
    for i in range(start, len(shape)):
        if (spec[i] is None and shape[i] % rules.dp_size == 0
                and shape[i] >= rules.dp_size):
            spec[i] = rules.data_axes
            break
    return tuple(spec)


def param_pspec(path: str, shape: tuple[int, ...], rules: ShardingRules) -> Spec:
    """Spec from a parameter's key path and shape. Layer-stacked params carry
    a leading repeats dim which TP never shards; FSDP may claim it only for
    2-D leaves."""
    tp = rules.model_axis
    leaf = path.rsplit("/", 1)[-1]
    n = rules.tp_size

    if rules.pure_fsdp and (leaf not in ("embed", "lm_head")
                            or rules.model_in_dp):
        # ZeRO-3 weight sharding over the data axes; outside full-DP mode
        # the embedding/LM head keep vocab-model sharding
        spec = [None] * len(shape)
        start = 1 if len(shape) >= 3 else 0
        claimed_data = False
        for i in range(start, len(shape)):
            if not claimed_data and shape[i] % rules.dp_size == 0 \
                    and shape[i] >= rules.dp_size:
                spec[i] = rules.data_axes
                claimed_data = True
            elif (not rules.model_in_dp and shape[i] % n == 0
                  and shape[i] >= n):
                spec[i] = tp
                break
        return _canon(spec)

    def col():
        """column-parallel: shard output (last) dim; fall back to input dim."""
        spec = [None] * len(shape)
        if shape[-1] % n == 0:
            spec[-1 % len(shape)] = tp
        elif shape[-2] % n == 0:
            spec[-2 % len(shape)] = tp
        return spec

    def row():
        """row-parallel: shard input (second-to-last) dim."""
        spec = [None] * len(shape)
        if shape[-2] % n == 0:
            spec[-2] = tp
        elif shape[-1] % n == 0:
            spec[-1] = tp
        return spec

    if leaf in ("wq", "wk", "wv", "up", "gate", "in_proj", "dt_proj",
                "in_x", "in_gate"):
        spec = col()
    elif leaf in ("wo", "down", "out_proj", "out", "x_proj"):
        spec = row()
    elif leaf == "embed":
        spec = [tp if shape[0] % n == 0 else None, None]
    elif leaf == "lm_head":
        spec = [None, tp if shape[1] % n == 0 else None]
    elif leaf in ("conv", "A_log", "D", "dt_bias"):
        # elementwise-over-d_inner tensors: shard the d_inner dim
        spec = [None] * len(shape)
        for i in range(len(shape) - 1, -1, -1):
            if shape[i] % n == 0 and shape[i] >= n:
                spec[i] = tp
                break
    else:
        spec = [None] * len(shape)

    parts = path.split("/")
    if "experts" in parts:            # MoE expert stacks: (L, E, D, F) / (L, E, F, D)
        spec = [None] * len(shape)
        e_dim = len(shape) - 3
        if shape[e_dim] % n == 0:
            spec[e_dim] = tp            # expert parallelism
        elif leaf in ("up", "gate") and shape[-1] % n == 0:
            spec[-1] = tp               # TP within expert (column)
        elif leaf == "down" and shape[-2] % n == 0:
            spec[-2] = tp               # TP within expert (row)
    if "lru" in parts:
        spec = [None] * len(shape)      # small block-diag gates: replicate
    return _canon(_with_fsdp(tuple(spec), shape, rules))


def tree_shardings(tree, rules: ShardingRules):
    """Same-structure tree of ``Sharding``s for params/opt-state shapes
    (optimizer state wraps params: ``mu/params/...``)."""
    named = ser.flatten_state(tree)
    return ser.unflatten_like(tree, {
        n: _sharding(param_pspec(n, tuple(leaf.shape), rules), rules)
        for n, leaf in named.items()})


def cache_pspec(leaf_name: str, shape: tuple[int, ...], rules: ShardingRules) -> Spec:
    """Decode-cache specs. Caches are stacked (n_repeats, B, ...). KV caches
    shard heads over "model" when the KV head count divides the axis, else
    the sequence dim; recurrent states shard their channel dim."""
    return _canon(_cache_spec(leaf_name, tuple(shape), rules))


def _cache_spec(leaf_name: str, shape: tuple[int, ...], rules: ShardingRules):
    tp = rules.model_axis
    dp = rules.dp_axes_for(shape[1])
    if leaf_name in ("k", "v") and len(shape) == 5:   # (L,B,S,KV,hd)
        if shape[3] % rules.tp_size == 0:
            return (None, dp, None, tp, None)
        if shape[2] % rules.tp_size == 0:
            return (None, dp, tp, None, None)         # sequence-sharded cache
        return (None, dp, None, None, None)
    if leaf_name == "conv" and len(shape) == 4:        # (L,B,K-1,C)
        return (None, dp, None, rules.tp_axis_for(shape[3]))
    if leaf_name == "ssm" and len(shape) == 4:         # (L,B,DI,N)
        return (None, dp, rules.tp_axis_for(shape[2]), None)
    if leaf_name == "h" and len(shape) == 3:           # (L,B,W)
        return (None, dp, rules.tp_axis_for(shape[2]))
    return (None,) * len(shape)


def cache_shardings(tree, rules: ShardingRules):
    named = ser.flatten_state(tree)
    return ser.unflatten_like(tree, {
        n: _sharding(cache_pspec(n.rsplit("/", 1)[-1], tuple(leaf.shape), rules),
                     rules)
        for n, leaf in named.items()})


def distribute(tensor: torch.Tensor, sharding: Sharding) -> DTensor:
    """A ``DTensor`` of the full ``tensor`` (the same on every rank) keeping
    only this rank's region; no collective."""
    (region,) = addressable_shard_spans(sharding.mesh, sharding.placements,
                                        tensor.shape)
    local = tensor[tuple(slice(a, b) for a, b in region)].clone()
    return from_local(local, sharding, tuple(tensor.shape))


def from_local(local: torch.Tensor, sharding: Sharding, shape) -> DTensor:
    """A ``DTensor`` of global ``shape`` from this rank's region ``local``;
    no collective."""
    shape = torch.Size(shape)
    stride, acc = [], 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= int(s)
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False, shape=shape,
                              stride=tuple(reversed(stride)))
