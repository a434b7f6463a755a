"""Per-device cost analysis of a traced step: the port's counterpart of the
reference's ``launch/hlo_analysis.py``.

The reference re-derives FLOPs, bytes and collective bytes from compiled
HLO, scaling each while body by its trip count. Eager PyTorch runs every
op it counts, loops included, so no trip counts are needed here: a
dispatch mode (``OpAnalysis``) records the ops that one device runs while
a step runs once, on real tensors or on fake ones (``FakeTensorMode``:
shapes and dtypes, no memory).

What one device runs. Under a ``DTensor`` program the mode steps aside
for every op that has a ``DTensor`` operand (it returns
``NotImplemented``), so the DTensor dispatcher runs the op, and the mode
records what that dispatcher runs on this rank's local shards: the local
op and the functional collectives of any redistribution. Ops that the
sharding propagator runs on global stand-ins to learn output shapes are
not counted. On the production mesh every count is this rank's (rank 0
of the fake process group).

Conventions, the reference's (``hlo_analysis.py``) where they carry over:

* FLOPs are those of ``torch.utils.flop_counter``'s formulas on local
  shapes: the matmul family (a product counts 2 * output elements *
  contracted size), and the kernel ops of ``kernels/_ops.py`` by their
  registered formulas. With ``plain=True`` each kernel op on a CPU tensor
  is traced through its plain version instead, and its ops are counted.
* Bytes are the operand bytes plus the output bytes of every op, except
  views, metadata ops and the counterparts of the reference's
  ``_SKIP_OPS`` (allocation, constants, ``arange`` for ``iota``, random
  bits). Eager PyTorch fuses nothing, so this is the unfused traffic: it
  bounds the reference's count at fusion boundaries from above and is not
  equal to it.
* Collective bytes are the operand bytes of the functional collectives,
  keyed by the reference's kind names, each collective counted once (its
  ``wait_tensor`` is skipped, as the reference skips ``-done``); the
  counts are kept by kind as well. They also count as bytes. DTensor's
  shard-dim all-to-all (``_dtensor.shard_dim_alltoall``, a shard moved
  between tensor dims on a CUDA mesh) is an all-to-all; on a CPU mesh
  DTensor runs it as an all-gather and a chunk, and it counts as that.

Memory: the mode tracks each storage that an op creates, from the op to
the storage's release, beside the arguments' storages registered before
the step: ``memory()`` gives the argument, output, temporary and alias
bytes and the peak of live bytes (``live_bytes``), the counterpart of
the reference's ``memory_analysis``. On a CUDA trace each storage is
rounded up to the caching allocator's 512-byte block. Storages that a
kernel op allocates inside its CUDA implementation and frees before it
returns are not seen.
"""

from __future__ import annotations

import threading
import weakref

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


# functional collectives (torch.ops._c10d_functional) by the reference's
# kind names; their waits are skipped
_COLL_OPS = {"all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
             "all_gather_into_tensor": "all-gather",
             "all_gather_into_tensor_coalesced": "all-gather",
             "reduce_scatter_tensor": "reduce-scatter",
             "reduce_scatter_tensor_coalesced": "reduce-scatter",
             "all_to_all_single": "all-to-all"}
# DTensor's own all-to-all (``torch.ops._dtensor``), a shard moved from one
# tensor dim to another on a CUDA mesh
_SHARD_ALL_TO_ALL = "shard_dim_alltoall"

# ops that move no data: allocation, metadata, and the counterparts of the
# reference's _SKIP_OPS (constant, iota, rng-bit-generator); so do the
# functional collectives' own wrappers and waits
_SKIP = {"empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "arange", "scalar_tensor", "lift_fresh",
         "lift_fresh_copy", "sym_size", "sym_stride", "sym_numel",
         "sym_storage_offset", "is_same_size", "device", "wait_tensor",
         "randint", "rand", "randn", "normal_", "uniform_", "random_",
         "bernoulli_", "set_", "record_stream", "resize_"}

# composite ops made of products (their FLOPs are their parts')
_PRODUCTS = {"einsum", "matmul", "linear", "tensordot", "bilinear"}

_ALLOC_BLOCK = 512          # the CUDA caching allocator's block rounding

_in_propagation = threading.local()
# the sharding propagator's shape inference on global stand-ins
_META = "_propagate_tensor_meta_non_cached"
_in_dtensor = threading.local()


class _Propagating:
    """Wraps the context the DTensor sharding propagator enters around its
    shape inference (``ShardingPropagator._fake_mode_lock``), whose ops run
    on global stand-ins and are not this device's work."""

    def __init__(self, inner):
        self.inner = inner

    def __enter__(self):
        self.inner.__enter__()
        _in_propagation.depth = getattr(_in_propagation, "depth", 0) + 1

    def __exit__(self, *exc):
        _in_propagation.depth -= 1
        return self.inner.__exit__(*exc)


def _propagating(fn):
    """``fn``, a sharding propagator's shape inference on global
    stand-ins, run marked as propagation (``_in_propagation``)."""
    def wrapped(*args, **kwargs):
        _in_propagation.depth = getattr(_in_propagation, "depth", 0) + 1
        try:
            return fn(*args, **kwargs)
        finally:
            _in_propagation.depth -= 1
    wrapped.inner = fn
    return wrapped


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    """Every return aliases an input without writing it (a view)."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


class OpAnalysis(TorchDispatchMode):
    """Counts one device's FLOPs, bytes and collectives, and its live
    storage bytes, while a step runs under it (see the module docstring).

    ``plain``: trace each kernel op on a CPU tensor through its plain
    version. ``fake_mode``: the ``FakeTensorMode`` of a fake trace; any
    other fake tensor seen is a stand-in of shape propagation and is not
    counted. ``device``: the device whose allocator the memory follows."""

    def __init__(self, *, plain: bool = False, fake_mode=None,
                 device: str = "cuda"):
        super().__init__()
        from ..kernels import _ops
        self._plain = _ops.PLAIN if plain else {}
        self._fake_mode = fake_mode
        self._round = device == "cuda"
        self.flops = 0
        self.bytes = 0
        self.collectives: list[tuple[str, int]] = []
        self._lock = threading.Lock()
        self._storages: dict[int, tuple[weakref.ref, int]] = {}
        self._args: dict[int, int] = {}
        self.live = 0
        self.peak = 0
        self._outputs: dict[int, int] = {}

    # -- memory ----------------------------------------------------------------

    def _size(self, nbytes: int) -> int:
        if self._round:
            return -(-nbytes // _ALLOC_BLOCK) * _ALLOC_BLOCK
        return nbytes

    def _released(self, key: int, ref) -> None:
        with self._lock:
            entry = self._storages.get(key)
            if entry is not None and entry[0] is ref:
                del self._storages[key]
                self.live -= entry[1]

    def _track(self, t: torch.Tensor) -> int | None:
        """Track ``t``'s storage from now to its release; returns its key."""
        st = t.untyped_storage()
        key = id(st)
        with self._lock:
            if key in self._storages and self._storages[key][0]() is st:
                return key
            n = self._size(st.nbytes())
            self._storages[key] = (weakref.ref(st, lambda r, k=key:
                                               self._released(k, r)), n)
            self.live += n
            self.peak = max(self.peak, self.live)
        return key

    def add_arguments(self, tree) -> None:
        """Registers the step's arguments (their local shards): live from
        the start, counted once each."""
        for t in _tensors(tree):
            t = _local(t)
            key = self._track(t)
            self._args[key] = self._storages[key][1]

    def add_outputs(self, tree) -> None:
        """Registers the step's outputs: storages not among the arguments
        are output bytes, those among them are aliased."""
        for t in _tensors(tree):
            t = _local(t)
            key = self._track(t)
            n = self._storages[key][1]
            self._outputs[key] = n

    def memory(self) -> dict:
        arg = sum(self._args.values())
        out = sum(self._outputs.values())
        alias = sum(n for k, n in self._outputs.items() if k in self._args)
        temp = max(self.peak - arg - out + alias, 0)
        return {"argument_size_in_bytes": arg, "output_size_in_bytes": out,
                "temp_size_in_bytes": temp, "alias_size_in_bytes": alias,
                "live_bytes": arg + out + temp - alias}

    # -- counts ------------------------------------------------------------------

    def result(self) -> dict:
        by_kind: dict[str, float] = {}
        counts: dict[str, int] = {}
        for kind, n in self.collectives:
            by_kind[kind] = by_kind.get(kind, 0.0) + n
            counts[kind] = counts.get(kind, 0) + 1
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "collective_bytes": float(sum(by_kind.values())),
                "collectives": by_kind, "collective_counts": counts}

    def _stand_in(self, tensors) -> bool:
        if getattr(_in_propagation, "depth", 0):
            return True
        from torch._subclasses.fake_tensor import FakeTensor
        return any(isinstance(t, FakeTensor) and t.fake_mode is not self._fake_mode
                   for t in tensors)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            if getattr(_in_dtensor, "depth", 0):
                return NotImplemented       # its local ops come back here
            # the DTensor dispatcher's own bookkeeping (shard offsets) runs
            # on real host tensors: the fake mode steps aside for it, and
            # the local shards, fake tensors themselves, still dispatch
            # through it
            from torch._subclasses.fake_tensor import unset_fake_temporarily
            _in_dtensor.depth = getattr(_in_dtensor, "depth", 0) + 1
            try:
                with unset_fake_temporarily(), self:
                    return func(*args, **kwargs)
            finally:
                _in_dtensor.depth -= 1
        ins = _tensors((args, kwargs))
        if self._stand_in(ins):
            return func(*args, **kwargs)
        plain = self._plain.get(func)
        if plain is not None and ins and ins[0].device.type == "cpu":
            with self:                      # count the plain version's ops
                return plain(*args, **kwargs)
        if func._opname in _PRODUCTS and func.namespace == "aten":
            # a composite product reaches the mode whole when it is called
            # below autograd (inside a plain version or a DTensor region):
            # count the products it decomposes into, as a call from above
            # autograd is
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        name = func._opname
        ns = func.namespace
        shard_a2a = ns == "_dtensor" and name == _SHARD_ALL_TO_ALL
        if shard_a2a and self._fake_mode is not None:
            # its fake implementation returns a view of every rank's copy
            # concatenated: an output of its own size, as the op gives
            out = out.clone()
        if (ns == "_c10d_functional" and name in _COLL_OPS) or shard_a2a:
            n = sum(_nbytes(t) for t in ins)
            self.collectives.append((_COLL_OPS.get(name, "all-to-all"), n))
            self.bytes += n + sum(_nbytes(t) for t in _tensors(out))
        elif name in _SKIP or ns in ("prim", "_c10d_functional") \
                or _is_view(func):
            pass
        else:
            self.bytes += (sum(_nbytes(t) for t in ins)
                           + sum(_nbytes(t) for t in _tensors(out)))
            formula = flop_counter.flop_registry.get(func._overloadpacket)
            if formula is not None:
                self.flops += int(formula(*args, **kwargs, out_val=out))
        if not _is_view(func):
            for t in _tensors(out):
                self._track(t)
        return out

    def __enter__(self):
        # the mode is entered again inside its own dispatch; the hooks on
        # the sharding propagator go in once, at the outermost entry: its
        # lock around shape inference, and the inference itself (torch
        # releases that build the global stand-ins outside the lock)
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        self._depth = getattr(self, "_depth", 0) + 1
        if self._depth == 1:
            lock = ShardingPropagator.__dict__.get("_fake_mode_lock")
            if lock is not None and not isinstance(lock, _Propagating):
                ShardingPropagator._fake_mode_lock = _Propagating(lock)
            meta = ShardingPropagator.__dict__.get(_META)
            if meta is not None and not hasattr(meta, "inner"):
                setattr(ShardingPropagator, _META, _propagating(meta))
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._depth -= 1
        if self._depth == 0:
            from torch.distributed.tensor._sharding_prop import \
                ShardingPropagator
            lock = ShardingPropagator.__dict__.get("_fake_mode_lock")
            if isinstance(lock, _Propagating):
                ShardingPropagator._fake_mode_lock = lock.inner
            meta = ShardingPropagator.__dict__.get(_META)
            if hasattr(meta, "inner"):
                setattr(ShardingPropagator, _META, meta.inner)
        return out


def analyze(fn, *args, plain: bool = False, fake_mode=None,
            device: str = "cuda", **kwargs) -> dict:
    """Runs ``fn(*args, **kwargs)`` once under ``OpAnalysis`` and returns
    the reference's keys (``flops``, ``bytes``, ``collective_bytes``,
    ``collectives``, ``collective_counts``), per device, with ``memory``
    (``OpAnalysis.memory``) beside them."""
    mode = OpAnalysis(plain=plain, fake_mode=fake_mode, device=device)
    mode.add_arguments((args, kwargs))
    with mode:
        out = fn(*args, **kwargs)
    mode.add_outputs(out)
    return {**mode.result(), "memory": mode.memory()}
