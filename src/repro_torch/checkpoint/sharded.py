"""Sharded (per-rank) checkpoint extraction, writing and elastic restore.

Save path, two phases (so the trainer only blocks on the cheap one):

  1. ``extract_snapshot(state)`` — device→host copy of every tensor leaf
     this rank writes (a ``DTensor``'s local shard with its global index,
     where the rank is the shard's first replica), the transparent-checkpoint
     "freeze" moment. The copies are pipelined:
     ``non_blocking`` copies into pinned host memory are issued across *all*
     leaves first (``prestage`` may already have issued them), then one
     gather pass waits on their events. With ``on_device_quantize``, selected
     leaves (optimizer moments before an urgent save) are absmax-int8
     quantized *on the device* first (the CUDA quantize kernels), so they
     cross the link at 1/4 width; the stored bytes equal a host quantize
     of the whole tensor: a sharded leaf's absmax is reduced over the ranks.
  2. ``write_snapshot(dir, snapshot)`` / ``write_snapshot_delta`` — encode +
     write, in the async writer thread.

Restore: tensors decode in parallel on the codec scheduler's RESTORE lane
into preallocated destination buffers (``CheckpointReader``).
``restore_to_template_streaming`` pipelines decode with the host→device
transfers: each payload is copied into a pinned staging buffer (never a
read-only mmap view handed to torch) and sent ``non_blocking``; int8
payloads cross at 1/4 width and widen on the device through the dequantize
kernel.

Restore is **mesh-independent** ("elastic"): the manifest stores global
shapes and per-piece global indices, and a template leaf that is a
``DTensor`` (or a ``TensorSpec`` with a mesh and placements) restores only
this rank's region of it, whatever mesh and rank count wrote the
checkpoint: range-addressed reads decode just the chunks the region
touches, int8 regions widen on the device, and every rank waits at the
restore barrier (``distributed.multihost``) before it returns. In a
process group of several ranks each rank writes its own pieces and rank 0
commits the one manifest (``store.CheckpointStore``).
"""

from __future__ import annotations

import bisect
import contextlib
import itertools
import os
import threading
import time
from concurrent.futures import Future
from concurrent.futures import wait as futures_wait
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from . import chunkstore
from . import manifest as mf
from . import serialize as ser
from .device_delta import DeltaBlocks, DeviceDeltaTracker, write_delta_blocks_piece
from .hostcopy import HostCopy
from .ioutil import fsync_dir
from ..distributed import multihost
from ..distributed import sharding as shd

Index = tuple[tuple[int, int], ...]

# leaves below this stored size batch into one executor task on restore
SMALL_LEAF_BYTES = 4096


@dataclass
class LeafPieces:
    """All pieces of one logical tensor. A piece payload is a dense host
    ndarray (storage dtype), or a ``device_delta.DeltaBlocks`` when the
    fingerprint path pruned the device→host copy to the dirty blocks."""

    global_shape: tuple[int, ...]
    dtype: str                     # logical dtype (pre-quantization)
    pieces: list[tuple[Index, Any]]     # ndarray | DeltaBlocks
    is_scalar_py: bool = False     # python int/float leaf (restore casts back)
    py_type: str = ""
    prequant: str = ""             # "int8": pieces hold on-device-quantized data
    scale: float | None = None     # absmax scale when prequant
    # (sha1 hex, crc32) of each chunk of the single piece's raw payload,
    # computed on the device (urgent saves; ``kernels.chunk_digest``)
    digests: list[tuple[str, int]] | None = None
    piece_base: int = 0            # number of the first piece (``name#k``)


@dataclass
class Snapshot:
    """Host-side frozen training state, ready to be written."""

    step: int
    leaves: dict[str, LeafPieces]
    leaf_order: list[str]
    treedef_repr: str
    mesh: dict
    nbytes: int = 0
    # D2H accounting: bytes that crossed the device→host link vs. bytes the
    # fingerprint path proved unchanged; stall_s is the wall time the
    # trainer was blocked inside extract
    d2h_bytes: int = 0
    d2h_skipped: int = 0
    stall_s: float = 0.0
    # seconds per leg of this save (``chunkstore.SaveLegs``): extract adds
    # the pinned allocation and the copy wait, the store the write's legs
    legs: chunkstore.SaveLegs = field(default_factory=chunkstore.SaveLegs)
    # the chunk size the leaves' device ``digests`` were taken at
    digest_chunk: int | None = None
    # the staged host copies behind ``leaves`` (``hostcopy.STAGING``
    # buffers), given back by ``release_staging`` once the save is written
    staging: list[HostCopy] = field(default_factory=list)
    # invoked by the store with the final manifest records once this
    # snapshot's checkpoint is durably committed (device-delta bookkeeping)
    on_committed: Callable[[list[dict]], None] | None = None

    def release_staging(self) -> None:
        """Give the staged pinned buffers back for the next save. The
        leaves they held are dropped: their arrays viewed those buffers."""
        released = [cp.release() for cp in self.staging]
        self.staging = []
        if any(released):
            self.leaves = {}


@dataclass
class Prestaged:
    """State whose device→host copies are already in flight (``prestage``):
    ``copies`` maps leaf name to its ``HostCopy``."""

    state: Any
    copies: dict[str, HostCopy] = field(default_factory=dict)


def _unwrap(state) -> tuple[Any, dict[str, HostCopy]]:
    if isinstance(state, Prestaged):
        return state.state, state.copies
    return state, {}


def prestage(state, tracker: DeviceDeltaTracker | None = None, *,
             skip: Callable[[str], bool] | None = None) -> Prestaged:
    """Start device→host copies for every CUDA tensor leaf (except those
    ``skip(name)`` selects — an urgent save's on-device-quantized moments).

    The trainer hands this to the coordinator as the state supplier, so the
    moment a checkpoint decision is made the copies are in flight — by the
    time ``extract_snapshot`` gathers, most bytes have landed.

    With a ``tracker`` (device-delta saves), fingerprint-eligible leaves
    launch their per-block digest + diff on the device instead of a
    full-leaf copy — only the dirty blocks will cross later. Urgent saves
    never pass a tracker.
    """
    state, copies = _unwrap(state)
    copies = dict(copies)
    multi = multihost.process_count() > 1
    for name, leaf in ser.flatten_state(state).items():
        if (not isinstance(leaf, torch.Tensor)
                or _local(leaf).device.type != "cuda"
                or (skip is not None and skip(name)) or not _writes(leaf, multi)):
            continue
        if tracker is not None and tracker.prestage_leaf(name, leaf):
            continue
        if name not in copies:
            copies[name] = HostCopy(_local(leaf), staged=True)
    return Prestaged(state, copies)


def _layout(leaf) -> shd.Sharding | None:
    """Mesh and placements of a ``DTensor`` leaf, else None."""
    if isinstance(leaf, DTensor):
        return shd.Sharding(leaf.device_mesh, tuple(leaf.placements))
    return None


def _local(leaf):
    """The tensor this rank holds of ``leaf``: a ``DTensor``'s local shard."""
    return leaf.to_local() if isinstance(leaf, DTensor) else leaf


def _writes(leaf, multi: bool) -> bool:
    """True when this rank writes ``leaf``: a ``DTensor``'s shard on the
    shard's first replica (``sharding.is_writer``); any other leaf, which
    every rank holds whole, on rank 0 of a process group of several."""
    lay = _layout(leaf)
    if lay is not None:
        return shd.is_writer(lay.mesh, lay.placements)
    return not multi or multihost.process_index() == 0


def _same_copy_source(cp: HostCopy, leaf) -> bool:
    """True when the prestaged copy ``cp`` reads ``leaf`` (for a ``DTensor``,
    its local shard: each ``to_local`` is a new alias of one storage)."""
    if cp.src is leaf:
        return True
    if not isinstance(leaf, DTensor):
        return False
    t = leaf.to_local()
    return (cp.src.data_ptr() == t.data_ptr() and cp.src.shape == t.shape
            and cp.src.stride() == t.stride() and cp.src.dtype == t.dtype)


def _quantize_on_device(everything: dict, named: dict,
                        predicate: Callable[[str], bool], multi: bool,
                        group=None) -> dict[str, tuple[HostCopy, float]]:
    """The urgent save's on-device int8 quantize of the float leaves
    ``predicate`` selects, for the leaves this rank writes (``named``).
    Each leaf takes its tensor-global scale: absmax runs on this rank's
    local tensor (a ``DTensor``'s shard), the maxima are MAX-reduced over
    the ranks of ``group`` on a host tensor (every rank takes part, in leaf
    order; over one rank, or over whole copies, the reduce changes
    nothing), and the quantize kernel runs on the local tensor with
    ``serialize.int8_scale_inv`` of the result, so the stored bytes equal a
    host quantize of the whole tensor."""
    from ..kernels.quantize import absmax, quantize_with_inv
    sel = [(name, _local(leaf).detach().contiguous())
           for name, leaf in everything.items()
           if isinstance(leaf, torch.Tensor) and leaf.ndim >= 1
           and leaf.dtype.is_floating_point and predicate(name)]
    if not sel:
        return {}
    maxima = torch.cat([absmax(t).cpu() for _n, t in sel])
    if multi:
        dist.all_reduce(maxima, op=dist.ReduceOp.MAX, group=group)
    out: dict[str, tuple[HostCopy, float]] = {}
    for (name, t), am in zip(sel, maxima.numpy()):
        if name in named:
            scale, inv = ser.int8_scale_inv(am)
            out[name] = (HostCopy(quantize_with_inv(t, inv), staged=True),
                         float(scale))
    return out


def _is_py_scalar(leaf) -> bool:
    return isinstance(leaf, (int, float, bool)) and not isinstance(leaf, np.generic)


def urgent_staging_sizes(state, *, quantize_moments: bool) -> list[int]:
    """The pinned buffer sizes an urgent save of ``state`` takes from
    ``STAGING``: each CUDA tensor leaf's bytes, at one byte an element for
    the moments a quantize-moments store quantizes on the device."""
    state, _copies = _unwrap(state)
    sizes = []
    for name, leaf in ser.flatten_state(state).items():
        if not isinstance(leaf, torch.Tensor):
            continue
        leaf = _local(leaf)
        if leaf.device.type != "cuda":
            continue
        int8 = (quantize_moments and leaf.ndim >= 1
                and leaf.dtype.is_floating_point and ser.is_moment_name(name))
        sizes.append(leaf.numel() * (1 if int8 else leaf.element_size()))
    return [n for n in sizes if n]


def _digest_on_device(copies, digest_chunk):
    """Launch the chunk digests of the CUDA copies whose chunks the store
    keeps raw (``digest_chunk``): one ``chunk_digests`` call over the
    contiguous tensors the copies read, a misaligned one cloned first.
    Returns (chunk size, names, pending digests), or None when no leaf is
    digested. A CUDA leaf the kernel cannot read raises."""
    from ..kernels.chunk_digest import chunk_digests, digestible
    names, tensors, sizes = [], [], set()
    for n, cp in copies:
        if not (isinstance(cp.src, torch.Tensor)
                and cp.src.device.type == "cuda"):
            continue                    # a host leaf: the write digests it
        if cp.device is None:
            raise RuntimeError(f"{n}: its host copy was already waited on")
        size = digest_chunk(n, cp.device)
        if size is None:
            continue
        t = cp.device if digestible(cp.device) else cp.device.clone()
        names.append(n)
        tensors.append(t)
        sizes.add(size)
    if not names:
        return None
    if len(sizes) != 1:
        raise ValueError(f"leaves digested at several chunk sizes: {sizes}")
    (size,) = sizes
    return size, names, chunk_digests(tensors, size)


def extract_snapshot(state, *, step: int, mesh_info: dict | None = None,
                     on_device_quantize: Callable[[str], bool] | None = None,
                     tracker: DeviceDeltaTracker | None = None,
                     digest_chunk: Callable[[str, torch.Tensor], int | None]
                     | None = None, group=None,
                     ) -> Snapshot:
    """Freeze ``state`` to host memory.

    Three passes: (0) optionally absmax-int8-quantize selected float leaves
    on the device (``on_device_quantize(name)`` — urgent saves pass the
    optimizer-moment predicate); (1) issue the ``non_blocking`` copies across
    every leaf so they overlap; (2) wait and gather — the only blocking pass.

    With a ``tracker`` (periodic delta saves), leaves whose previous-save
    fingerprints are on the device take the dirty-block path.
    ``on_device_quantize`` and ``tracker`` are mutually exclusive — urgent
    saves bypass fingerprinting.

    With ``digest_chunk`` (urgent saves: the store's
    ``urgent_digest_chunk``), every CUDA leaf copied whole for which
    ``digest_chunk(name, tensor)`` (the tensor the copy reads) names a
    chunk size — the store keeps its chunks as those bytes — also gets each
    chunk's SHA-1 and CRC-32 on the device (``kernels.chunk_digest``, one
    launch beside the copies), so the write that follows does not digest it
    on the host.

    A ``DTensor`` leaf gives one piece: this rank's local shard at its
    global index, written only by the shard's first replica (coordinate 0
    on every mesh dim that does not shard it); in a process group of
    several ranks any other leaf is written by rank 0 alone. Every rank
    calls this for the same state: the quantize's reduce is collective, on
    ``group`` (the store's ``save_group`` of the save that follows).
    """
    t_stall0 = time.perf_counter()
    state, copies = _unwrap(state)
    everything = ser.flatten_state(state)
    leaf_order = list(everything)
    multi = multihost.process_count() > 1
    named = {n: leaf for n, leaf in everything.items() if _writes(leaf, multi)}
    tracked: dict[str, Any] = {}
    commit_cb = None
    if tracker is not None and on_device_quantize is None:
        tracked, commit_cb = tracker.begin(named)
    prequant: dict[str, tuple[HostCopy, float]] = {}   # name -> (q copy, scale)
    if on_device_quantize is not None:
        prequant = _quantize_on_device(everything, named, on_device_quantize,
                                       multi, group)
    staged: dict[str, HostCopy] = {}
    for name, leaf in named.items():                # phase 1: async staging
        if name in tracked:
            tracked[name].resolve()     # diff sync + dirty-block gather
            continue
        if name in prequant or not isinstance(leaf, torch.Tensor):
            continue
        cp = copies.get(name)
        staged[name] = (cp if cp is not None and _same_copy_source(cp, leaf)
                        else HostCopy(_local(leaf), staged=True))
    legs = chunkstore.SaveLegs()
    legs.add("pin_alloc_busy_s", sum(cp.alloc_s for cp in staged.values())
             + sum(cp.alloc_s for cp, _scale in prequant.values()))
    digests = None
    if digest_chunk is not None:
        digests = _digest_on_device(
            [*staged.items(), *((n, cp) for n, (cp, _s) in prequant.items())],
            digest_chunk)
    t_wait = time.perf_counter()
    leaves: dict[str, LeafPieces] = {}
    nbytes = 0
    d2h_bytes = 0
    d2h_skipped = 0
    for name, leaf in named.items():                # phase 2: gather
        full_idx = lambda shape: tuple((0, int(s)) for s in shape)
        if name in tracked:
            st = tracked[name]
            res = st.finish()
            if res is not None:
                db, leaf_d2h, leaf_skip = res
                leaves[name] = LeafPieces(db.shape, db.dtype_name,
                                          [(full_idx(db.shape), db)])
                nbytes += db.nbytes
                d2h_bytes += leaf_d2h
                d2h_skipped += leaf_skip
                continue
            staged[name] = st.dense_copy       # high-churn dense fallback
        if name in prequant:
            cp, scale = prequant[name]
            arr = cp.numpy()
            lp = LeafPieces(tuple(arr.shape), ser.dtype_to_name(leaf.dtype),
                            [(full_idx(arr.shape), arr)], prequant="int8",
                            scale=scale)
        elif name in staged:
            arr = staged[name].numpy()
            lp = LeafPieces(tuple(arr.shape), ser.dtype_to_name(leaf.dtype),
                            [(full_idx(arr.shape), arr)])
        else:
            arr = ser.to_host(leaf)
            lp = LeafPieces(tuple(arr.shape), ser.leaf_dtype_name(leaf),
                            [(full_idx(arr.shape), arr)],
                            is_scalar_py=_is_py_scalar(leaf),
                            py_type=type(leaf).__name__)
        lay = _layout(leaf)
        if lay is not None:             # this rank's shard, at its global index
            (region,) = shd.addressable_shard_spans(lay.mesh, lay.placements,
                                                    tuple(leaf.shape))
            lp.global_shape = tuple(int(s) for s in leaf.shape)
            lp.piece_base = shd.piece_number(lay.mesh, lay.placements)
            lp.pieces = [(region, arr)] if all(a < b for a, b in region) else []
        nbytes += arr.nbytes
        d2h_bytes += arr.nbytes
        leaves[name] = lp
    chunk = None
    if digests is not None:
        chunk, names, pending = digests
        for n, per_chunk in zip(names, pending.result()):
            leaves[n].digests = per_chunk
    t_end = time.perf_counter()
    legs.add("d2h_wait_s", t_end - t_wait)
    legs.add("extract_s", t_end - t_stall0)
    return Snapshot(step=step, leaves=leaves, leaf_order=leaf_order,
                    treedef_repr=ser.structure_repr(state),
                    mesh=mesh_info or {}, nbytes=nbytes, d2h_bytes=d2h_bytes,
                    d2h_skipped=d2h_skipped, stall_s=t_end - t_stall0,
                    legs=legs, digest_chunk=chunk,
                    staging=[*staged.values(),
                                        *(cp for cp, _s in prequant.values())],
                    on_committed=commit_cb)


def _piece_codec(name: str, lp: LeafPieces, arr: np.ndarray, *,
                 compress: bool, quantize_moments: bool) -> str:
    """Codec for one piece; a pre-quantized piece keeps its int8 half and
    only the compression half is policy-chosen (over the int8 payload)."""
    if lp.prequant:
        comp = ser.default_codec_for(name, arr, compress=compress,
                                     quantize_moments=False)
        return lp.prequant if comp == "raw" else f"{lp.prequant}+{comp}"
    return ser.default_codec_for(name, arr, compress=compress,
                                 quantize_moments=quantize_moments,
                                 dtype_name=lp.dtype)


def write_snapshot(
    dirpath: str,
    snapshot: Snapshot,
    *,
    process_index: int = 0,
    compress: bool = True,
    quantize_moments: bool = False,
) -> list[dict]:
    """Write this process's shard container. Returns tensor records (+file)."""
    pending = []
    for name, lp in snapshot.leaves.items():
        for pi, (index, arr) in enumerate(lp.pieces, lp.piece_base):
            codec = _piece_codec(name, lp, arr, compress=compress,
                                 quantize_moments=quantize_moments)
            pending.append(ser.encode_tensor(
                f"{name}#{pi}", arr, global_shape=lp.global_shape,
                index=index, codec=codec,
                prequant_scale=lp.scale if lp.prequant else None,
                logical_dtype=lp.dtype))
    fname = f"shard_p{process_index:03d}.spot"
    records = ser.write_shard_file(os.path.join(dirpath, fname), pending)
    out = []
    for rec in records:
        d = rec.to_json()
        d["file"] = fname
        out.append(d)
    return out


def _delta_encode_piece(pool, key, arr, codec, chunk_size, index, pin,
                        prequant_scale=None, dirty_dirs=None, dtype_name=None,
                        legs=None, writes=None, digests=None):
    """Worker-pool task: quantize one piece, chunk it into the pool. Device
    ``digests`` of the piece's bytes stand in for the host's; they are
    given only where the stored chunks are those bytes (no host quantize,
    no compression: the store's ``urgent_digest_chunk``)."""
    codec = ser.resolve_codec(codec)
    quant, comp = ser.split_codec(codec)
    if digests is not None and (comp not in ("", "raw")
                                or (quant and prequant_scale is None)):
        raise ValueError(f"{key}: device digests given for chunks stored "
                         f"as {codec}")
    if prequant_scale is not None:
        raw, scale = np.ascontiguousarray(arr), prequant_scale
    else:
        raw, scale = ser.quantize(arr, quant, dtype_name)
    nbytes = raw.nbytes
    refs, written = chunkstore.store_payload_chunks(
        pool, key, ser.array_bytes_view(raw), codec=codec, comp=comp,
        chunk_size=chunk_size, index=index, pin=pin, dirty_dirs=dirty_dirs,
        legs=legs, writes=writes, digests=digests)
    return codec, scale, refs, written, nbytes


def write_snapshot_delta(
    snapshot: Snapshot,
    pool: chunkstore.ChunkPool,
    *,
    compress: bool = True,
    quantize_moments: bool = False,
    chunk_size: int = chunkstore.DEFAULT_CHUNK_SIZE,
    index: chunkstore.DeltaIndex | None = None,
    pin=lambda h: None,
    executor=None,
    urgent: bool = False,
) -> tuple[list[dict], int]:
    """Incremental write: every piece chunked into the shared pool.

    Returns (manifest tensor records, bytes physically written). Every chunk
    a manifest references is durable before this returns (per-save
    dir-fsync barrier for a POSIX pool; a backend pool's ``flush_uploads``
    barrier runs in the store). The chunk and directory-fsync legs are
    charged to ``snapshot.legs``. An ``urgent`` (termination) save digests
    on ``executor`` and writes on the urgent IO pool
    (``chunkstore.ChunkWrites``).
    """
    if snapshot.digest_chunk not in (None, chunk_size):
        raise ValueError(f"leaves digested at {snapshot.digest_chunk}-byte "
                         f"chunks, written at {chunk_size}")
    ex = executor if executor is not None else chunkstore.codec_executor()
    legs = snapshot.legs
    t0 = time.perf_counter()
    jobs = []
    dirty_dirs: set[str] = set()    # fan-out dirs with new chunks this save
    writes = chunkstore.ChunkWrites(pool, dirty_dirs, legs) if urgent else None
    # an urgent save holds periodic saves' chunk writes while it writes
    with chunkstore.urgent_window() if urgent else contextlib.nullcontext():
        for name, lp in snapshot.leaves.items():
            for pi, (idx, arr) in enumerate(lp.pieces, lp.piece_base):
                if isinstance(arr, DeltaBlocks):
                    fut = ex.submit(write_delta_blocks_piece, pool, (name, pi),
                                    arr, index, pin, dirty_dirs)
                    jobs.append((name, pi, idx, lp, arr, fut))
                    continue
                arr = np.asarray(arr)
                codec = _piece_codec(name, lp, arr, compress=compress,
                                     quantize_moments=quantize_moments)
                fut = ex.submit(_delta_encode_piece, pool, (name, pi), arr,
                                codec, chunk_size, index, pin,
                                lp.scale if lp.prequant else None, dirty_dirs,
                                lp.dtype, legs, writes, lp.digests)
                jobs.append((name, pi, idx, lp, arr, fut))
        try:
            results = [fut.result() for *_rest, fut in jobs]
        except BaseException:
            # quiesce before propagating: a straggler task must not call pin()
            # after the caller has already unpinned this save's chunks, nor a
            # straggler write land after the save has failed
            for *_rest, fut in jobs:
                fut.cancel()
            futures_wait([fut for *_rest, fut in jobs])
            if writes is not None:
                try:
                    writes.wait()
                except BaseException:
                    pass                # the first failure is the one raised
            raise
        deferred_bytes = writes.wait() if writes is not None else 0
        t0 = chunkstore.charge_leg(legs, "chunks_s", t0)
        if dirty_dirs:
            sync_futs = [ex.submit(fsync_dir, d) for d in dirty_dirs]
            futures_wait(sync_futs)
            for sf in sync_futs:
                sf.result()
        chunkstore.charge_leg(legs, "dir_fsync_s", t0)
    records = []
    new_bytes = deferred_bytes
    for (name, pi, idx, lp, arr, fut), res in zip(jobs, results):
        codec, scale, refs, written, raw_len = res
        new_bytes += written
        if isinstance(arr, DeltaBlocks):
            shape, dtype_name = arr.shape, arr.dtype_name
        else:
            shape, dtype_name = tuple(arr.shape), lp.dtype
        rec = ser.TensorRecord(
            name=f"{name}#{pi}", dtype=dtype_name,
            shape=shape, global_shape=lp.global_shape,
            index=idx, nbytes=sum(r.nbytes for r in refs), crc32=0,
            codec=codec, scale=scale)
        d = rec.to_json()
        d["chunks"] = [r.to_json() for r in refs]
        d["raw_nbytes"] = raw_len
        quant, _ = ser.split_codec(codec)
        if shape:
            row_bytes = (int(np.prod(shape[1:], dtype=np.int64))
                         * ser.stored_dtype(dtype_name, quant).itemsize)
            spans = mf.shard_span_map(shape, row_bytes,
                                      (r.raw_len for r in refs))
            if spans is not None:
                d["shard_spans"] = spans
        records.append(d)
    return records, new_bytes


# ---------------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------------

def _submit_leaf_jobs(
    ex: Any,
    names: Sequence[str],
    size_of: Callable[[str], int],
    run_one: Callable[[str], Any],
) -> tuple[dict[str, Callable[[], Any]], list[Future]]:
    """One decode job per leaf, coalescing sub-4KiB leaves into one task.
    Returns ({name: resolver}, submitted futures)."""
    small = [n for n in names if size_of(n) < SMALL_LEAF_BYTES]
    resolve: dict[str, Callable[[], Any]] = {}
    futs: list[Future] = []
    if len(small) >= 2:
        small_fut = ex.submit(
            lambda ns=tuple(small): {n: run_one(n) for n in ns})
        futs.append(small_fut)
        for n in small:
            resolve[n] = (lambda n=n: small_fut.result()[n])
    for n in names:
        if n not in resolve:
            fut = ex.submit(run_one, n)
            futs.append(fut)
            resolve[n] = fut.result
    return resolve, futs


class CheckpointReader:
    """Random access over a committed checkpoint's tensors.

    Reads both manifest formats: v1 records point into per-process shard
    container files inside the step dir; v2 (delta) records carry chunk
    references into the store's shared content-addressed pool. Payloads come
    back as numpy arrays in their storage dtype (bfloat16 as uint16 bits).
    """

    def __init__(self, ckpt_dir: str, tensor_records: list[dict],
                 chunk_pool: chunkstore.ChunkPool | None = None):
        self.ckpt_dir = ckpt_dir
        self.chunk_pool = chunk_pool or chunkstore.ChunkPool(
            os.path.join(os.path.dirname(os.path.abspath(ckpt_dir)),
                         chunkstore.CHUNKS_DIRNAME))
        self._readers: dict[str, ser.ShardFileReader] = {}
        self._readers_lock = threading.Lock()
        # shard-aware restore accounting: chunks decoded vs proven skippable
        # by range-addressed reads, plus regions that fell back to piece
        # assembly — the tests and the chip run read these
        self.region_stats = {"region_reads": 0, "chunks_decoded": 0,
                             "chunks_skipped": 0, "fallback_reads": 0}
        self._stats_lock = threading.Lock()
        self.by_name: dict[str, list[dict]] = {}
        for rec in tensor_records:
            base = rec["name"].rsplit("#", 1)[0]
            self.by_name.setdefault(base, []).append(rec)

    def close(self) -> None:
        with self._readers_lock:
            readers, self._readers = list(self._readers.values()), {}
        for r in readers:
            r.close()

    def _reader(self, fname: str) -> ser.ShardFileReader:
        with self._readers_lock:
            if fname not in self._readers:
                self._readers[fname] = ser.ShardFileReader(
                    os.path.join(self.ckpt_dir, fname))
            return self._readers[fname]

    def _read_piece_into(self, rec: dict, out: np.ndarray | None,
                         *, parallel: bool = True) -> np.ndarray:
        """Decode one piece; fills ``out`` in place when it matches the
        stored payload, else returns a freshly decoded array."""
        quant, _comp = ser.split_codec(rec.get("codec", "raw"))
        if "chunks" in rec:
            pdtype = ser.stored_dtype(rec["dtype"], quant)
            if (out is not None and not quant and out.dtype == pdtype
                    and tuple(out.shape) == tuple(rec["shape"])
                    and out.flags.c_contiguous):
                dst = out
            else:
                dst = ser.alloc_payload(rec["dtype"], rec["shape"], quant)
            chunkstore.read_payload_into(
                self.chunk_pool, rec["chunks"], dst,
                executor=chunkstore.restore_executor() if parallel else None)
            return ser.finish_payload(dst, dtype_name=rec["dtype"],
                                      quant=quant, scale=rec.get("scale"))
        reader = self._reader(rec["file"])
        if out is not None and reader.read_into(rec["name"], out):
            return out
        return reader.read(rec["name"])

    def global_shape(self, name: str) -> tuple[int, ...]:
        return tuple(self.by_name[name][0]["global_shape"])

    def dtype_name(self, name: str) -> str:
        return self.by_name[name][0]["dtype"]

    def dtype(self, name: str) -> np.dtype:
        """numpy storage dtype of ``name``'s logical payload."""
        return ser.name_to_dtype(self.dtype_name(name))

    def names(self) -> list[str]:
        return list(self.by_name)

    def read_slice(self, name: str, index: Index | None = None,
                   *, parallel: bool = True) -> np.ndarray:
        """Assemble an arbitrary global slice of ``name`` from saved pieces
        (storage dtype)."""
        gshape = self.global_shape(name)
        full = tuple((0, int(s)) for s in gshape)
        if index is None:
            index = full
        if tuple(tuple(int(x) for x in p) for p in index) == full:
            rec = self.single_piece_record(name)
            if rec is not None:
                return self._read_piece_into(rec, None, parallel=parallel)
        out_shape = tuple(stop - start for start, stop in index)
        out = np.empty(out_shape, dtype=self.dtype(name))
        filled = 0
        for rec in self.by_name[name]:
            pidx = tuple(tuple(p) for p in rec["index"])
            inter = tuple((max(a0, b0), min(a1, b1))
                          for (a0, a1), (b0, b1) in zip(index, pidx))
            if any(lo >= hi for lo, hi in inter):
                continue
            n_inter = int(np.prod([hi - lo for lo, hi in inter]))
            if inter == pidx == tuple(index):
                piece = self._read_piece_into(rec, out, parallel=parallel)
                if piece is not out:
                    out[...] = piece
                filled += n_inter
                continue
            piece = self._read_piece_into(rec, None, parallel=parallel)
            src = tuple(slice(lo - b0, hi - b0) for (lo, hi), (b0, _) in zip(inter, pidx))
            dst = tuple(slice(lo - a0, hi - a0) for (lo, hi), (a0, _) in zip(inter, index))
            out[dst] = piece[src]
            filled += n_inter
        if filled != int(np.prod(out_shape)):
            raise IOError(
                f"{name}: requested region not fully covered by saved pieces "
                f"({filled} of {int(np.prod(out_shape))} elements)")
        return out

    def stored_nbytes(self, name: str) -> int:
        """Stored (encoded) bytes across all of ``name``'s pieces."""
        return sum(int(r.get("nbytes", 0)) for r in self.by_name[name])

    def single_piece_record(self, name: str) -> dict | None:
        """The one record covering the whole tensor, or None when the tensor
        was saved as multiple shard pieces."""
        recs = self.by_name[name]
        if len(recs) != 1:
            return None
        rec = recs[0]
        full = tuple((0, int(s)) for s in rec["global_shape"])
        if tuple(tuple(int(x) for x in p) for p in rec["index"]) != full:
            return None
        return rec

    def _count(self, **deltas) -> None:
        with self._stats_lock:
            for k, v in deltas.items():
                self.region_stats[k] += v

    def _read_rows(self, rec: dict, a: int, b: int, *, parallel: bool
                   ) -> tuple[np.ndarray, int, int] | None:
        """Stored payload (pre-dequantize) of rows ``[a, b)`` of one v2
        piece, decoding only the chunks those rows' bytes touch: (rows,
        chunks decoded, chunks skipped), or None for a degenerate map.
        Chunks come from the manifest's shard-span map when the record has
        one, else from ``raw_len`` prefix sums — both pick the same ones."""
        shape = tuple(int(s) for s in rec["shape"])
        quant, _comp = ser.split_codec(rec.get("codec", "raw"))
        pdtype = ser.stored_dtype(rec["dtype"], quant)
        row_bytes = int(np.prod(shape[1:], dtype=np.int64)) * pdtype.itemsize
        byte_lo, byte_hi = a * row_bytes, b * row_bytes
        refs = rec["chunks"]
        offs = mf.chunk_byte_offsets(rec)
        spans = mf.record_shard_spans(rec)
        if spans is not None:
            # chunks whose row band intersects [a, b)
            c0 = bisect.bisect_right([hi for _, hi in spans], a)
            c1 = bisect.bisect_left([lo for lo, _ in spans], b)
        else:
            c0 = bisect.bisect_right(offs, byte_lo) - 1
            c1 = bisect.bisect_left(offs, byte_hi)
        c0, c1 = max(c0, 0), min(c1, len(refs))
        if c1 <= c0:
            return None
        out = np.empty((b - a, *shape[1:]), dtype=pdtype)
        decoded, skipped = chunkstore.read_payload_range_into(
            self.chunk_pool, refs[c0:c1], out, byte_lo=byte_lo,
            base_off=offs[c0],
            executor=chunkstore.restore_executor() if parallel else None)
        return out, decoded, skipped + (len(refs) - (c1 - c0))

    def read_region_streaming(self, name: str, region: Index,
                              *, parallel: bool = True) -> np.ndarray | None:
        """Range-addressed decode of one contiguous global region of ``name``
        — only the chunks whose bytes the region touches are opened, so a
        sharded restore reads O(shard), not O(tensor).

        The stored layout must allow it: a v2 single-full-piece record whose
        flat C-order payload makes the region one contiguous byte range
        (only axis 0 sub-sliced; trailing axes full). Returns the region in
        the logical (storage) dtype, or None when the layout cannot be
        range-addressed (v1 container records, multi-piece saves,
        trailing-axis slices); callers fall back to ``read_slice``.
        Bit-identical to slicing the full-leaf read: int8 dequantization
        multiplies elementwise with the tensor-global scale."""
        rec = self.single_piece_record(name)
        if rec is None or "chunks" not in rec:
            return None
        shape = tuple(int(s) for s in rec["shape"])
        region = tuple((int(a), int(b)) for a, b in region)
        if len(region) != len(shape):
            return None
        if any(not 0 <= a <= b <= s for (a, b), s in zip(region, shape)):
            return None
        if region == tuple((0, s) for s in shape):
            return self._read_piece_into(rec, None, parallel=parallel)
        if any((a, b) != (0, s) for (a, b), s in zip(region[1:], shape[1:])):
            return None          # trailing-axis sub-slice: not flat-contiguous
        got = self._read_rows(rec, *region[0], parallel=parallel)
        if got is None:
            return None          # degenerate map/region: let read_slice decide
        out, decoded, skipped = got
        self._count(region_reads=1, chunks_decoded=decoded,
                    chunks_skipped=skipped)
        quant, _comp = ser.split_codec(rec.get("codec", "raw"))
        return ser.finish_payload(out, dtype_name=rec["dtype"], quant=quant,
                                  scale=rec.get("scale"))

    def read_region_for_restore(self, name: str, region: Index) -> np.ndarray:
        """One shard-region decode job on the RESTORE lane: range-addressed
        when the stored layout allows, ``read_slice`` fallback otherwise.
        Runs *on* the restore executor, so chunk work inside stays serial."""
        arr = self.read_region_streaming(name, region, parallel=False)
        if arr is not None:
            return arr
        self._count(fallback_reads=1)
        return self.read_slice(name, region, parallel=False)

    def _piece_region(self, rec: dict, local: Index) -> tuple[np.ndarray, int, int]:
        """Stored payload of the piece-local ``local`` region of one v2
        piece: (array, chunks decoded, chunks skipped). The region is read
        as its C-order byte runs, each range-addressed, where every run
        spans at least a chunk; otherwise the whole piece is decoded and
        sliced."""
        shape = tuple(int(s) for s in rec["shape"])
        refs = rec["chunks"]
        partial = [i for i, ((a, b), s) in enumerate(zip(local, shape))
                   if (a, b) != (0, s)]
        quant, _comp = ser.split_codec(rec.get("codec", "raw"))
        pdtype = ser.stored_dtype(rec["dtype"], quant)
        if partial:
            k = partial[-1]             # axes after k are whole: one run each
            inner = int(np.prod(shape[k + 1:], dtype=np.int64))
            run = (local[k][1] - local[k][0]) * inner
            if run * pdtype.itemsize >= max(int(r["r"]) for r in refs):
                return self._read_runs(rec, local, k, inner, run, pdtype)
        dst = ser.alloc_payload(rec["dtype"], shape, quant)
        chunkstore.read_payload_into(self.chunk_pool, refs, dst, executor=None)
        return dst[tuple(slice(a, b) for a, b in local)], len(refs), 0

    def _read_runs(self, rec, local, k, inner, run, pdtype):
        shape = tuple(int(s) for s in rec["shape"])
        refs = rec["chunks"]
        offs = mf.chunk_byte_offsets(rec)
        strides = [int(np.prod(shape[i + 1:], dtype=np.int64))
                   for i in range(len(shape))]
        out = np.empty(tuple(b - a for a, b in local), dtype=pdtype)
        flat = out.reshape(-1)
        decoded, touched = 0, set()
        outer = itertools.product(*(range(a, b) for a, b in local[:k]))
        for j, idx in enumerate(outer):
            lo = (sum(i * st for i, st in zip(idx, strides))
                  + local[k][0] * inner) * pdtype.itemsize
            hi = lo + run * pdtype.itemsize
            c0 = bisect.bisect_right(offs, lo) - 1
            c1 = bisect.bisect_left(offs, hi)
            d, _s = chunkstore.read_payload_range_into(
                self.chunk_pool, refs[c0:c1], flat[j * run:(j + 1) * run],
                byte_lo=lo, base_off=offs[c0], executor=None)
            decoded += d
            touched.update(range(c0, c1))
        return out, decoded, len(refs) - len(touched)

    def read_region_payload(self, name: str, region: Index
                            ) -> tuple[np.ndarray, str, str, float | None]:
        """This rank's region of ``name`` for the sharded restore, in its
        stored form: (payload, logical dtype name, quant, scale) — an int8
        region stays int8 for the device to widen. Runs on the restore
        executor, so chunk work inside stays serial.

        A single-piece record whose region is a row band (the whole leaf
        too) is read range-addressed (``region_reads``). Otherwise the region is
        assembled from the pieces it intersects (``fallback_reads``): each
        piece decodes only the chunks the region's byte runs in it touch
        where the runs span a chunk, and pieces it misses are skipped whole.
        Pieces of one int8 scale assemble still quantized; v1 container
        records, and int8 pieces of differing scales, assemble logical
        through ``read_slice``."""
        region = tuple((int(a), int(b)) for a, b in region)
        gshape = self.global_shape(name)
        rec = self.single_piece_record(name)
        if rec is not None and "chunks" in rec:
            quant, _comp = ser.split_codec(rec.get("codec", "raw"))
            out = None
            if region == tuple((0, int(s)) for s in gshape):
                out = ser.alloc_payload(rec["dtype"], rec["shape"], quant)
                chunkstore.read_payload_into(self.chunk_pool, rec["chunks"],
                                             out, executor=None)
                self._count(region_reads=1, chunks_decoded=len(rec["chunks"]))
            elif all((a, b) == (0, int(s))
                     for (a, b), s in zip(region[1:], gshape[1:])):
                got = self._read_rows(rec, *region[0], parallel=False)
                if got is not None:
                    out, decoded, skipped = got
                    self._count(region_reads=1, chunks_decoded=decoded,
                                chunks_skipped=skipped)
            if out is not None:
                return out, rec["dtype"], quant, rec.get("scale")
        self._count(fallback_reads=1)
        recs = self.by_name[name]
        codecs = {(ser.split_codec(r.get("codec", "raw"))[0], r.get("scale"))
                  for r in recs}
        if any("chunks" not in r for r in recs) or len(codecs) != 1:
            return (self.read_slice(name, region, parallel=False),
                    self.dtype_name(name), "", None)
        ((quant, scale),) = codecs
        dtype_name = self.dtype_name(name)
        out = np.empty(tuple(b - a for a, b in region),
                       dtype=ser.stored_dtype(dtype_name, quant))
        filled = decoded = skipped = 0
        for r in recs:
            pidx = tuple(tuple(int(x) for x in p) for p in r["index"])
            inter = tuple((max(a0, b0), min(a1, b1))
                          for (a0, a1), (b0, b1) in zip(region, pidx))
            if any(lo >= hi for lo, hi in inter):
                skipped += len(r["chunks"])
                continue
            local = tuple((lo - b0, hi - b0) for (lo, hi), (b0, _) in zip(inter, pidx))
            part, d, sk = self._piece_region(r, local)
            decoded += d
            skipped += sk
            out[tuple(slice(lo - a0, hi - a0)
                      for (lo, hi), (a0, _) in zip(inter, region))] = part
            filled += part.size
        self._count(chunks_decoded=decoded, chunks_skipped=skipped)
        if filled != out.size:
            raise IOError(f"{name}: region {region} not fully covered by saved "
                          f"pieces ({filled} of {out.size} elements)")
        return out, dtype_name, quant, scale

    def read_payload(self, name: str, *, parallel: bool = True
                     ) -> tuple[np.ndarray, str, str, float | None]:
        """Stored (post-decompress, pre-dequantize) payload of a
        single-full-piece tensor: (payload, logical dtype name, quant,
        scale). An int8-coded record's payload comes back as int8. The
        payload may be a read-only view of the mapped chunk or container;
        callers copy it before handing it to torch."""
        rec = self.single_piece_record(name)
        if rec is None:
            raise ValueError(f"{name}: not a single full-coverage piece")
        quant, _comp = ser.split_codec(rec.get("codec", "raw"))
        pdtype = ser.stored_dtype(rec["dtype"], quant)
        shape = tuple(rec["shape"])
        if "chunks" in rec:
            crefs = rec["chunks"]
            if len(crefs) == 1:
                ref = chunkstore.ChunkRef.from_json(crefs[0])
                if ref.comp in ("", "raw"):
                    # intentional escape: the view's lifetime is the
                    # returned array's; the pool chunk is immutable and
                    # committed, and the restore copies out of it
                    view = self.chunk_pool.read_view(ref)  # spotlint: ignore[SPOT020]
                    arr = np.frombuffer(view, dtype=pdtype).reshape(shape)
                    return arr, rec["dtype"], quant, rec.get("scale")
            dst = ser.alloc_payload(rec["dtype"], shape, quant)
            chunkstore.read_payload_into(
                self.chunk_pool, crefs, dst,
                executor=chunkstore.restore_executor() if parallel else None)
            return dst, rec["dtype"], quant, rec.get("scale")
        # intentional escape: lifetime transfers to the np.frombuffer array;
        # the reader's mapping stays open until this CheckpointReader closes
        view = self._reader(rec["file"]).read_payload_view(rec["name"])  # spotlint: ignore[SPOT020]
        if view is not None:
            arr = np.frombuffer(view, dtype=pdtype).reshape(shape)
            return arr, rec["dtype"], quant, rec.get("scale")
        dst = ser.alloc_payload(rec["dtype"], shape, quant)
        if not self._reader(rec["file"]).read_payload_into(rec["name"], dst):
            raise IOError(f"{name}: container payload does not match its record")
        return dst, rec["dtype"], quant, rec.get("scale")

    def read_many(self, names: list[str]) -> dict[str, np.ndarray]:
        """Read whole tensors in parallel (one restore-lane job per leaf)."""
        resolve, futs = _submit_leaf_jobs(
            chunkstore.restore_executor(), names, self.stored_nbytes,
            lambda n: self.read_slice(n, None, parallel=False))
        try:
            return {n: resolve[n]() for n in names}
        except BaseException:
            for f in futs:
                f.cancel()
            futures_wait(futs)
            raise

    def validate(self) -> None:
        """Full-content crc validation of every piece (per-chunk for v2)."""
        for recs in self.by_name.values():
            for rec in recs:
                self._read_piece_into(rec, None)


# ---------------------------------------------------------------------------
# templates
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TensorSpec:
    """Allocation-free restore template leaf: where and as what a tensor
    should land (the port's ``jax.ShapeDtypeStruct`` with a sharding). With
    a ``mesh`` and ``placements`` it restores as a ``DTensor`` of which this
    rank holds its region, on ``device``."""

    shape: tuple[int, ...]
    dtype: torch.dtype
    device: torch.device
    mesh: Any = None
    placements: tuple | None = None


def _leaf_device(leaf) -> torch.device | None:
    """Target device of a template leaf (a ``DTensor``'s: its local
    shard's); None for host (numpy/scalar)."""
    if isinstance(leaf, (torch.Tensor, TensorSpec)):
        return torch.device(_local(leaf).device if isinstance(leaf, DTensor)
                            else leaf.device)
    return None


def _leaf_sharding(leaf) -> shd.Sharding | None:
    """The mesh and placements a template leaf restores onto, or None."""
    if isinstance(leaf, TensorSpec) and leaf.mesh is not None:
        return shd.Sharding(leaf.mesh, tuple(leaf.placements))
    return _layout(leaf)


def _region(sharding: shd.Sharding, leaf) -> Index:
    """This rank's region of a sharded template leaf."""
    (region,) = shd.addressable_shard_spans(sharding.mesh, sharding.placements,
                                            tuple(leaf.shape))
    return region


def _region_tensor(leaf, payload, dtype_name: str, quant: str, scale
                   ) -> torch.Tensor:
    """A region's payload on the template leaf's device, in its dtype: an
    int8 region bound for the card crosses at 1/4 width and widens there
    (the dequantize kernel; bit-identical to ``finish_payload``), any other
    is finished on the host first."""
    dev = _leaf_device(leaf)
    if (quant == "int8" and dev.type == "cuda"
            and leaf.dtype in (torch.float32, torch.bfloat16, torch.float16)
            and leaf.dtype == ser.torch_dtype(dtype_name)):
        from ..kernels.quantize import dequantize_int8
        return dequantize_int8(_tensor_from_payload(payload, "int8", dev),
                               scale, dtype=leaf.dtype)
    if quant:
        payload = ser.finish_payload(payload, dtype_name=dtype_name,
                                     quant=quant, scale=scale)
    return _to_template_dtype(_tensor_from_payload(payload, dtype_name, dev),
                              leaf)




def _check_template(reader: CheckpointReader, named: dict) -> None:
    for name, leaf in named.items():
        if name not in reader.by_name:
            raise KeyError(f"checkpoint missing leaf {name!r}; has "
                           f"{sorted(reader.by_name)[:8]}...")
        if hasattr(leaf, "shape") and reader.global_shape(name) != tuple(leaf.shape):
            raise ValueError(
                f"{name}: shape mismatch ckpt={reader.global_shape(name)} "
                f"vs template={tuple(leaf.shape)}")


def _host_leaf_value(leaf, arr: np.ndarray, dtype_name: str):
    """Finalize a host-destined leaf (scalar cast back to its python type;
    arrays cast to the template dtype)."""
    if _is_py_scalar(leaf):
        return type(leaf)(arr.reshape(())[()])
    want = np.asarray(leaf).dtype
    if dtype_name == want.name:
        return arr if arr.dtype == want else arr.view(want)   # same bits
    return arr.astype(want, copy=False)


def _to_template_dtype(t: torch.Tensor, leaf) -> torch.Tensor:
    return t if t.dtype == leaf.dtype else t.to(leaf.dtype)


def _pinned_staging(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """Copy a (possibly read-only, mmap-backed) payload into a pinned
    host tensor of its logical dtype."""
    t = torch.empty(arr.shape, dtype=ser.torch_dtype(dtype_name),
                    pin_memory=True)
    ser.tensor_to_numpy(t)[...] = arr
    return t


def _tensor_from_payload(arr: np.ndarray, dtype_name: str,
                         device: torch.device) -> torch.Tensor:
    if device.type == "cuda":
        return _pinned_staging(arr, dtype_name).to(device, non_blocking=True)
    return ser.numpy_to_tensor(arr, dtype_name).to(device)


def restore_to_template(reader: CheckpointReader, template) -> Any:
    """Restore a state matching ``template``'s structure, shapes and devices.

    Template leaves may be torch tensors or ``TensorSpec``s (restored onto
    their device, in their dtype), numpy arrays (host), or python scalars.
    A ``DTensor`` leaf, or a ``TensorSpec`` with a mesh, restores as a
    ``DTensor`` holding only this rank's region, assembled from the pieces
    of whatever mesh saved it.
    Every leaf decodes in parallel on the host (``read_many``) and int8
    payloads dequantize on the host; see ``restore_to_template_streaming``
    for the pipelined restore that widens on the device.
    """
    named = ser.flatten_state(template)
    _check_template(reader, named)
    sharded = {n: _leaf_sharding(leaf) for n, leaf in named.items()}
    host = reader.read_many([n for n in named if sharded[n] is None])
    out = {}
    for name, leaf in named.items():
        dev = _leaf_device(leaf)
        if sharded[name] is not None:
            # this rank's region only, assembled from the saved pieces
            arr = reader.read_slice(name, _region(sharded[name], leaf))
            out[name] = shd.from_local(_to_template_dtype(_tensor_from_payload(
                arr, reader.dtype_name(name), dev), leaf), sharded[name],
                tuple(leaf.shape))
        elif dev is None:
            out[name] = _host_leaf_value(leaf, host[name], reader.dtype_name(name))
        else:
            out[name] = _to_template_dtype(_tensor_from_payload(
                host[name], reader.dtype_name(name), dev), leaf)
    return ser.unflatten_like(template, out)


def restore_to_template_streaming(reader: CheckpointReader, template) -> Any:
    """Streaming disk→device restore: ``restore_to_template`` semantics with
    read→decode→host-to-device stages pipelined.

    Every leaf's read/decode job is submitted to the scheduler's RESTORE
    lane up front (tiny leaves batched, int8 payloads first); the main thread
    consumes completions and issues the ``non_blocking`` H2D copy from a
    pinned staging buffer as each lands. int8 payloads cross at stored (1/4)
    width and widen on the device (``kernels.quantize.dequantize_int8_many``).
    Leaves saved as several pieces assemble on the host (``read_slice``)
    first. Bit-identical to ``restore_to_template``.

    A sharded template leaf (``"sharded"`` plan) decodes only this rank's
    region (``addressable_shard_spans``; ``CheckpointReader
    .read_region_payload`` decodes only the chunks it touches), copies it to
    the device, widens an int8 region there with the record's tensor-global
    scale, and becomes a ``DTensor``. No rank returns before every rank has
    materialized its shards (``multihost.sync_global_devices``).
    """
    from ..kernels.quantize import dequantize_int8_many

    named = ser.flatten_state(template)
    _check_template(reader, named)
    ex = chunkstore.restore_executor()

    plans: dict[str, str] = {}
    regions: dict[str, Future] = {}
    for name, leaf in named.items():
        dev = _leaf_device(leaf)
        rec = reader.single_piece_record(name)
        if _leaf_sharding(leaf) is not None:
            plans[name] = "sharded"
            continue
        if dev is None or dev.type != "cuda" or rec is None:
            plans[name] = "host" if dev is None else "assembled"
            continue
        quant, _ = ser.split_codec(rec.get("codec", "raw"))
        plans[name] = ("quantized" if quant == "int8"
                       and ser.dtype_to_name(leaf.dtype) in ("float32", "bfloat16", "float16")
                       and leaf.dtype == ser.torch_dtype(rec["dtype"])
                       else "payload")

    def _run_one(name: str):
        if plans[name] in ("host", "assembled"):
            return reader.read_slice(name, None, parallel=False)
        return reader.read_payload(name, parallel=False)

    order = sorted((n for n in named if plans[n] != "sharded"),
                   key=lambda n: plans[n] != "quantized")
    resolve, futs = _submit_leaf_jobs(ex, order, reader.stored_nbytes, _run_one)
    for name, leaf in named.items():
        if plans[name] == "sharded":
            # per-shard enqueue: a decode job for this rank's region only
            regions[name] = ex.submit(reader.read_region_payload, name,
                                      _region(_leaf_sharding(leaf), leaf))
            futs.append(regions[name])
    out = {}
    try:
        qnames = [n for n in order if plans[n] == "quantized"]
        if qnames:
            q_devs, q_scales, q_dtypes = [], [], []
            for name in qnames:
                payload, _dtype_name, _quant, scale = resolve[name]()
                q_devs.append(_tensor_from_payload(
                    payload, "int8", _leaf_device(named[name])))
                q_scales.append(scale)
                q_dtypes.append(named[name].dtype)
            for name, t in zip(qnames, dequantize_int8_many(
                    q_devs, q_scales, q_dtypes)):
                out[name] = t
        for name, fut in regions.items():
            leaf = named[name]
            out[name] = shd.from_local(_region_tensor(leaf, *fut.result()),
                                       _leaf_sharding(leaf), tuple(leaf.shape))
        for name in order:
            plan, leaf = plans[name], named[name]
            if plan == "quantized":
                continue
            if plan == "host":
                out[name] = _host_leaf_value(leaf, resolve[name](),
                                             reader.dtype_name(name))
                continue
            if plan == "payload":
                payload, dtype_name, quant, scale = resolve[name]()
                if quant:
                    payload = ser.finish_payload(payload, dtype_name=dtype_name,
                                                 quant=quant, scale=scale)
            else:
                payload, dtype_name = resolve[name](), reader.dtype_name(name)
            out[name] = _to_template_dtype(_tensor_from_payload(
                payload, dtype_name, _leaf_device(leaf)), leaf)
    except BaseException:
        for f in futs:
            f.cancel()
        futures_wait(futs)
        raise
    if any(isinstance(t, torch.Tensor) and _local(t).device.type == "cuda"
           for t in out.values()):
        torch.cuda.synchronize()        # the restore ends with its transfers
    # pod rendezvous: no participant takes its first post-restore step until
    # every participant has materialized its shards; a lone process with no
    # barrier installed passes straight through
    multihost.sync_global_devices("spoton:restore_streaming")
    return ser.unflatten_like(template, out)
