"""Device-resident delta detection — the save path's change detector.

The tracker moves the "which chunks changed" decision onto the device:

* after each committed save it keeps, per tensor, the per-block fingerprint
  array (``kernels.fingerprint``, ``int32`` holding uint32 bits — few CUDA
  ops take ``torch.uint32``) **on the device**, plus the pool ``ChunkRef``
  of every block from that save's manifest;
* the next save recomputes fingerprints on the device and compares them
  against the previous save's in the same kernel launch (only the small bool
  vector crosses the link), gathers **only the dirty blocks** into one fresh
  device buffer (``index_select``) and copies that to pinned host memory;
* clean blocks reuse the previous save's chunk refs — they skip the D2H
  copy, the host sha1 *and* the encode. Dirty blocks still get the pool's
  sha1 content address, so pool, manifests, gc and restore are untouched.

Fingerprint vs content address: the device digest (32 bits/block) decides
what to *skip*; the host sha1 remains the *addressing* and integrity scheme
for every byte that lands in the pool. Shape/dtype/codec/chunk-size identity
checks keep systematic aliasing cases on the full path.

Consistency contract: a block is skipped **only** against refs recorded from
this process's last *committed* save (the commit callback fires after the
COMMITTED marker lands). Urgent (termination) saves bypass the tracker.

Copies to the host ride the training stream (``hostcopy.HostCopy``): pinned
destination, ``non_blocking`` copy, CUDA event; ``finish`` waits on the
event before any host byte is hashed. The gathered blocks are a fresh
buffer, so a train step that replaces the state can never alias them.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate

from ..kernels.fingerprint import (fingerprint_blocks, fingerprint_diff,
                                   n_blocks_of, supported_dtype)
from . import chunkstore
from . import codec_sched
from . import serialize as ser
from .hostcopy import HostCopy
from .ioutil import array_bytes_view

# leaves below this size take the dense path: the fingerprint launch +
# bookkeeping costs more than just copying them
MIN_FINGERPRINT_BYTES = 1 << 16


def _local(leaf):
    """The tensor a tracked leaf's fingerprints cover: a replicated
    ``DTensor``'s local tensor."""
    return leaf.to_local() if isinstance(leaf, DTensor) else leaf


@dataclass
class DeltaBlocks:
    """Sparse payload of one tensor piece: dirty blocks on host, clean
    blocks as pool refs from the last committed save."""

    shape: tuple[int, ...]
    dtype_name: str            # payload dtype (tracked pieces never quantize)
    nbytes: int                # full raw payload bytes
    chunk_size: int
    n_blocks: int
    codec: str                 # resolved, compression-only codec
    dirty_ids: tuple[int, ...]
    dirty_data: np.ndarray | None   # (k, elems_per_block), storage dtype
    clean_refs: dict[int, chunkstore.ChunkRef] = field(default_factory=dict)

    def dirty_bytes(self) -> int:
        return sum(min(self.chunk_size, self.nbytes - ci * self.chunk_size)
                   for ci in self.dirty_ids)

    def dirty_view(self, j: int, ci: int) -> memoryview:
        """Raw-byte window of the j-th dirty row (block ``ci``), trimmed to
        the block's valid length (the last block may be partial)."""
        valid = min(self.chunk_size, self.nbytes - ci * self.chunk_size)
        return array_bytes_view(self.dirty_data[j])[:valid]


def stable_piece_key(name: str, index, global_shape,
                     dtype_name: str) -> tuple[str, int]:
    """Rescale-stable tracker key for one tensor piece: (leaf name, global
    flat byte offset of the piece's first element)."""
    itemsize = ser.name_to_dtype(dtype_name).itemsize
    off_elems = 0
    stride = 1
    for (lo, _hi), dim in zip(reversed(tuple(index or ())),
                              reversed(tuple(global_shape or ()))):
        off_elems += int(lo) * stride
        stride *= int(dim)
    return name, off_elems * itemsize


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass
class _Entry:
    """Per-piece state from the last committed save."""

    fp: Any                    # device int32[n_blocks]
    refs: list[chunkstore.ChunkRef]
    codec: str
    shape: tuple[int, ...]
    dtype_name: str
    chunk_size: int
    verified_at: float         # monotonic ts of last pool check/touch
    span: tuple[int, int] = (0, 0)
    total_nbytes: int = 0


@dataclass
class _Pending:
    """Fingerprint work issued at prestage, consumed by extract."""

    leaf: Any                  # the tensor the digests were computed over
    fp: Any                    # device int32[n_blocks]
    diff: HostCopy | None      # bool[n_blocks] in flight (when an entry existed)
    # the exact entry the diff was computed against: an async commit may
    # replace the entry between prestage and extract, and a diff against the
    # old fingerprints must never be paired with the new refs
    ent: "_Entry | None" = None


def _gather_blocks(x: torch.Tensor, ids: np.ndarray, epb: int) -> torch.Tensor:
    """One device gather of the blocks ``ids`` (sorted; the last may be the
    zero-padded tail block): (k, epb) in x's dtype, a fresh buffer."""
    flat = x.detach().reshape(-1)
    n_full = flat.numel() // epb
    ids_t = torch.as_tensor(ids, dtype=torch.int64, device=x.device)
    n_tail = int((ids >= n_full).sum())
    full = flat[:n_full * epb].view(n_full, epb).index_select(
        0, ids_t[:len(ids) - n_tail])
    if not n_tail:
        return full
    tail = flat.new_zeros(epb)
    tail[:flat.numel() - n_full * epb] = flat[n_full * epb:]
    return torch.cat([full, tail.expand(n_tail, epb)])


class _Staged:
    """One leaf's in-flight delta extraction (diff launched on device)."""

    def __init__(self, tracker: "DeviceDeltaTracker", name: str, leaf,
                 ent: _Entry, fp_new, diff: HostCopy, codec: str):
        self.tracker = tracker
        self.name = name
        self.leaf = leaf
        self.ent = ent
        self.fp_new = fp_new
        self.diff = diff
        self.codec = codec
        self.dense = False         # high churn: gather wouldn't pay
        self.dense_copy: HostCopy | None = None
        self._gathered: HostCopy | None = None
        self._dirty: np.ndarray | None = None

    def resolve(self) -> None:
        """Sync the small diff vector, re-verify clean refs if due, and
        launch the device gather + async D2H for the dirty blocks.

        When most blocks are dirty the block gather cannot beat a plain
        full-leaf stage, so the leaf falls back to the dense path — the
        fingerprints are still committed, so the next low-churn save deltas
        normally."""
        diff = self.diff.numpy()
        dirty = set(np.nonzero(diff)[0].tolist())
        ent = self.ent
        if len(dirty) > self.tracker.dense_fallback_frac * len(ent.refs):
            self.dense = True
            self.dense_copy = HostCopy(self.leaf, staged=True)
            return
        now = time.monotonic()
        if now - ent.verified_at > self.tracker.touch_interval_s:
            # periodic liveness pass over the clean refs — while the device
            # data is still here, so a swept chunk just turns dirty; batched
            # on the RESTORE lane because the trainer is stalled on it
            pool = self.tracker.pool
            refs = ent.refs

            def _verify(ids):
                return [ci for ci in ids
                        if not (pool.check(refs[ci].hash, refs[ci].nbytes)
                                and pool.touch(refs[ci].hash))]

            clean = [ci for ci in range(len(refs)) if ci not in dirty]
            batch = 512
            if len(clean) <= batch:
                dirty.update(_verify(clean))
            else:
                ex = chunkstore.restore_executor()
                for fut in [ex.submit(_verify, clean[i:i + batch])
                            for i in range(0, len(clean), batch)]:
                    dirty.update(fut.result())
            ent.verified_at = now
        self._dirty = np.asarray(sorted(dirty), dtype=np.int64)
        if self._dirty.size:
            epb = ent.chunk_size // self.leaf.element_size()
            # the id vector is padded to a power-of-two bucket, as the
            # reference does (its gather recompiles per id-vector shape);
            # the padded rows are counted in d2h_bytes like the reference's
            k = self._dirty.size
            k_pad = min(1 << (k - 1).bit_length() if k > 1 else 1,
                        len(ent.refs))
            ids = np.pad(self._dirty, (0, k_pad - k), mode="edge")
            self._gathered = HostCopy(_gather_blocks(self.leaf, ids, epb))

    def finish(self) -> tuple[DeltaBlocks, int, int] | None:
        """Materialize: returns (piece payload, d2h bytes, skipped bytes),
        or None when ``resolve`` chose the dense fallback."""
        if self.dense:
            return None
        ent = self.ent
        data = None
        moved = 0
        if self._gathered is not None:
            rows = self._gathered.numpy()
            moved = rows.nbytes
            data = rows[:self._dirty.size]
        dirty_ids = tuple(int(i) for i in self._dirty)
        nbytes = int(np.prod(ent.shape)) * ser.name_to_dtype(ent.dtype_name).itemsize
        dirty_set = set(dirty_ids)
        db = DeltaBlocks(
            shape=ent.shape, dtype_name=ent.dtype_name, nbytes=nbytes,
            chunk_size=ent.chunk_size, n_blocks=len(ent.refs),
            codec=self.codec, dirty_ids=dirty_ids, dirty_data=data,
            clean_refs={ci: ent.refs[ci] for ci in range(len(ent.refs))
                        if ci not in dirty_set})
        self.tracker.stats["blocks_transferred"] += len(dirty_ids)
        self.tracker.stats["blocks_skipped"] += len(ent.refs) - len(dirty_ids)
        # link accounting: the bucket-padded gather rows crossed too, plus
        # the diff bool vector
        d2h = moved + len(ent.refs)
        return db, d2h, nbytes - db.dirty_bytes()


class DeviceDeltaTracker:
    """Owns the device-resident fingerprints and clean-block refs across
    saves. One tracker per (store, training process); thread-safe — the
    async writer commits on its own thread while the trainer stages the
    next save."""

    def __init__(self, pool: chunkstore.ChunkPool, *, chunk_size: int,
                 compress: bool = True, quantize_moments: bool = False,
                 min_bytes: int = MIN_FINGERPRINT_BYTES,
                 touch_interval_s: float = 30.0,
                 dense_fallback_frac: float = 0.5):
        self.pool = pool
        self.chunk_size = int(chunk_size)
        self.compress = compress
        self.quantize_moments = quantize_moments
        self.min_bytes = min_bytes
        self.touch_interval_s = touch_interval_s
        self.dense_fallback_frac = dense_fallback_frac
        self._lock = threading.Lock()
        self._entries: dict[tuple[str, int], _Entry] = {}
        self._pending: dict[str, _Pending] = {}
        self.stats = {"tracked_saves": 0, "blocks_skipped": 0,
                      "blocks_transferred": 0, "fallbacks": 0,
                      "rescale_events": 0, "fp_kept": 0, "fp_dropped": 0}

    # -- eligibility --------------------------------------------------------

    def _codec_for(self, name: str, leaf) -> str | None:
        """Resolved codec when ``leaf`` can take the fingerprint path, else
        None (dense). Tracked leaves are tensors with a fingerprintable dtype
        and a quantization-free codec — the int8 absmax scale is
        tensor-global, so quantized payloads re-encode wholesale whenever
        anything changed and block deltas buy nothing. A ``DTensor`` is
        tracked only when fully replicated, on its local tensor; a sharded
        one goes dense."""
        if self.chunk_size % 4:
            return None
        if isinstance(leaf, DTensor):
            if not all(isinstance(p, Replicate) for p in leaf.placements):
                return None
            leaf = leaf.to_local()
        if not isinstance(leaf, torch.Tensor) or leaf.ndim < 1:
            return None
        if not supported_dtype(leaf.dtype) or _nbytes(leaf) < self.min_bytes:
            return None
        codec = ser.resolve_codec(ser.codec_for_meta(
            name, leaf.dtype, _nbytes(leaf), ndim=leaf.ndim,
            compress=self.compress, quantize_moments=self.quantize_moments))
        quant, _comp = ser.split_codec(codec)
        return None if quant else codec

    # -- prestage (trainer supplier) ---------------------------------------

    def prestage_leaf(self, name: str, leaf) -> bool:
        """Launch the fingerprint + diff for one leaf at checkpoint-decision
        time. Returns False when the leaf is not fingerprint-eligible."""
        codec = self._codec_for(name, leaf)
        if codec is None:
            return False
        with self._lock:
            ent = self._entries.get((name, 0))
        # the launch runs outside the tracker lock: the lock serializes the
        # async writer's commit bookkeeping, and begin()'s `pend.ent is ent`
        # guard discards a diff whose entry a commit swapped in between
        diff = None
        local = _local(leaf)
        if ent is not None and self._usable(ent, local, codec):
            fp, d = fingerprint_diff(local, ent.fp, block_bytes=self.chunk_size)
            diff = HostCopy(d)
        else:
            fp, ent = fingerprint_blocks(local, block_bytes=self.chunk_size), None
        with self._lock:
            self._pending[name] = _Pending(leaf=leaf, fp=fp, diff=diff, ent=ent)
        return True

    def _usable(self, ent: _Entry, leaf, codec: str) -> bool:
        """The previous save's entry may only suppress transfers when every
        identity the digest does NOT cover matches."""
        return (ent.shape == tuple(leaf.shape)
                and ent.dtype_name == ser.dtype_to_name(leaf.dtype)
                and ent.chunk_size == self.chunk_size
                and ent.codec == codec
                and len(ent.refs) == n_blocks_of(_nbytes(leaf), self.chunk_size))

    # -- extract ------------------------------------------------------------

    def begin(self, named: dict[str, Any]) -> tuple[
            dict[str, _Staged], Callable[[list[dict]], None]]:
        """Start one save's delta extraction over the flattened state.

        Returns (staged, on_committed): ``staged`` maps leaf name to its
        in-flight dirty-block extraction (only leaves with a usable previous
        entry); ``on_committed`` must be invoked with the final manifest
        records after the checkpoint commits, and installs the new
        fingerprints + refs as the comparison point for the next save.
        """
        staged: dict[str, _Staged] = {}
        new_fps: dict[str, tuple[Any, str]] = {}   # name -> (fp_dev, codec)
        plan: list[tuple] = []
        with self._lock:
            for name, leaf in named.items():
                codec = self._codec_for(name, leaf)
                if codec is None:
                    continue
                pend = self._pending.pop(name, None)
                ent = self._entries.get((name, 0))
                plan.append((name, leaf, codec, ent, pend))
            self._pending.clear()                  # saves never interleave
        fallbacks = 0
        for name, held, codec, ent, pend in plan:
            leaf = _local(held)
            usable = ent is not None and self._usable(ent, leaf, codec)
            diff = None
            if pend is not None and pend.leaf is held:
                fp = pend.fp
                if pend.ent is ent:
                    diff = pend.diff
            elif usable:
                fp, d = fingerprint_diff(leaf, ent.fp, block_bytes=self.chunk_size)
                diff = HostCopy(d)
            else:
                fp = fingerprint_blocks(leaf, block_bytes=self.chunk_size)
            new_fps[name] = (fp, codec)
            if not usable:
                if ent is not None:
                    fallbacks += 1
                continue                           # dense path this save
            if diff is None:
                diff = HostCopy(fp != ent.fp)
            staged[name] = _Staged(self, name, leaf, ent, fp, diff, codec)
        with self._lock:
            self.stats["fallbacks"] += fallbacks
            if staged:
                self.stats["tracked_saves"] += 1
        return staged, self._make_commit_cb(new_fps)

    # -- commit -------------------------------------------------------------

    def _make_commit_cb(self, new_fps: dict[str, tuple[Any, str]]):
        def on_committed(records: list[dict]) -> None:
            by_name = {rec["name"]: rec for rec in records}
            with self._lock:
                for name, (fp, codec) in new_fps.items():
                    rec = by_name.get(f"{name}#0")
                    if rec is None or "chunks" not in rec:
                        continue
                    if rec.get("codec", "raw") != codec:
                        continue                   # policy changed mid-save
                    refs = [chunkstore.ChunkRef.from_json(c)
                            for c in rec["chunks"]]
                    if len(refs) != fp.numel():
                        continue
                    itemsize = ser.name_to_dtype(rec["dtype"]).itemsize
                    nbytes = int(np.prod(rec["shape"])) * itemsize
                    key = stable_piece_key(name, rec["index"],
                                           rec["global_shape"], rec["dtype"])
                    self._entries[key] = _Entry(
                        fp=fp, refs=refs, codec=codec,
                        shape=tuple(rec["shape"]), dtype_name=rec["dtype"],
                        chunk_size=self.chunk_size,
                        verified_at=time.monotonic(),
                        span=(key[1], nbytes),
                        total_nbytes=(int(np.prod(rec["global_shape"]))
                                      * itemsize))
        return on_committed

    # -- topology changes ---------------------------------------------------

    def rescale(self, addressable: Callable[[str, int, int, int], bool]
                | None = None) -> dict[str, int]:
        """Remap tracker state across a topology change: entries whose
        global byte span this process no longer owns are dropped, the rest
        keep their fingerprints. In-flight prestage work is discarded."""
        with self._lock:
            self._pending.clear()
            snapshot = [(key, ent.span, ent.total_nbytes)
                        for key, ent in self._entries.items()]
        # the predicate is caller code — never run it under the tracker lock
        drop = [key for key, (lo, ln), total in snapshot
                if addressable is not None
                and not addressable(key[0], lo, lo + ln, total)]
        with self._lock:
            dropped = 0
            for key in drop:
                if self._entries.pop(key, None) is not None:
                    dropped += 1
            kept = len(self._entries)
            self.stats["rescale_events"] += 1
            self.stats["fp_kept"] += kept
            self.stats["fp_dropped"] += dropped
        return {"kept": kept, "dropped": dropped}

    def invalidate(self) -> None:
        """Drop all device state; the next save takes the full path."""
        with self._lock:
            self._entries.clear()
            self._pending.clear()


def write_delta_blocks_piece(pool: chunkstore.ChunkPool, key: tuple,
                             db: DeltaBlocks,
                             index: chunkstore.DeltaIndex | None,
                             pin: Callable[[str], None],
                             dirty_dirs: set | None):
    """Write-path worker for a sparse piece: encode+store the dirty blocks,
    reuse the clean refs verbatim (pinned so gc keeps them until the
    manifest commits)."""
    _quant, comp = ser.split_codec(db.codec)
    dirty_pos = {ci: j for j, ci in enumerate(db.dirty_ids)}
    refs: list[chunkstore.ChunkRef] = []
    written = 0
    for ci in range(db.n_blocks):
        j = dirty_pos.get(ci)
        if j is None:
            ref = db.clean_refs[ci]
            pin(ref.hash)
            refs.append(ref)
            continue
        # periodic-save encode: hand the worker to queued restore/urgent
        # jobs between blocks (chunk-granular preemption), and hold while
        # an urgent save writes
        codec_sched.maybe_yield()
        chunkstore.wait_out_urgent()
        ref, n, rd = chunkstore.store_chunk(
            pool, db.dirty_view(j, ci), comp=comp, pin=pin,
            dirty_dirs=dirty_dirs)
        if index is not None:
            index.put((key, ci), rd, db.codec, ref)
        written += n
        refs.append(ref)
    return db.codec, None, refs, written, db.nbytes
