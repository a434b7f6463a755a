"""Checkpoint extraction, writing and restore for single-device state.

Save path, two phases (so the trainer only blocks on the cheap one):

  1. ``extract_snapshot(state)`` — device→host copy of every tensor leaf,
     the transparent-checkpoint "freeze" moment. The copies are pipelined:
     ``non_blocking`` copies into pinned host memory are issued across *all*
     leaves first (``prestage`` may already have issued them), then one
     gather pass waits on their events. With ``on_device_quantize``, selected
     leaves (optimizer moments before an urgent save) are absmax-int8
     quantized *on the device* first (the CUDA quantize kernels), so they
     cross the link at 1/4 width; the stored bytes equal a host quantize.
  2. ``write_snapshot(dir, snapshot)`` / ``write_snapshot_delta`` — encode +
     write, in the async writer thread.

Restore: tensors decode in parallel on the codec scheduler's RESTORE lane
into preallocated destination buffers (``CheckpointReader``).
``restore_to_template_streaming`` pipelines decode with the host→device
transfers: each payload is copied into a pinned staging buffer (never a
read-only mmap view handed to torch) and sent ``non_blocking``; int8
payloads cross at 1/4 width and widen on the device through the dequantize
kernel.

The manifest stores global shapes and per-piece global indices, so a
checkpoint the reference package wrote on a multi-device mesh restores here
through ``read_slice`` assembly. This port runs one device; its saves are
one whole-tensor piece per leaf.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import Future
from concurrent.futures import wait as futures_wait
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np
import torch

from . import chunkstore
from . import manifest as mf
from . import serialize as ser
from .device_delta import DeltaBlocks, DeviceDeltaTracker, write_delta_blocks_piece
from .hostcopy import HostCopy
from .ioutil import fsync_dir

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
    # invoked by the store with the final manifest records once this
    # snapshot's checkpoint is durably committed (device-delta bookkeeping)
    on_committed: Callable[[list[dict]], None] | None = None


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
    for name, leaf in ser.flatten_state(state).items():
        if (not isinstance(leaf, torch.Tensor) or leaf.device.type != "cuda"
                or (skip is not None and skip(name))):
            continue
        if tracker is not None and tracker.prestage_leaf(name, leaf):
            continue
        if name not in copies:
            copies[name] = HostCopy(leaf)
    return Prestaged(state, copies)


def _is_py_scalar(leaf) -> bool:
    return isinstance(leaf, (int, float, bool)) and not isinstance(leaf, np.generic)


def extract_snapshot(state, *, step: int, mesh_info: dict | None = None,
                     on_device_quantize: Callable[[str], bool] | None = None,
                     tracker: DeviceDeltaTracker | None = None,
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
    """
    t_stall0 = time.perf_counter()
    state, copies = _unwrap(state)
    named = ser.flatten_state(state)
    leaf_order = list(named)
    tracked: dict[str, Any] = {}
    commit_cb = None
    if tracker is not None and on_device_quantize is None:
        tracked, commit_cb = tracker.begin(named)
    prequant: dict[str, tuple[HostCopy, float]] = {}   # name -> (q copy, scale)
    if on_device_quantize is not None:
        from ..kernels.quantize import quantize_int8
        for name, leaf in named.items():
            if (isinstance(leaf, torch.Tensor) and leaf.ndim >= 1
                    and leaf.dtype.is_floating_point
                    and on_device_quantize(name)):
                q, scale = quantize_int8(leaf.detach())
                prequant[name] = (HostCopy(q), scale)
    staged: dict[str, HostCopy] = {}
    for name, leaf in named.items():                # phase 1: async staging
        if name in tracked:
            tracked[name].resolve()     # diff sync + dirty-block gather
            continue
        if name in prequant or not isinstance(leaf, torch.Tensor):
            continue
        cp = copies.get(name)
        staged[name] = cp if cp is not None and cp.src is leaf else HostCopy(leaf)
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
        nbytes += arr.nbytes
        d2h_bytes += arr.nbytes
        leaves[name] = lp
    return Snapshot(step=step, leaves=leaves, leaf_order=leaf_order,
                    treedef_repr=ser.structure_repr(state),
                    mesh=mesh_info or {}, nbytes=nbytes, d2h_bytes=d2h_bytes,
                    d2h_skipped=d2h_skipped,
                    stall_s=time.perf_counter() - t_stall0,
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
        for pi, (index, arr) in enumerate(lp.pieces):
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
                        prequant_scale=None, dirty_dirs=None, dtype_name=None):
    """Worker-pool task: quantize one piece, chunk it into the pool."""
    codec = ser.resolve_codec(codec)
    quant, comp = ser.split_codec(codec)
    if prequant_scale is not None:
        raw, scale = np.ascontiguousarray(arr), prequant_scale
    else:
        raw, scale = ser.quantize(arr, quant, dtype_name)
    nbytes = raw.nbytes
    refs, written = chunkstore.store_payload_chunks(
        pool, key, ser.array_bytes_view(raw), codec=codec, comp=comp,
        chunk_size=chunk_size, index=index, pin=pin, dirty_dirs=dirty_dirs)
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
) -> tuple[list[dict], int]:
    """Incremental write: every piece chunked into the shared pool.

    Returns (manifest tensor records, bytes physically written). Every chunk
    a manifest references is durable before this returns (per-save
    dir-fsync barrier for a POSIX pool; a backend pool's ``flush_uploads``
    barrier runs in the store).
    """
    ex = executor if executor is not None else chunkstore.codec_executor()
    jobs = []
    dirty_dirs: set[str] = set()    # fan-out dirs with new chunks this save
    for name, lp in snapshot.leaves.items():
        for pi, (idx, arr) in enumerate(lp.pieces):
            if isinstance(arr, DeltaBlocks):
                fut = ex.submit(write_delta_blocks_piece, pool, (name, pi),
                                arr, index, pin, dirty_dirs)
                jobs.append((name, pi, idx, lp, arr, fut))
                continue
            arr = np.asarray(arr)
            codec = _piece_codec(name, lp, arr, compress=compress,
                                 quantize_moments=quantize_moments)
            fut = ex.submit(_delta_encode_piece, pool, (name, pi), arr, codec,
                            chunk_size, index, pin,
                            lp.scale if lp.prequant else None, dirty_dirs,
                            lp.dtype)
            jobs.append((name, pi, idx, lp, arr, fut))
    try:
        results = [fut.result() for *_rest, fut in jobs]
    except BaseException:
        # quiesce before propagating: a straggler task must not call pin()
        # after the caller has already unpinned this save's chunks
        for *_rest, fut in jobs:
            fut.cancel()
        futures_wait([fut for *_rest, fut in jobs])
        raise
    if dirty_dirs:
        sync_futs = [ex.submit(fsync_dir, d) for d in dirty_dirs]
        futures_wait(sync_futs)
        for sf in sync_futs:
            sf.result()
    records = []
    new_bytes = 0
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
    should land (the port's ``jax.ShapeDtypeStruct`` with a sharding)."""

    shape: tuple[int, ...]
    dtype: torch.dtype
    device: torch.device


def _leaf_device(leaf) -> torch.device | None:
    """Target device of a template leaf; None for host (numpy/scalar)."""
    if isinstance(leaf, (torch.Tensor, TensorSpec)):
        return torch.device(leaf.device)
    return None


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
    Every leaf decodes in parallel on the host (``read_many``) and int8
    payloads dequantize on the host; see ``restore_to_template_streaming``
    for the pipelined restore that widens on the device.
    """
    named = ser.flatten_state(template)
    _check_template(reader, named)
    host = reader.read_many(list(named))
    out = {}
    for name, leaf in named.items():
        dev = _leaf_device(leaf)
        if dev is None:
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
    """
    from ..kernels.quantize import dequantize_int8_many

    named = ser.flatten_state(template)
    _check_template(reader, named)
    ex = chunkstore.restore_executor()

    plans: dict[str, str] = {}
    for name, leaf in named.items():
        dev = _leaf_device(leaf)
        rec = reader.single_piece_record(name)
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

    order = sorted(named, key=lambda n: plans[n] != "quantized")
    resolve, futs = _submit_leaf_jobs(ex, order, reader.stored_nbytes, _run_one)
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
    if any(isinstance(t, torch.Tensor) and t.device.type == "cuda"
           for t in out.values()):
        torch.cuda.synchronize()        # the restore ends with its transfers
    return ser.unflatten_like(template, out)
