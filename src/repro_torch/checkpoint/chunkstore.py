"""Content-addressed chunk pool — the substrate of incremental checkpoints.

Every tensor payload is split into fixed-size chunks; each chunk is stored
once in a pool shared by all checkpoints under the store root::

    <root>/chunks/<hh>/<hash>      # hh = first two hex chars (fan-out)

The address is a 160-bit content digest of the *stored* (post-quantize,
post-compress) bytes, so a pool file's content always equals its name's
preimage — self-verifying, and idempotent under concurrent writers: two
fleet members encoding the same state produce byte-identical chunks and race
benignly on an ``os.replace`` of identical content. The digest is SHA-1
(hardware-accelerated and GIL-releasing — measured 3-4x the throughput of
the blake2b it replaced, and digesting every chunk is the warm-save floor);
adversarial collisions are not in the threat model, the hash guards against
accidental aliasing exactly as git's object store does. Chunks addressed by
the old blake2b scheme stay readable — a manifest stores the address with
each reference, readers never recompute it — they just no longer dedup
against new saves.

Chunking itself is zero-copy: ``iter_chunks`` yields ``memoryview`` windows
over the staged tensor buffer, and hashing/compression/crc/file-writes all
consume the windows directly — no ``.tobytes()`` materialization, no sliced
``bytes`` per chunk.

Delta saves fall out of content addressing: a chunk whose bytes did not
change since the last committed step already exists in the pool, so ``write``
degenerates to an mtime touch and the save writes only dirty chunks. The
``DeltaIndex`` memo makes the common case cheap — it remembers the raw-bytes
digest of each (leaf, piece, chunk) position from the previous save, so an
unchanged chunk skips the compressor as well, not just the disk write. A memo
hit is trusted only after ``touch`` confirms the pool file still exists (the
chunk may have been swept since), so the memo can never dangle.

Sweeping the pool is refcount-aware by construction: the store's gc unions
the chunk references of every committed manifest (plus in-process pins for
saves in flight) and removes only unreferenced files older than an age gate —
the same staleness discipline the staging-dir sweep uses for writers on other
hosts of the shared volume. ``touch`` on reuse keeps a chunk's mtime fresh
while any writer still depends on it.

Compression runs per chunk on a process-wide worker pool (zlib/zstd and
blake2b release the GIL), so encode overlaps across tensors instead of
running single-threaded. The pool is the priority scheduler in
``codec_sched``: encode/decode jobs carry a lane (URGENT save > RESTORE >
PERIODIC save), restore jobs jump queued periodic encodes, and the chunk
loop below yields between chunks so an in-flight periodic save hands its
worker to a restore instead of holding it for a whole piece.
"""

from __future__ import annotations

import hashlib
import os
import threading
import uuid
import zlib
from concurrent.futures import wait as futures_wait
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np

from . import codec_sched
from . import serialize as ser
from ..faults import inject as faults
from .codec_sched import CodecLane
from .ioutil import array_bytes_view, fsync_dir, mmap_view, release_view


def _retry():
    # Deferred: repro_torch.core's package __init__ imports the coordinator, which
    # imports repro_torch.checkpoint — a module-level import here would observe
    # either package half-initialized depending on which is imported first.
    from ..core import retry
    return retry

CHUNKS_DIRNAME = "chunks"
DEFAULT_CHUNK_SIZE = 1 << 20          # 1 MiB: dedup granularity vs. ref count


def codec_executor() -> CodecLane:
    """PERIODIC lane of the process-wide codec scheduler — background
    encode/compress work, preemptible between chunks."""
    return codec_sched.lane(codec_sched.PERIODIC)


def restore_executor() -> CodecLane:
    """RESTORE lane: decode/read jobs inside the MTTR window. These jump
    every queued periodic encode and are helped inline by yielding periodic
    workers, so restore throughput no longer collapses when a concurrent
    writer is saving into the same pool."""
    return codec_sched.lane(codec_sched.RESTORE)


def urgent_executor() -> CodecLane:
    """URGENT lane for termination checkpoints: an urgent save's encode jobs
    preempt everything queued — the eviction-notice window pays for every
    queued task. This used to be a second reserved ThreadPoolExecutor; as a
    lane of the single pool it no longer competes with the shared workers
    for the same physical cores."""
    return codec_sched.lane(codec_sched.URGENT)


def chunk_digest(data) -> str:
    """160-bit content address of a bytes-like chunk (see module docstring
    for the SHA-1 choice). Same hex width as the former blake2b-160, so the
    pool's on-disk fan-out layout is unchanged."""
    return hashlib.sha1(data).hexdigest()


def chunk_content_ok(ref: "ChunkRef", data, pool: "ChunkPool | None" = None
                     ) -> bool:
    """Integrity check of a chunk's stored bytes on the restore hot path.

    The sha1 content address doubles as the checksum — it already covers
    exactly the stored bytes, it is the stronger guarantee, and with SHA
    extensions it digests measurably faster than ``zlib.crc32`` (restore
    validation is a per-byte cost inside the MTTR window). Chunks written
    under the legacy blake2b addressing don't re-digest to their name, so
    they fall back to the recorded crc32 — and the first such hit flips the
    pool to crc-first validation, so a legacy pool pays the double digest
    once, not per chunk. (Every ref records a crc32, so crc alone is a
    complete check; sha1-first is the speed choice for modern pools.)
    """
    if pool is not None and pool.legacy_validate:
        return zlib.crc32(data) == ref.crc32
    if chunk_digest(data) == ref.hash:
        return True
    if zlib.crc32(data) == ref.crc32:
        if pool is not None:
            pool.legacy_validate = True
        return True
    return False


@dataclass(frozen=True)
class ChunkRef:
    """One chunk reference inside a manifest-v2 tensor record."""

    hash: str
    nbytes: int        # stored (encoded) length
    raw_len: int       # pre-compression length
    crc32: int         # of the stored bytes (fast validation)
    comp: str          # "raw" | "zlib" | "zstd" — how to decode

    def to_json(self) -> dict:
        return {"h": self.hash, "n": self.nbytes, "r": self.raw_len,
                "c": self.crc32, "k": self.comp}

    @staticmethod
    def from_json(d: dict) -> "ChunkRef":
        return ChunkRef(hash=d["h"], nbytes=d["n"], raw_len=d["r"],
                        crc32=d["c"], comp=d["k"])


class ChunkPool:
    #: True when this pool's directory tree IS the durable copy, so the
    #: save must fsync dirty fan-out dirs before its manifest commits.
    #: Cache-tier pools (``backend.BackendChunkPool``) flip this off — their
    #: durability bar is "every ref uploaded", not local rename durability.
    durable_dirs = True

    def __init__(self, root: str):
        self.root = root
        # flips True on the first blake2b-era chunk seen (sha1 re-digest
        # can't match its name): validation drops to crc-first so legacy
        # pools don't pay two digest passes per chunk on restore
        self.legacy_validate = False

    def path(self, h: str) -> str:
        return os.path.join(self.root, h[:2], h)

    def chunk_path(self, ref: ChunkRef) -> str:
        """Resolve the file holding ``ref``'s stored bytes. The base pool
        answers with its own content-addressed entry; overlay pools (the
        peer-exchange read-through pool, modeled cold-storage pools in the
        benchmarks) override this single hook to redirect *where bytes come
        from* while the decode/validation path stays untouched — content
        addressing makes any source interchangeable once the digest checks.
        """
        return self.path(ref.hash)

    def touch(self, h: str) -> bool:
        """Refresh mtime (protects the chunk from age-gated sweeps by other
        writers); False if the chunk is not in the pool."""
        try:
            os.utime(self.path(h))
            return True
        except OSError:
            return False

    def check(self, h: str, nbytes: int) -> bool:
        """Cheap dedup-reuse guard: the pooled file exists with the expected
        stored size (one stat — no content read on the hot path)."""
        try:
            return os.path.getsize(self.path(h)) == nbytes
        except OSError:
            return False

    def write(self, h: str, data, *, sync_dir: bool = True) -> int:
        """Idempotent put; returns bytes physically written (0 on dedup hit).

        A dedup hit is size-verified: an existing file with the wrong length
        (truncated by a crashed writer, damaged in place) is overwritten
        rather than reused, so a save never extends the blast radius of a
        bad pool entry it could have repaired for free. After the atomic
        rename the fan-out directory is fsynced: a chunk a manifest is about
        to reference must not be un-renamed by a crash. Callers writing many
        chunks pass ``sync_dir=False`` and sync the distinct dirty dirs once
        per save (see ``store_payload_chunks``) — the durability bar is only
        that every referenced chunk's rename is durable before the manifest
        commits, not one fsync per chunk."""
        path = self.path(h)
        if self.check(h, len(data)):
            self.touch(h)
            return 0
        dirpath = os.path.dirname(path)
        os.makedirs(dirpath, exist_ok=True)
        tmp = path + f".tmp-{uuid.uuid4().hex[:8]}"
        try:
            with open(tmp, "wb") as f:
                faults.write_bytes(f, data, op="chunk.write", path=tmp)
                f.flush()
                faults.fault_point("chunk.fsync", tmp)
                os.fsync(f.fileno())
            faults.fault_point("chunk.replace", path)
            os.replace(tmp, path)   # atomic: readers never see partial chunks
        except Exception:
            # Quarantine: a failed/short tmp must not survive to be mistaken
            # for progress — the retrying caller re-encodes from memory. A
            # SimulatedCrash is a BaseException and skips this on purpose:
            # a killed process leaves its debris for gc to reclaim.
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        faults.fault_point("chunk.replaced", path, rollback=(path, tmp))
        if sync_dir:
            fsync_dir(dirpath)      # durable: rename survives a crash
        return len(data)

    def read_view(self, ref: ChunkRef) -> memoryview:
        """crc-validated view of a chunk's stored bytes (mmap-backed when the
        platform allows — decode copies straight from the page cache).
        Release with ``ioutil.release_view`` when done."""
        path = self.chunk_path(ref)
        faults.fault_point("chunk.read", path)
        view = mmap_view(path)
        if not chunk_content_ok(ref, view, self):
            release_view(view)
            _heal_and_raise(path, ref, "content digest/crc mismatch")
        return view

    def read(self, ref: ChunkRef) -> bytes:
        view = self.read_view(ref)
        try:
            return bytes(view)
        finally:
            release_view(view)

    def entries(self) -> Iterator[tuple[str, str, bool]]:
        """One walk over the pool: yields (name, path, is_tmp). Tmp files are
        crashed mid-write leftovers — the gc sweeps them by age."""
        try:
            shards = os.listdir(self.root)
        except FileNotFoundError:
            return
        for hh in shards:
            sub = os.path.join(self.root, hh)
            try:
                names = os.listdir(sub)
            except (NotADirectoryError, FileNotFoundError):
                continue
            for name in names:
                yield name, os.path.join(sub, name), ".tmp-" in name

    def all_chunks(self) -> Iterator[tuple[str, str]]:
        """Yield (hash, path) for every committed pool entry."""
        for name, path, is_tmp in self.entries():
            if not is_tmp:
                yield name, path


@dataclass(frozen=True)
class _MemoEntry:
    raw_digest: str
    codec: str
    ref: ChunkRef


class DeltaIndex:
    """Per-store memo: last stored chunk per (leaf, piece, chunk) position.

    Purely an optimization — a miss (fresh process, other writer's step,
    swept chunk) just re-encodes; a stale hit is impossible because the key
    is the raw-content digest plus codec, and the pooled file is re-checked
    for existence on every reuse."""

    def __init__(self):
        self._map: dict[tuple, _MemoEntry] = {}
        self._lock = threading.Lock()

    def get(self, key: tuple) -> _MemoEntry | None:
        with self._lock:
            return self._map.get(key)

    def put(self, key: tuple, raw_digest: str, codec: str, ref: ChunkRef) -> None:
        with self._lock:
            self._map[key] = _MemoEntry(raw_digest, codec, ref)


def iter_chunks(raw, chunk_size: int) -> Iterator:
    """Fixed-size windows over a bytes-like payload. Slicing a memoryview
    yields zero-copy sub-views, so passing the staged array's buffer here
    never materializes per-chunk bytes."""
    for off in range(0, len(raw), chunk_size):
        yield raw[off:off + chunk_size]


def store_payload_chunks(
    pool: ChunkPool,
    key: tuple,
    raw,
    *,
    codec: str,
    comp: str,
    chunk_size: int = DEFAULT_CHUNK_SIZE,
    index: DeltaIndex | None = None,
    pin: Callable[[str], None] = lambda h: None,
    dirty_dirs: set | None = None,
) -> tuple[list[ChunkRef], int]:
    """Chunk one raw tensor payload (bytes-like) into the pool.

    Returns (refs, bytes_physically_written). ``pin`` is called with each
    referenced hash *before* the chunk is relied upon, so the store's gc can
    keep in-flight references alive until the manifest commits. When the
    caller passes ``dirty_dirs`` (a set, shared across a save's encode jobs;
    ``set.add`` is atomic under the GIL), per-chunk directory fsyncs are
    skipped and the dirty fan-out dirs are collected instead, so the save
    syncs each distinct dir once before its manifest commits.
    """
    if not isinstance(raw, (bytes, memoryview)):
        raw = memoryview(raw)
    refs: list[ChunkRef] = []
    written = 0
    for ci, raw_chunk in enumerate(iter_chunks(raw, chunk_size)):
        # preemption checkpoint: a periodic-save encode hands its worker to
        # any queued restore/urgent job here, bounding their queue delay to
        # one chunk's encode instead of one piece's
        codec_sched.maybe_yield()
        rd = chunk_digest(raw_chunk)
        memo = index.get((key, ci)) if index is not None else None
        if (memo is not None and memo.raw_digest == rd and memo.codec == codec
                and pool.check(memo.ref.hash, memo.ref.nbytes)):
            # still pooled at the expected size -> skip encode+write
            pin(memo.ref.hash)
            pool.touch(memo.ref.hash)
            refs.append(memo.ref)
            continue
        ref, n, _rd = store_chunk(pool, raw_chunk, comp=comp, pin=pin,
                                  dirty_dirs=dirty_dirs, raw_digest=rd)
        written += n
        if index is not None:
            index.put((key, ci), rd, codec, ref)
        refs.append(ref)
    return refs, written


def store_chunk(pool: ChunkPool, raw_chunk, *, comp: str,
                pin: Callable[[str], None] = lambda h: None,
                dirty_dirs: set | None = None,
                raw_digest: str | None = None) -> tuple[ChunkRef, int, str]:
    """Encode + store one raw chunk; returns (ref, bytes_written, raw sha1).

    The per-chunk body of ``store_payload_chunks``, shared with the
    device-delta write path (which brings its own skip decision — the
    fingerprint — and only reaches here for dirty blocks)."""
    rd = raw_digest if raw_digest is not None else chunk_digest(raw_chunk)
    enc = ser.compress_bytes(raw_chunk, comp)
    k = comp or "raw"
    if comp and len(enc) >= len(raw_chunk):
        enc, k = raw_chunk, "raw"             # compression didn't pay here
    # stored-raw chunks share the raw digest — don't hash 2x
    h = rd if enc is raw_chunk else chunk_digest(enc)
    pin(h)
    # Transient write faults (EIO-class) retry with backoff; pool.write
    # unlinks its quarantined tmp first, so each attempt re-lands the full
    # encoded payload. ENOSPC and friends are persistent and surface
    # immediately — the coordinator's degradation policy owns those.
    n = _retry().call_with_retry(
        lambda: pool.write(h, enc, sync_dir=dirty_dirs is None
                           and pool.durable_dirs),
        describe=f"chunk {h[:10]} write")
    if n and dirty_dirs is not None and pool.durable_dirs:
        dirty_dirs.add(os.path.dirname(pool.path(h)))
    ref = ChunkRef(hash=h, nbytes=len(enc), raw_len=len(raw_chunk),
                   crc32=zlib.crc32(enc), comp=k)
    return ref, n, rd


def _heal_and_raise(path: str, ref: ChunkRef, why: str) -> None:
    # self-heal: the file provably does not hold its address's content, so
    # removing it is always safe — the next save of the same content
    # rewrites it instead of dedup-reusing the damage
    try:
        os.remove(path)
    except OSError:
        pass
    raise IOError(f"chunk {ref.hash}: {why} (corrupt pool entry removed; "
                  "rewritten on next save)")


def _readinto_full(f, window: memoryview) -> int:
    got = 0
    while got < len(window):
        n = f.readinto(window[got:])
        if not n:
            break
        got += n
    return got


def _decode_chunk_into(pool: ChunkPool, ref: ChunkRef, window: memoryview) -> None:
    """Retrying wrapper around one chunk decode: a transient read fault
    (EIO on a flaky mount) re-reads with backoff; a content mismatch raises
    immediately (``_heal_and_raise``'s IOError carries no errno) because the
    bad entry has already been removed and only a re-save can help."""
    _retry().call_with_retry(
        lambda: _decode_chunk_into_once(pool, ref, window),
        describe=f"chunk {ref.hash[:10]} read")


def _decode_chunk_into_once(pool: ChunkPool, ref: ChunkRef,
                            window: memoryview) -> None:
    """One chunk: pool file -> (crc check, decompress) -> destination window.

    Raw chunks ``readinto`` the preallocated tensor buffer directly — one
    unbuffered pread from the page cache, then crc over the destination
    (the stored bytes *are* the raw bytes); everything data-sized releases
    the GIL, which is what makes chunk/tensor-parallel restore actually
    overlap. Compressed chunks read once and decompress into the window
    (the codec output is the only intermediate)."""
    path = pool.chunk_path(ref)
    faults.fault_point("chunk.read", path)
    with open(path, "rb", buffering=0) as f:
        if os.fstat(f.fileno()).st_size != ref.nbytes:
            _heal_and_raise(path, ref, "size mismatch")
        if ref.comp in ("", "raw"):     # stored bytes ARE the raw bytes
            if (_readinto_full(f, window) != len(window)
                    or not chunk_content_ok(ref, window, pool)):
                _heal_and_raise(path, ref, "content digest/crc mismatch")
        else:
            data = f.read()
            if not chunk_content_ok(ref, data, pool):
                _heal_and_raise(path, ref, "content digest/crc mismatch")
            window[:] = ser.decompress_bytes(data, ref.comp)


def read_payload_into(pool: ChunkPool, refs: list[dict], dst,
                      *, executor: CodecLane | None = None) -> None:
    """Reassemble a tensor's raw payload from its manifest chunk refs
    directly into ``dst`` (an ndarray or writable buffer) — no per-chunk
    ``bytes`` concatenation, no ``frombuffer(...).copy()``.

    With an ``executor``, chunks prefetch+decode in parallel (mmap reads,
    crc32 and the decompressors all release the GIL). Jobs must not submit
    sub-jobs on the same executor, so callers parallelizing at a coarser
    grain pass ``executor=None`` here.
    """
    mv = array_bytes_view(dst) if isinstance(dst, np.ndarray) else memoryview(dst)
    crefs = [ChunkRef.from_json(d) for d in refs]
    total = sum(r.raw_len for r in crefs)
    if total != len(mv):
        raise IOError(f"chunk refs cover {total} bytes but destination "
                      f"holds {len(mv)}")
    jobs = []
    off = 0
    for ref in crefs:
        window = mv[off:off + ref.raw_len]
        off += ref.raw_len
        if executor is None or len(crefs) == 1:
            _decode_chunk_into(pool, ref, window)
        else:
            jobs.append(executor.submit(_decode_chunk_into, pool, ref, window))
    if jobs:
        futures_wait(jobs)
        for j in jobs:            # propagate the first decode/crc failure
            j.result()


def _decode_boundary_chunk(pool: ChunkPool, ref: ChunkRef, window: memoryview,
                           cut_lo: int, cut_hi: int) -> None:
    # A chunk straddling the requested range's edge: the chunk is the unit
    # of storage (digest, crc, compression frame), so it must decode whole —
    # into a scratch buffer — and only the overlap is copied out. At most
    # two chunks per range pay this.
    scratch = bytearray(ref.raw_len)
    _decode_chunk_into(pool, ref, memoryview(scratch))
    window[:] = scratch[cut_lo:cut_hi]


def read_payload_range_into(pool: ChunkPool, refs: list[dict], dst,
                            *, byte_lo: int, base_off: int = 0,
                            executor: CodecLane | None = None
                            ) -> tuple[int, int]:
    """Decode only the chunks overlapping one byte range of a raw payload.

    The range-addressed sibling of ``read_payload_into``: ``dst`` receives
    bytes ``[byte_lo, byte_lo + len(dst))`` of the flattened raw payload,
    and chunks entirely outside that window are never opened — this is what
    makes a sharded restore read O(shard) instead of O(tensor). ``refs`` may
    be the record's full chunk list or a pre-selected contiguous slice of it
    (via the manifest's shard-span map); ``base_off`` is the flat byte
    offset where ``refs[0]`` begins.

    Chunks fully inside the window decode straight into their destination
    slice (same zero-copy path as the full read); the at-most-two boundary
    chunks decode to scratch and copy only the overlap. Returns
    ``(chunks_decoded, chunks_skipped)`` so callers can account the win.
    The serial path yields to higher codec lanes between chunks, matching
    the store path's preemption discipline.
    """
    mv = array_bytes_view(dst) if isinstance(dst, np.ndarray) else memoryview(dst)
    byte_hi = byte_lo + len(mv)
    crefs = [ChunkRef.from_json(d) for d in refs]
    if base_off + sum(r.raw_len for r in crefs) < byte_hi:
        raise IOError(
            f"chunk refs end at {base_off + sum(r.raw_len for r in crefs)} "
            f"but the requested range extends to {byte_hi}")
    jobs = []
    decoded = skipped = 0
    off = base_off
    for ref in crefs:
        lo, hi = off, off + ref.raw_len
        off = hi
        if hi <= byte_lo or lo >= byte_hi:
            skipped += 1
            continue
        decoded += 1
        w_lo, w_hi = max(lo, byte_lo), min(hi, byte_hi)
        window = mv[w_lo - byte_lo:w_hi - byte_lo]
        if w_lo == lo and w_hi == hi:
            fn, fargs = _decode_chunk_into, (pool, ref, window)
        else:
            fn, fargs = _decode_boundary_chunk, (
                pool, ref, window, w_lo - lo, w_hi - lo)
        if executor is None:
            codec_sched.maybe_yield()
            fn(*fargs)
        else:
            jobs.append(executor.submit(fn, *fargs))
    if jobs:
        futures_wait(jobs)
        for j in jobs:
            j.result()
    return decoded, skipped
