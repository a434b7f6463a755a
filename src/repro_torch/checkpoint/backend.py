"""ChunkBackend — the chunk pool's durable tier, POSIX or object store.

The content-addressed pool (``chunkstore.ChunkPool``) historically assumed
one POSIX mount shared by every fleet member. This module abstracts *where
the durable copy of a chunk lives* behind a small backend interface so the
same pool semantics run against an S3/GCS-style object store reached over a
lossy network — the most failure-prone layer of a real spot deployment.

Pieces:

* :class:`ChunkBackend` — the interface: ``head`` / ``get_range`` / ``put``
  / multipart upload (``create_multipart`` → ``upload_part`` →
  ``complete_multipart``) / ``delete`` / ``list_keys``. Keys mirror the
  POSIX fan-out exactly (``chunks/<hh>/<hash>``), so a bucket listing and a
  pool ``ls`` are the same namespace.
* :class:`PosixBackend` — the existing layout behind the interface (a
  directory tree, atomic tmp+rename puts). The default store remains a
  plain ``ChunkPool`` — zero behavior change without an explicit backend.
* :class:`InProcessObjectStore` + :class:`ObjectStoreBackend` — an
  in-process S3-style server (keyed blobs, ranged GETs, multipart upload
  sessions) with an injectable :class:`NetworkModel` (latency + serialized
  link bandwidth) and an outage switch, plus the client that talks to it.
  CI exercises the whole network failure surface with no cloud credentials.
* :class:`BackendChunkPool` — a ``ChunkPool`` whose root directory is a
  local **read-through cache** and whose durable tier is a backend. It
  overrides the same single ``chunk_path`` hook the peer-exchange pool
  uses, so every decode/restore path (streaming, range-addressed, mmap
  zero-copy) gets backend read-through without knowing it — and composes
  under ``peer_exchange.ReadThroughPool`` as the shared tier, giving the
  full local → peer → object-store resolution order.

Robustness contract (the reason this module exists):

* **Every ranged GET is retried, keyed by content address.** A torn or
  short response is re-fetchable by hash: :func:`fetch_chunk_verified`
  re-digests the payload against the address *before accepting it* and
  re-fetches on mismatch, bounded attempts with jitter seeded from the
  content address (``core.retry.call_with_retry``). No byte is trusted
  until it hashes to its name — the same trust model as the peer exchange.
* **Uploads are idempotent per chunk key.** :func:`upload_chunk` HEADs the
  address first; a re-PUT of an already-committed address is a verified
  no-op (size must match — a truncated blob from a torn upload is
  *rewritten*, never trusted), never an append. Multipart parts are keyed
  by part number inside a session, so a crashed upload restarts cleanly.
* **Uploads overlap encode.** ``BackendChunkPool.write`` lands the local
  cache copy synchronously (dedup and mmap re-reads stay fast) and
  pipelines the backend upload on the codec executor's PERIODIC lane,
  calling ``codec_sched.maybe_yield`` so RESTORE-lane traffic preempts
  queued uploads. ``flush_uploads`` is the save's pre-commit barrier: the
  manifest may only commit once every referenced chunk is durable.
* **A persistent outage degrades, never corrupts.** :class:`BackendHealth`
  flips outage mode after N consecutive failed ops; writes then spool to
  the local cache (counted in ``spooled_bytes``) and the store parks the
  staged manifest instead of committing it. ``CheckpointStore.
  reconcile_spooled`` re-uploads and commits once ``probe`` sees the store
  again — manifest commit strictly after every ref is durable. Restores
  fall back local → peer → store throughout, so an outage during an
  eviction storm does not strand survivors.

Fault surface: the client consults the process-wide fault plan at
``backend.get`` / ``backend.put`` / ``backend.head`` / ``backend.complete``
(errno, torn-response and rename-rollback-analogue behaviours — see
``faults.plan``). Process-wide ``backend_retries`` / ``backend_outages`` /
``spooled_bytes`` counters are folded into ``CoordinatorStats`` the same
way io_retries are.
"""

from __future__ import annotations

import errno
import logging
import os
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Iterator, Optional

from ..faults import inject as faults
from . import chunkstore
from . import codec_sched
from .chunkstore import ChunkRef
from .ioutil import fsync_dir

log = logging.getLogger("spoton.backend")

__all__ = [
    "BackendChunkPool",
    "BackendHealth",
    "ChunkBackend",
    "InProcessObjectStore",
    "NetworkModel",
    "ObjectStoreBackend",
    "PosixBackend",
    "fetch_chunk_verified",
    "object_key",
    "snapshot_stats",
    "upload_chunk",
]

#: objects larger than this upload as multipart (chunks are usually 1 MiB,
#: so simple PUT dominates; tests shrink this to force the multipart path)
DEFAULT_PART_SIZE = 8 << 20

OBJECT_PREFIX = "chunks"


def object_key(h: str) -> str:
    """Bucket key of a chunk address — mirrors the POSIX ``chunks/<hh>/<hash>``
    fan-out so the object namespace and a pool directory are interchangeable."""
    return f"{OBJECT_PREFIX}/{h[:2]}/{h}"


def _retry():
    # same deferred import as chunkstore: repro_torch.core's __init__ imports the
    # coordinator which imports repro_torch.checkpoint — importing core.retry at
    # module level would observe a half-initialized package
    from ..core import retry
    return retry


# -- process-wide robustness counters ------------------------------------------

_stats_lock = threading.Lock()
_backend_retries = 0
_backend_outages = 0
_spooled_bytes = 0


def snapshot_stats() -> Dict[str, int]:
    """Monotonic process-wide backend robustness counters since import:
    retry attempts burned on backend ops, outage windows entered, and bytes
    spooled locally while the store was unreachable."""
    with _stats_lock:
        return {"backend_retries": _backend_retries,
                "backend_outages": _backend_outages,
                "spooled_bytes": _spooled_bytes}


def _count(retries: int = 0, outages: int = 0, spooled: int = 0) -> None:
    global _backend_retries, _backend_outages, _spooled_bytes
    with _stats_lock:
        _backend_retries += retries
        _backend_outages += outages
        _spooled_bytes += spooled


# -- the backend interface -----------------------------------------------------


class ChunkBackend:
    """Durable keyed-blob tier behind a chunk pool.

    Implementations must make ``put``/``complete_multipart`` *atomic per
    key* — a reader never observes a partially-landed object under its
    final key (POSIX: tmp+rename; object stores give this natively). They
    are NOT required to be idempotent or reliable: the call sites own both
    (content-address verification, bounded retry, HEAD-before-PUT)."""

    def head(self, key: str) -> Optional[int]:
        """Size of the committed object at ``key``, or None if absent.
        Raises OSError when the store is unreachable."""
        raise NotImplementedError

    def get_range(self, key: str, start: int, length: int) -> bytes:
        """Bytes ``[start, start+length)`` of the object. Missing key raises
        ENOENT; an unreachable store raises a transient OSError. Callers
        must verify the payload against the content address before trusting
        it (``fetch_chunk_verified``)."""
        raise NotImplementedError

    def put(self, key: str, data) -> None:
        raise NotImplementedError

    def create_multipart(self, key: str) -> str:
        raise NotImplementedError

    def upload_part(self, key: str, upload_id: str, part_no: int, data) -> None:
        raise NotImplementedError

    def complete_multipart(self, key: str, upload_id: str) -> None:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def list_keys(self) -> Iterator[str]:
        raise NotImplementedError


class PosixBackend(ChunkBackend):
    """The existing POSIX layout behind the backend interface: a directory
    tree with the same ``chunks/<hh>/<hash>`` fan-out, atomic tmp+rename
    puts. Useful to run the backend-pool machinery against an NFS mount —
    the default store keeps using a plain ``ChunkPool`` directly."""

    def __init__(self, root: str):
        self.root = root
        self._sessions: dict[str, tuple[str, dict[int, bytes]]] = {}
        self._lock = threading.Lock()

    def _path(self, key: str) -> str:
        return os.path.join(self.root, *key.split("/"))

    def head(self, key: str) -> Optional[int]:
        try:
            return os.path.getsize(self._path(key))
        except OSError:
            return None

    def get_range(self, key: str, start: int, length: int) -> bytes:
        with open(self._path(key), "rb") as f:
            f.seek(start)
            return f.read(length)

    def put(self, key: str, data) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + f".tmp-{uuid.uuid4().hex[:8]}"
        try:
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            fsync_dir(os.path.dirname(path))
        except Exception:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def create_multipart(self, key: str) -> str:
        uid = uuid.uuid4().hex[:12]
        with self._lock:
            self._sessions[uid] = (key, {})
        return uid

    def upload_part(self, key: str, upload_id: str, part_no: int, data) -> None:
        with self._lock:
            sess = self._sessions.get(upload_id)
            if sess is None or sess[0] != key:
                raise OSError(errno.ENOENT,
                              f"no such multipart upload: {upload_id}")
            sess[1][part_no] = bytes(data)

    def complete_multipart(self, key: str, upload_id: str) -> None:
        with self._lock:
            sess = self._sessions.pop(upload_id, None)
        if sess is None or sess[0] != key:
            raise OSError(errno.ENOENT, f"no such multipart upload: {upload_id}")
        self.put(key, b"".join(sess[1][i] for i in sorted(sess[1])))

    def delete(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except FileNotFoundError:
            pass

    def list_keys(self) -> Iterator[str]:
        base = os.path.join(self.root, OBJECT_PREFIX)
        try:
            shards = sorted(os.listdir(base))
        except FileNotFoundError:
            return
        for hh in shards:
            sub = os.path.join(base, hh)
            try:
                names = sorted(os.listdir(sub))
            except (NotADirectoryError, FileNotFoundError):
                continue
            for name in names:
                if ".tmp-" not in name:
                    yield f"{OBJECT_PREFIX}/{hh}/{name}"


# -- in-process object store ---------------------------------------------------


@dataclass(frozen=True)
class NetworkModel:
    """Latency + serialized-link bandwidth model for the in-process store.
    ``gbps=0`` means an unmodeled (infinite) link."""

    latency_s: float = 0.0
    gbps: float = 0.0

    def transfer_s(self, nbytes: int) -> float:
        bw = self.gbps * 1e9
        return self.latency_s + (nbytes / bw if bw > 0 else 0.0)


class InProcessObjectStore:
    """An S3-style keyed-blob server living in this process.

    Blobs commit atomically per key (the dict assignment is the commit
    point); multipart uploads stage parts in a session keyed by upload id
    and only ``complete_multipart`` makes the object visible. Every op pays
    the :class:`NetworkModel`'s latency and — for payload-carrying ops —
    its serialized link bandwidth; ``set_outage(True)`` makes every op
    raise ETIMEDOUT, modelling an unreachable endpoint. ``put_generations``
    counts commits per key so tests can prove a re-PUT was a no-op rather
    than an append or a second copy."""

    def __init__(self, *, network: NetworkModel | None = None):
        self.network = network or NetworkModel()
        self.outage = False
        self.objects: dict[str, bytes] = {}
        self.put_generations: dict[str, int] = {}
        self._sessions: dict[str, tuple[str, dict[int, bytes]]] = {}
        self._lock = threading.Lock()
        self._link = threading.Lock()
        self.stats = {"heads": 0, "gets": 0, "puts": 0, "parts": 0,
                      "completes": 0, "deletes": 0,
                      "bytes_in": 0, "bytes_out": 0}

    def set_outage(self, on: bool) -> None:
        self.outage = bool(on)

    def _io(self, nbytes: int) -> None:
        if self.outage:
            raise OSError(errno.ETIMEDOUT, "object store unreachable (outage)")
        dt = self.network.transfer_s(nbytes)
        if dt > 0.0:
            with self._link:
                # the lock IS the model: one NIC/egress link, transfers
                # serialize on it exactly like the bench's modeled pools
                time.sleep(dt)  # spotlint: ignore[SPOT031]

    def head(self, key: str) -> Optional[int]:
        self._io(0)
        with self._lock:
            self.stats["heads"] += 1
            blob = self.objects.get(key)
        return None if blob is None else len(blob)

    def get_range(self, key: str, start: int, length: int) -> bytes:
        with self._lock:
            blob = self.objects.get(key)
            if blob is not None:
                self.stats["gets"] += 1
                data = blob[start:start + length]
                self.stats["bytes_out"] += len(data)
        if blob is None:
            self._io(0)
            raise OSError(errno.ENOENT, f"no such object: {key}")
        self._io(len(data))
        return data

    def put(self, key: str, data) -> None:
        data = bytes(data)
        self._io(len(data))
        with self._lock:
            self.stats["puts"] += 1
            self.stats["bytes_in"] += len(data)
            self.objects[key] = data
            self.put_generations[key] = self.put_generations.get(key, 0) + 1

    def create_multipart(self, key: str) -> str:
        self._io(0)
        uid = uuid.uuid4().hex[:12]
        with self._lock:
            self._sessions[uid] = (key, {})
        return uid

    def upload_part(self, key: str, upload_id: str, part_no: int, data) -> None:
        data = bytes(data)
        self._io(len(data))
        with self._lock:
            sess = self._sessions.get(upload_id)
            if sess is None or sess[0] != key:
                raise OSError(errno.ENOENT,
                              f"no such multipart upload: {upload_id}")
            sess[1][part_no] = data
            self.stats["parts"] += 1
            self.stats["bytes_in"] += len(data)

    def complete_multipart(self, key: str, upload_id: str) -> None:
        self._io(0)
        with self._lock:
            sess = self._sessions.pop(upload_id, None)
            if sess is None or sess[0] != key:
                raise OSError(errno.ENOENT,
                              f"no such multipart upload: {upload_id}")
            self.objects[key] = b"".join(sess[1][i] for i in sorted(sess[1]))
            self.stats["completes"] += 1
            self.put_generations[key] = self.put_generations.get(key, 0) + 1

    def delete(self, key: str) -> None:
        self._io(0)
        with self._lock:
            if self.objects.pop(key, None) is not None:
                self.stats["deletes"] += 1

    def list_keys(self) -> Iterator[str]:
        with self._lock:
            keys = sorted(self.objects)
        yield from keys

    def total_bytes(self) -> int:
        with self._lock:
            return sum(len(b) for b in self.objects.values())


class ObjectStoreBackend(ChunkBackend):
    """Client half of the in-process object store: each op consults the
    process-wide fault plan (``backend.head`` / ``backend.get`` /
    ``backend.put`` / ``backend.complete``), so the torture suites drive
    errno faults, torn requests/responses and post-complete rollbacks
    through the same machinery the POSIX commit path uses. In a real
    deployment this class is the seam where an S3/GCS SDK slots in."""

    def __init__(self, server: InProcessObjectStore):
        self.server = server

    def head(self, key: str) -> Optional[int]:
        faults.fault_point("backend.head", key)
        return self.server.head(key)

    def get_range(self, key: str, start: int, length: int) -> bytes:
        # single plan check per GET, on the response: a ``torn`` rule
        # truncates the body (connection died mid-transfer) and the
        # content-address check upstream turns it into a retry
        data = self.server.get_range(key, start, length)
        return faults.response_bytes(data, op="backend.get", path=key)

    def put(self, key: str, data) -> None:
        # torn rule: only a prefix reaches the server before the "process"
        # dies — the truncated blob sits under the final key and must be
        # detected by the verified re-PUT, never trusted by existence alone
        faults.send_bytes(lambda d: self.server.put(key, d), data,
                          op="backend.put", path=key)

    def create_multipart(self, key: str) -> str:
        return self.server.create_multipart(key)

    def upload_part(self, key: str, upload_id: str, part_no: int, data) -> None:
        faults.send_bytes(
            lambda d: self.server.upload_part(key, upload_id, part_no, d),
            data, op="backend.put", path=f"{key}#part{part_no}")

    def complete_multipart(self, key: str, upload_id: str) -> None:
        self.server.complete_multipart(key, upload_id)
        # post-complete fault point: an errno here models a lost ack (the
        # object IS committed — the retrying uploader's HEAD discovers that
        # and no-ops); a ``rollback`` rule un-commits the object first, the
        # object-store analogue of a rename that never became durable
        faults.fault_point("backend.complete", key,
                           rollback=lambda: self.server.delete(key))

    def delete(self, key: str) -> None:
        self.server.delete(key)

    def list_keys(self) -> Iterator[str]:
        return self.server.list_keys()


# -- verified transfer helpers -------------------------------------------------


def _backend_retry(fn: Callable[[], object], *, describe: str,
                   h: str = "", policy=None):
    """Bounded backend-op retry: ``core.retry.call_with_retry`` with jitter
    seeded from the content address (deterministic per chunk, decorrelated
    across chunks) and the process-wide ``backend_retries`` counter bumped
    once per re-attempt."""
    import random
    rng = random.Random(int(h[:8], 16)) if h else None

    def _sleep(delay: float) -> None:
        _count(retries=1)
        time.sleep(delay)

    r = _retry()
    return r.call_with_retry(fn, policy=policy or r.IO_RETRY, sleep=_sleep,
                             rng=rng, describe=describe)


def fetch_chunk_verified(backend: ChunkBackend, ref: ChunkRef, *,
                         policy=None) -> bytes:
    """One chunk's stored bytes from the backend, verified and retried.

    The ranged GET runs in a bounded retry loop *keyed by the content
    address*: the payload is re-digested against ``ref.hash`` before being
    accepted (``chunk_content_ok``), and a short/torn/corrupt response is
    indistinguishable from a transient network fault — re-fetch by hash,
    bounded attempts, address-seeded jitter. Raises OSError once the bound
    is exhausted; never returns unverified bytes."""
    return _backend_retry(lambda: _fetch_chunk_once(backend, ref),
                          describe=f"backend get {ref.hash[:10]}",
                          h=ref.hash, policy=policy)


def _fetch_chunk_once(backend: ChunkBackend, ref: ChunkRef) -> bytes:
    data = backend.get_range(object_key(ref.hash), 0, ref.nbytes)
    if len(data) != ref.nbytes or not chunkstore.chunk_content_ok(ref, data):
        # EIO is transient to the retry classifier: a re-fetch may succeed
        # verbatim, which is exactly what content addressing licenses
        raise OSError(errno.EIO,
                      f"backend chunk {ref.hash[:10]}: short or corrupt "
                      f"ranged GET ({len(data)}/{ref.nbytes} bytes)")
    return data


def upload_chunk(backend: ChunkBackend, h: str, data, *,
                 part_size: int = DEFAULT_PART_SIZE) -> int:
    """Idempotent upload of one chunk to its content address.

    HEAD first: an already-committed address with the expected size is a
    verified no-op (0 bytes sent) — a re-PUT is never an append and never a
    second copy, because the key *is* the content. A size mismatch (torn
    upload debris) is rewritten whole. Large payloads go multipart —
    parts keyed by number inside a fresh session, so a crashed upload
    restarts cleanly — with a ``maybe_yield`` between parts so RESTORE-lane
    traffic preempts. Returns bytes sent."""
    key = object_key(h)
    if backend.head(key) == len(data):
        return 0
    if len(data) <= part_size:
        backend.put(key, data)
        return len(data)
    uid = backend.create_multipart(key)
    view = memoryview(data) if not isinstance(data, (bytes, memoryview)) \
        else data
    for pno, off in enumerate(range(0, len(data), part_size)):
        codec_sched.maybe_yield()
        backend.upload_part(key, uid, pno, view[off:off + part_size])
    backend.complete_multipart(key, uid)
    return len(data)


# -- outage detection ----------------------------------------------------------


class BackendHealth:
    """Consecutive-failure outage detector for one backend connection.

    Individual op failures already retried and spooled per chunk; this
    tracks the *state* — ``outage_after`` consecutive failed ops flip
    outage mode (counted process-wide in ``backend_outages``), which
    short-circuits further upload/HEAD attempts until an explicit probe or
    any successful op clears it. One success resets the streak: a flaky
    link is retries, not an outage."""

    def __init__(self, *, outage_after: int = 3):
        self.outage_after = outage_after
        self._failures = 0
        self._outage = False
        self._lock = threading.Lock()

    def note_failure(self) -> None:
        with self._lock:
            self._failures += 1
            flipped = (not self._outage
                       and self._failures >= self.outage_after)
            if flipped:
                self._outage = True
        if flipped:
            _count(outages=1)
            log.warning("object store unreachable after %d consecutive "
                        "failed ops: entering outage mode (writes spool "
                        "locally, manifests park until reconcile)",
                        self.outage_after)

    def note_success(self) -> None:
        with self._lock:
            recovered = self._outage
            self._failures = 0
            self._outage = False
        if recovered:
            log.info("object store reachable again: outage mode cleared")

    def in_outage(self) -> bool:
        with self._lock:
            return self._outage


# -- the backend-backed chunk pool ---------------------------------------------


class BackendChunkPool(chunkstore.ChunkPool):
    """A chunk pool whose root is a local read-through cache and whose
    durable tier is a :class:`ChunkBackend`.

    Reads resolve through the standard ``chunk_path`` hook: cache hit →
    the mmap fast path is untouched; miss → a verified, retried ranged GET
    lands the chunk in the cache and decode proceeds from the file. Writes
    land in the cache synchronously (dedup against the running save stays
    one stat) and pipeline the backend upload on the codec executor,
    overlapped with encode; ``flush_uploads`` is the save's pre-commit
    barrier. During an outage writes spool (tracked per hash — the cache
    file is the spool) and ``CheckpointStore`` parks the manifest until
    ``upload_now``/``probe`` reconcile. Composes as the *shared* tier of
    ``peer_exchange.ReadThroughPool`` for local → peer → store resolution.
    """

    #: the cache is not the durable copy: per-save fan-out dir fsyncs are
    #: wasted work here, the durability bar is "every ref uploaded before
    #: the manifest commits" (see chunkstore.store_chunk)
    durable_dirs = False

    def __init__(self, cache_root: str, backend: ChunkBackend, *,
                 part_size: int = DEFAULT_PART_SIZE,
                 retry_policy=None,
                 health: BackendHealth | None = None,
                 upload_lane: int = codec_sched.PERIODIC):
        super().__init__(cache_root)
        self.backend = backend
        self.part_size = part_size
        self.retry_policy = retry_policy
        self.health = health or BackendHealth()
        self.upload_lane = upload_lane
        self._track_lock = threading.Lock()
        self._durable: set[str] = set()       # confirmed in the backend
        self._spooled: dict[str, int] = {}    # h -> nbytes awaiting upload
        self._uploads: dict[str, object] = {}  # h -> in-flight Future
        # cache-fill reentrancy guard: while the read path writes a fetched
        # chunk into the cache, ``check`` must answer from the local tree
        # only — otherwise ChunkPool.write's dedup sees the backend copy and
        # skips creating the very file the decode is about to open
        self._local_only = threading.local()
        self.stats = {"cache_hits": 0, "backend_reads": 0, "uploads": 0,
                      "upload_bytes": 0, "spooled": 0, "reconciled": 0}
        self._stats_lock = threading.Lock()

    def _bump(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self.stats[key] += n

    # -- read path -------------------------------------------------------------

    def chunk_path(self, ref: ChunkRef) -> str:
        path = self.path(ref.hash)
        if os.path.exists(path):
            self._bump("cache_hits")
            return path
        try:
            data = fetch_chunk_verified(self.backend, ref,
                                        policy=self.retry_policy)
        except OSError:
            self.health.note_failure()
            raise
        self.health.note_success()
        with self._track_lock:
            self._durable.add(ref.hash)
        # cache fill: atomic write, no dir fsync — the backend holds the
        # durable copy, the cache only has to win the mmap fast path
        self._local_only.on = True
        try:
            super().write(ref.hash, data, sync_dir=False)
        finally:
            self._local_only.on = False
        self._bump("backend_reads")
        return path

    def _head_size(self, h: str) -> Optional[int]:
        """Committed size of ``h`` in the backend, None when absent or
        unreachable. Short-circuits during an outage so dedup checks don't
        hammer a dead endpoint."""
        if self.health.in_outage():
            return None
        try:
            size = self.backend.head(object_key(h))
        except OSError:
            self.health.note_failure()
            return None
        self.health.note_success()
        return size

    def check(self, h: str, nbytes: int) -> bool:
        if super().check(h, nbytes):
            if getattr(self._local_only, "on", False):
                return True
            with self._track_lock:
                known = (h in self._durable or h in self._spooled
                         or h in self._uploads)
            if not known:
                # cache entry from a previous process: dedup may reuse it
                # only once the durable copy is confirmed — or scheduled
                if self._head_size(h) == nbytes:
                    with self._track_lock:
                        self._durable.add(h)
                else:
                    self._schedule_upload(h)
            return True
        if getattr(self._local_only, "on", False):
            return False
        return self._head_size(h) == nbytes

    def touch(self, h: str) -> bool:
        if super().touch(h):
            return True
        return self._head_size(h) is not None

    # -- write path ------------------------------------------------------------

    def write(self, h: str, data, *, sync_dir: bool = True) -> int:
        n = super().write(h, data, sync_dir=False)
        self._schedule_upload(h)
        return n

    def _schedule_upload(self, h: str) -> None:
        with self._track_lock:
            if (h in self._durable or h in self._uploads
                    or h in self._spooled):
                return
            if self.health.in_outage():
                self._spool_locked(h)
                return
            try:
                # enqueue-only under the lock (no wait): upload jobs overlap
                # the remaining encode work on the same executor
                fut = codec_sched.lane(self.upload_lane).submit(
                    self._upload_job, h)
            except RuntimeError:
                # scheduler already shut down (interpreter exit): spool —
                # reconcile on the next process owns the upload
                self._spool_locked(h)
                return
            self._uploads[h] = fut

    def _upload_job(self, h: str) -> bool:
        # preemption checkpoint: queued uploads hand their worker to any
        # RESTORE/URGENT job before touching the network
        codec_sched.maybe_yield()
        try:
            with open(self.path(h), "rb") as f:
                data = f.read()
        except OSError:
            # cache entry vanished (sweep race): the next writer of this
            # content re-lands it; nothing to upload now
            with self._track_lock:
                self._uploads.pop(h, None)
            return False
        try:
            sent = _backend_retry(
                lambda: upload_chunk(self.backend, h, data,
                                     part_size=self.part_size),
                describe=f"backend put {h[:10]}", h=h,
                policy=self.retry_policy)
        except Exception:
            # bounded retries exhausted: the chunk is safe in the cache —
            # spool it and let the outage machinery own the re-upload
            self.health.note_failure()
            with self._track_lock:
                self._uploads.pop(h, None)
                self._spool_locked(h, len(data))
            return False
        except BaseException:
            # SimulatedCrash and friends: leave the future in the tracking
            # table so flush_uploads finds it and re-raises (the save dies
            # there, exactly like a process kill mid-upload) — popping it
            # here would let the durability barrier miss the dead upload
            # and commit a manifest over a ref that never landed
            raise
        self.health.note_success()
        self._bump("uploads")
        self._bump("upload_bytes", sent)
        with self._track_lock:
            self._uploads.pop(h, None)
            self._durable.add(h)
        return True

    def _spool_locked(self, h: str, nbytes: int | None = None) -> None:
        """Record ``h`` as awaiting upload (caller holds ``_track_lock``).
        The cache file IS the spool — only bookkeeping lives here."""
        if h in self._spooled:
            return
        if nbytes is None:
            try:
                nbytes = os.path.getsize(self.path(h))
            except OSError:
                nbytes = 0
        self._spooled[h] = nbytes
        _count(spooled=nbytes)
        self._bump("spooled")

    # -- durability barrier / reconcile ----------------------------------------

    def flush_uploads(self, hashes: Iterable[str] | None = None) -> set[str]:
        """Wait for in-flight uploads, then report which of ``hashes`` (all
        tracked spool entries when None) are still not durable. The save
        path calls this before its manifest commit: a non-empty return
        means "park, don't commit". Re-raises a crash injected into an
        upload job — a killed uploader kills the save."""
        want = None if hashes is None else set(hashes)
        while True:
            with self._track_lock:
                pending = [(h, f) for h, f in self._uploads.items()
                           if want is None or h in want]
            if not pending:
                break
            for h, f in pending:
                try:
                    f.result()
                except BaseException:
                    # surface the crash, but clear the dead upload's
                    # tracking entry first: the successor save must be
                    # able to reschedule this chunk, not wait forever on
                    # (or re-die at) a future that already failed
                    with self._track_lock:
                        if self._uploads.get(h) is f:
                            del self._uploads[h]
                    raise
        with self._track_lock:
            spooled = set(self._spooled)
        return spooled if want is None else spooled & want

    def undurable(self, hashes: Iterable[str]) -> set[str]:
        """Subset of ``hashes`` with no confirmed durable copy (spooled or
        never uploaded)."""
        with self._track_lock:
            return {h for h in hashes if h not in self._durable}

    def upload_now(self, hashes: Iterable[str]) -> bool:
        """Synchronously make every hash in ``hashes`` durable (the
        reconcile path). True when all are; False at the first chunk the
        backend still refuses — the caller's parked commit stays parked."""
        want = set(hashes)
        self.flush_uploads(want)
        with self._track_lock:
            todo = sorted(h for h in want if h not in self._durable)
        for h in todo:
            path = self.path(h)
            if not os.path.exists(path):
                # not spooled locally (e.g. another member's chunk): only a
                # confirmed backend copy can satisfy the durability bar
                if self._head_size(h) is not None:
                    with self._track_lock:
                        self._durable.add(h)
                        self._spooled.pop(h, None)
                    continue
                return False
            try:
                with open(path, "rb") as f:
                    data = f.read()
                sent = _backend_retry(
                    lambda: upload_chunk(self.backend, h, data,
                                         part_size=self.part_size),
                    describe=f"backend reconcile {h[:10]}", h=h,
                    policy=self.retry_policy)
            except Exception:
                self.health.note_failure()
                return False
            self.health.note_success()
            self._bump("uploads")
            self._bump("upload_bytes", sent)
            self._bump("reconciled")
            with self._track_lock:
                self._spooled.pop(h, None)
                self._durable.add(h)
        return True

    def probe(self) -> bool:
        """One cheap HEAD against the store; a response — hit or miss —
        proves reachability and clears outage mode."""
        if not self.health.in_outage():
            return True
        try:
            self.backend.head(object_key("0" * 40))
        except OSError:
            self.health.note_failure()
            return False
        self.health.note_success()
        return True

    def spooled_bytes(self) -> int:
        with self._track_lock:
            return sum(self._spooled.values())
