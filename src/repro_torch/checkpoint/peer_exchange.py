"""Peer-to-peer chunk exchange — replacements warm-restore from neighbors.

A replacement instance's restore normally cold-reads shared storage, even
though the surviving fleet members hold most of the checkpoint's chunks in
their instance-local pools (page-cache hot, NIC-close). This module closes
that gap with the smallest possible protocol: every fleet member runs a tiny
length-prefixed TCP server over its **content-addressed** local pool, and a
restoring process consults the peers *before* shared storage.

Why this is safe with so little machinery: chunks are addressed by the
sha1 of their stored bytes (``chunkstore.chunk_digest``), so a fetched
payload is validated by re-digesting it against the address that was
requested — a lying, stale or truncated peer is indistinguishable from a
miss and simply falls through to the store. No peer is trusted; the shared
store remains the durable source of truth.

Wire protocol (all integers big-endian; one request per connection round):

    request  := op(1) | hash(40 ascii hex) | [PUT only: len(u64) | payload]
    response := status(1) | [GET hit: len(u64) | payload]

    ops:    b"G" get chunk        b"P" put (push) chunk
    status: b"H" hit   b"M" miss   b"O" ok   b"E" error

Read-through restore (``ReadThroughPool``): the decode path resolves each
chunk local pool → peer fetch → shared store. A peer hit is written into
the local pool first (``sync_dir=False`` — the local pool is a cache; the
store holds the durable copy) and decoded from there on the RESTORE lane;
a miss or dead peer falls back to the store's chunk file, whose decode
already runs under ``core.retry``'s bounded IO retry. Seeding happens in
the eviction-notice window: ``FleetPeerExchange.seed_from`` pushes the
evictee's hottest chunks (most recently written first) to every survivor,
so the replacement warms from neighbors at NIC speed instead of re-reading
the shared volume.
"""

from __future__ import annotations

import logging
import os
import socket
import threading
from typing import Iterable, Sequence

from ..faults import inject as faults
from . import chunkstore
from . import codec_sched
from .chunkstore import ChunkRef
from .ioutil import mmap_view, release_view

log = logging.getLogger("spoton.peer")

HASH_LEN = 40                       # ascii hex sha1 (same width as blake2b-160)
OP_GET, OP_PUT = b"G", b"P"
ST_HIT, ST_MISS, ST_OK, ST_ERR = b"H", b"M", b"O", b"E"
MAX_CHUNK_BYTES = 1 << 28           # frame sanity bound, far above any chunk


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    """Read exactly ``n`` bytes or return None on a short/closed stream."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        try:
            k = sock.recv_into(view[got:], n - got)
        except OSError:
            return None
        if not k:
            return None
        got += k
    return bytes(buf)


class PeerChunkServer:
    """One fleet member's chunk server: serves sha1-addressed chunks out of
    its local pool over loopback/NIC TCP. GET streams the pool file through
    an mmap view (page cache → socket, no intermediate copy); PUT accepts a
    digest-verified chunk into the pool (the seeding path). Connections are
    handled on short-lived daemon threads — the request unit is one chunk,
    and the accept loop owns no locks, so a stuck peer never wedges saves."""

    def __init__(self, pool: chunkstore.ChunkPool, *, host: str = "127.0.0.1",
                 port: int = 0):
        self.pool = pool
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self._sock.settimeout(0.2)      # bounded accept wait -> clean close
        self.address: tuple[str, int] = self._sock.getsockname()
        self._stop = threading.Event()
        self._accept_thread: threading.Thread | None = None
        self.stats = {"get_hits": 0, "get_misses": 0, "puts": 0,
                      "bytes_served": 0}
        self._stats_lock = threading.Lock()

    def start(self) -> "PeerChunkServer":
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name=f"peer-chunk-{self.address[1]}")
        self._accept_thread = t
        t.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)
        try:
            self._sock.close()
        except OSError:
            pass

    def _bump(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self.stats[key] += n

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        conn.settimeout(5.0)
        try:
            with conn:
                while True:
                    head = _recv_exact(conn, 1 + HASH_LEN)
                    if head is None:
                        return
                    op, h = head[:1], head[1:].decode("ascii", "replace")
                    if op == OP_GET:
                        self._handle_get(conn, h)
                    elif op == OP_PUT:
                        self._handle_put(conn, h)
                    else:
                        conn.sendall(ST_ERR)
                        return
        except (OSError, ValueError):
            pass                        # peer vanished mid-request: its loss
        except faults.SimulatedCrash:
            pass                        # injected mid-transfer death (tests)

    def _handle_get(self, conn: socket.socket, h: str) -> None:
        path = self.pool.path(h)
        try:
            view = mmap_view(path)
        except OSError:
            self._bump("get_misses")
            conn.sendall(ST_MISS)
            return
        try:
            header = ST_HIT + len(view).to_bytes(8, "big")
            try:
                faults.fault_point("peer.send", path)
            except BaseException:
                # injected mid-transfer death: announce the full length but
                # deliver half, then drop the connection — exactly what a
                # preempted instance does to its clients
                conn.sendall(header + bytes(view[:len(view) // 2]))
                raise
            conn.sendall(header)
            conn.sendall(view)          # mmap fast path: page cache -> socket
            self._bump("get_hits")
            self._bump("bytes_served", len(view))
        finally:
            release_view(view)

    def _handle_put(self, conn: socket.socket, h: str) -> None:
        head = _recv_exact(conn, 8)
        if head is None:
            return
        n = int.from_bytes(head, "big")
        if not 0 < n <= MAX_CHUNK_BYTES:
            conn.sendall(ST_ERR)
            return
        data = _recv_exact(conn, n)
        # digest-verify before pooling: a push may not plant bytes under an
        # address they don't hash to (content addressing is the trust model)
        if data is None or chunkstore.chunk_digest(data) != h:
            conn.sendall(ST_ERR)
            return
        try:
            # local pool is a cache of the durable store -> no dir fsync
            self.pool.write(h, data, sync_dir=False)
        except OSError:
            conn.sendall(ST_ERR)
            return
        self._bump("puts")
        conn.sendall(ST_OK)


class PeerChunkClient:
    """Fetch/push sha1-addressed chunks from/to a set of peer servers.

    ``fetch`` rotates its starting peer by the chunk hash (cheap load
    spreading across survivors) and tries each peer once; any connection
    error, timeout, short read or digest mismatch moves on to the next peer
    and ultimately returns None — the caller's store fallback is the only
    retry that matters (``core.retry`` bounds it). Never raises for a dead
    peer; a dead peer must cost one timeout, not a restore."""

    def __init__(self, peers: Sequence[tuple[str, int]], *,
                 timeout_s: float = 1.0):
        self.peers = list(peers)
        self.timeout_s = timeout_s
        self.stats = {"hits": 0, "misses": 0, "bytes_fetched": 0,
                      "pushes": 0, "push_failures": 0}
        self._stats_lock = threading.Lock()

    def _bump(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self.stats[key] += n

    def fetch(self, ref: ChunkRef) -> bytes | None:
        """Stored bytes of ``ref`` from the first peer that has them, or
        None. The returned payload has already been validated against the
        content address (``chunk_content_ok``)."""
        if not self.peers:
            return None
        start = int(ref.hash[:8], 16) % len(self.peers)
        for k in range(len(self.peers)):
            data = self._fetch_one(self.peers[(start + k) % len(self.peers)],
                                   ref)
            if data is not None:
                self._bump("hits")
                self._bump("bytes_fetched", len(data))
                return data
        self._bump("misses")
        return None

    def _fetch_one(self, addr: tuple[str, int], ref: ChunkRef) -> bytes | None:
        try:
            faults.fault_point("peer.fetch", ref.hash)
            with socket.create_connection(addr, timeout=self.timeout_s) as s:
                s.settimeout(self.timeout_s)
                s.sendall(OP_GET + ref.hash.encode("ascii"))
                head = _recv_exact(s, 1)
                if head != ST_HIT:
                    return None
                size = _recv_exact(s, 8)
                if size is None or int.from_bytes(size, "big") != ref.nbytes:
                    return None
                data = _recv_exact(s, ref.nbytes)
        except OSError:
            return None                 # dead/unreachable peer == miss
        if data is None or not chunkstore.chunk_content_ok(ref, data):
            return None
        return data

    def push(self, addr: tuple[str, int], h: str, data) -> bool:
        """Push one chunk to one peer (the eviction-notice seeding path)."""
        try:
            with socket.create_connection(addr, timeout=self.timeout_s) as s:
                s.settimeout(self.timeout_s)
                s.sendall(OP_PUT + h.encode("ascii")
                          + len(data).to_bytes(8, "big"))
                s.sendall(data)
                ok = _recv_exact(s, 1) == ST_OK
        except OSError:
            ok = False
        self._bump("pushes" if ok else "push_failures")
        return ok


class ReadThroughPool(chunkstore.ChunkPool):
    """Chunk resolution for a replacement's restore: local → peers → store.

    Subclasses ``ChunkPool`` and overrides the single ``chunk_path`` hook
    the decode path resolves files through, so every reader/restore code
    path (range-addressed, streaming, zero-copy mmap) gets peer read-through
    without knowing it. A peer hit lands in the local pool first (atomic
    write, no dir fsync — it's a cache) and decodes from there; a miss
    resolves to the shared store's file, where the existing decode path's
    bounded IO retry (``core.retry``) applies. Content addressing makes the
    three sources interchangeable: whatever file the path points at must
    still digest to the ref's address before any byte is trusted.
    """

    def __init__(self, local: chunkstore.ChunkPool, client: PeerChunkClient,
                 shared: chunkstore.ChunkPool):
        super().__init__(local.root)
        self.local = local
        self.client = client
        self.shared = shared
        self.stats = {"local_hits": 0, "peer_hits": 0, "store_reads": 0}
        self._stats_lock = threading.Lock()

    def _bump(self, key: str) -> None:
        with self._stats_lock:
            self.stats[key] += 1

    def _resolve(self, ref: ChunkRef) -> chunkstore.ChunkPool:
        if self.local.check(ref.hash, ref.nbytes):
            self._bump("local_hits")
            return self.local
        data = self.client.fetch(ref)
        if data is not None:
            try:
                self.local.write(ref.hash, data, sync_dir=False)
                self._bump("peer_hits")
                return self.local
            except OSError:
                pass                    # cache write failed: cold-read store
        self._bump("store_reads")
        return self.shared

    def chunk_path(self, ref: ChunkRef) -> str:
        # delegate the hook, not the raw path: a plain pool's chunk_path IS
        # its path, but a backend cache pool (backend.BackendChunkPool) uses
        # chunk_path to fault the chunk in from the object store — composing
        # here gives the full local → peer → object-store resolution order
        return self._resolve(ref).chunk_path(ref)

    def read_view(self, ref: ChunkRef):
        return self._resolve(ref).read_view(ref)

    def check(self, h: str, nbytes: int) -> bool:
        return self.local.check(h, nbytes) or self.shared.check(h, nbytes)

    def touch(self, h: str) -> bool:
        return self.local.touch(h) or self.shared.touch(h)


def warm_restore_from_peers(pool: ReadThroughPool,
                            refs: Iterable[ChunkRef | dict],
                            *, executor=None, batch: int = 32) -> dict:
    """Prefetch a restore's chunks from peers into the local pool.

    Restore-window work: fetch batches run on the scheduler's RESTORE lane
    (they jump queued periodic encodes) and yield between chunks
    (``codec_sched.maybe_yield``), the same preemption discipline every
    chunk loop in the store path follows. Purely an optimization — the
    read-through pool fetches on demand anyway — but prefetching overlaps
    the peer RTTs with manifest parsing and template planning, which is
    where the replacement's MTTR goes. Returns {"warmed", "already_local",
    "missed", "total"}.
    """
    ex = executor if executor is not None else chunkstore.restore_executor()
    crefs = [r if isinstance(r, ChunkRef) else ChunkRef.from_json(r)
             for r in refs]

    def fetch_batch(part: list[ChunkRef]) -> tuple[int, int]:
        warmed = local = 0
        for ref in part:
            codec_sched.maybe_yield()
            if pool.local.check(ref.hash, ref.nbytes):
                local += 1
                continue
            data = pool.client.fetch(ref)
            if data is None:
                continue
            try:
                pool.local.write(ref.hash, data, sync_dir=False)
                warmed += 1
            except OSError:
                pass
        return warmed, local

    futs = [ex.submit(fetch_batch, crefs[i:i + batch])
            for i in range(0, len(crefs), batch)]
    warmed = already = 0
    for f in futs:
        w, a = f.result()
        warmed += w
        already += a
    return {"warmed": warmed, "already_local": already,
            "missed": len(crefs) - warmed - already, "total": len(crefs)}


class FleetPeerExchange:
    """The fleet's exchange fabric: one (local pool, chunk server) pair per
    member, plus the eviction-notice seeding policy.

    The local pools model each member's instance-local storage (NVMe/page
    cache) as distinct directories under ``root`` — caches over the shared
    store, never the durable copy. ``seed_from`` is the notice-window move:
    the evictee pushes its hottest chunks — most recently written first,
    bounded by ``budget_bytes`` sized to what the notice window (AWS
    rebalance ≈120 s) can ship — to every survivor, so whichever member
    restores next finds them a NIC hop away."""

    def __init__(self, root: str, n_members: int, *,
                 budget_bytes: int = 256 << 20, timeout_s: float = 1.0):
        self.root = root
        self.budget_bytes = budget_bytes
        self.timeout_s = timeout_s
        self.members: list[tuple[chunkstore.ChunkPool, PeerChunkServer]] = []
        for i in range(n_members):
            pool = chunkstore.ChunkPool(
                os.path.join(root, f"member{i:02d}", chunkstore.CHUNKS_DIRNAME))
            self.members.append((pool, PeerChunkServer(pool).start()))
        self.stats = {"seed_events": 0, "seeded_chunks": 0, "seeded_bytes": 0}

    def close(self) -> None:
        for _pool, srv in self.members:
            srv.close()

    def addresses(self, *, exclude: int | None = None) -> list[tuple[str, int]]:
        return [srv.address for i, (_p, srv) in enumerate(self.members)
                if i != exclude]

    def client_for(self, member: int) -> PeerChunkClient:
        """A client over everyone *except* ``member`` (you don't fetch from
        yourself — the local pool already answered)."""
        return PeerChunkClient(self.addresses(exclude=member),
                               timeout_s=self.timeout_s)

    def read_through(self, member: int,
                     shared: chunkstore.ChunkPool) -> ReadThroughPool:
        """The pool ``member``'s restore should decode through."""
        return ReadThroughPool(self.members[member][0],
                               self.client_for(member), shared)

    def seed_from(self, evictee: int, source_pool: chunkstore.ChunkPool,
                  hashes: Iterable[str], *,
                  budget_bytes: int | None = None) -> dict:
        """Evictee push during the notice window: hottest chunks first.

        Hotness is write recency (pool mtime — ``touch`` keeps reused
        chunks fresh, so recency tracks the live working set, not just the
        last delta). Pushes stop at the byte budget; every pushed chunk
        goes to *all* survivors, so the seeding survives a second eviction.
        Returns {"chunks", "bytes", "survivors"}.
        """
        budget = self.budget_bytes if budget_bytes is None else budget_bytes
        addrs = self.addresses(exclude=evictee)
        if not addrs:
            return {"chunks": 0, "bytes": 0, "survivors": 0}
        items = []
        for h in hashes:
            try:
                st = os.stat(source_pool.path(h))
            except OSError:
                continue                # swept or never landed: nothing to push
            items.append((st.st_mtime, st.st_size, h))
        items.sort(reverse=True)        # hottest (newest write) first
        client = PeerChunkClient(addrs, timeout_s=self.timeout_s)
        sent = sent_bytes = 0
        for _mt, size, h in items:
            if sent_bytes + size > budget:
                break
            try:
                with open(source_pool.path(h), "rb") as f:
                    data = f.read()
            except OSError:
                continue
            landed = [client.push(addr, h, data) for addr in addrs]
            if any(landed):
                sent += 1
                sent_bytes += len(data)
        self.stats["seed_events"] += 1
        self.stats["seeded_chunks"] += sent
        self.stats["seeded_bytes"] += sent_bytes
        log.info("peer seed: member %d pushed %d chunks (%d bytes) to %d "
                 "survivors", evictee, sent, sent_bytes, len(addrs))
        return {"chunks": sent, "bytes": sent_bytes, "survivors": len(addrs)}
