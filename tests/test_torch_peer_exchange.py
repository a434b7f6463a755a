"""The port's peer-to-peer chunk exchange held against the reference's
(twins of ``tests/test_peer_exchange.py``).

The wire protocol is kept byte for byte, so every protocol case runs over
each pairing of server and client package: the port against itself, and a
reference client fetching from a port server and the other way round. The
fault sites keep their names (``peer.send``, ``peer.fetch``): each package
activates its own ``FaultPlan``, built the same way. The read-through,
warm-prefetch and seeding cases run both packages on the same state and
compare the restored bits and the peer counters.

Not twinned here: the spotlint lane-discipline cases (they need the port's
own copy of the analyzer); the multihost restore barrier's twins are in
``tests/test_torch_multihost.py``.
"""

from __future__ import annotations

import importlib
import os
import socket
import time
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

PKG_ROOTS = {"reference": "repro", "port": "repro_torch"}


def _load(root: str) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")
    return SimpleNamespace(
        name=root, faults=importlib.import_module(f"{root}.faults"),
        checkpoint=mod("checkpoint"), chunkstore=mod("checkpoint.chunkstore"),
        px=mod("checkpoint.peer_exchange"), core=mod("core"))


PKGS = {name: _load(root) for name, root in PKG_ROOTS.items()}
PAIRS = [("port", "port"), ("port", "reference"), ("reference", "port")]


@pytest.fixture(params=list(PKGS))
def pkg(request):
    return PKGS[request.param]


@pytest.fixture(params=PAIRS, ids=[f"{s}-server-{c}-client" for s, c in PAIRS])
def pair(request):
    server, client = request.param
    return PKGS[server], PKGS[client]


def seed_chunks(pkg, pool, rng, n=4, size=4096):
    refs = []
    for _ in range(n):
        raw = rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
        ref, _n, _rd = pkg.chunkstore.store_chunk(pool, raw, comp="zlib")
        refs.append(ref)
    return refs


def as_ref(pkg, ref):
    """``ref`` as the given package's ChunkRef (the same five fields)."""
    return pkg.chunkstore.ChunkRef.from_json(ref.to_json())


def wait_for(cond, timeout_s=5.0) -> bool:
    """Poll ``cond`` until it holds or the time limit passes: a server
    counts a hit on its own thread, after the client has its bytes."""
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.005)
    return True


@pytest.fixture
def fabric(tmp_path, pair):
    server_pkg, client_pkg = pair
    pool = server_pkg.chunkstore.ChunkPool(str(tmp_path / "peer" / "chunks"))
    srv = server_pkg.px.PeerChunkServer(pool).start()
    yield server_pkg, client_pkg, pool, srv
    srv.close()


class TestProtocol:
    def test_get_round_trip(self, fabric, rng):
        server_pkg, client_pkg, pool, srv = fabric
        refs = seed_chunks(server_pkg, pool, rng)
        client = client_pkg.px.PeerChunkClient([srv.address])
        for ref in refs:
            data = client.fetch(as_ref(client_pkg, ref))
            assert data is not None
            assert client_pkg.chunkstore.chunk_content_ok(
                as_ref(client_pkg, ref), data)
            assert data == pool.read(ref)
        assert client.stats["hits"] == len(refs)
        assert wait_for(lambda: srv.stats["get_hits"] == len(refs))
        assert srv.stats["bytes_served"] == sum(r.nbytes for r in refs)

    def test_get_miss(self, fabric):
        _s, client_pkg, _pool, srv = fabric
        client = client_pkg.px.PeerChunkClient([srv.address])
        ghost = client_pkg.chunkstore.ChunkRef(hash="ab" * 20, nbytes=64,
                                               raw_len=64, crc32=0, comp="raw")
        assert client.fetch(ghost) is None
        assert client.stats["misses"] == 1
        assert wait_for(lambda: srv.stats["get_misses"] == 1)

    def test_put_lands_and_bad_digest_rejected(self, fabric):
        _s, client_pkg, pool, srv = fabric
        client = client_pkg.px.PeerChunkClient([srv.address])
        data = b"peer-seeded chunk payload" * 64
        h = client_pkg.chunkstore.chunk_digest(data)
        assert client.push(srv.address, h, data)
        assert pool.check(h, len(data))
        assert not client.push(srv.address, "00" * 20, data)
        assert not pool.check("00" * 20, len(data))
        assert client.stats["pushes"] == 1
        assert client.stats["push_failures"] == 1

    def test_fetch_falls_through_to_second_peer(self, tmp_path, pair, rng):
        server_pkg, client_pkg = pair
        empty = server_pkg.chunkstore.ChunkPool(str(tmp_path / "a" / "chunks"))
        full = server_pkg.chunkstore.ChunkPool(str(tmp_path / "b" / "chunks"))
        refs = seed_chunks(server_pkg, full, rng, n=3)
        sa = server_pkg.px.PeerChunkServer(empty).start()
        sb = server_pkg.px.PeerChunkServer(full).start()
        try:
            client = client_pkg.px.PeerChunkClient([sa.address, sb.address])
            for ref in refs:
                assert client.fetch(as_ref(client_pkg, ref)) == full.read(ref)
        finally:
            sa.close()
            sb.close()

    def test_dead_peer_is_a_miss_not_an_error(self, pkg):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()
        s.close()
        client = pkg.px.PeerChunkClient([dead], timeout_s=0.2)
        ghost = pkg.chunkstore.ChunkRef(hash="cd" * 20, nbytes=64, raw_len=64,
                                        crc32=0, comp="raw")
        assert client.fetch(ghost) is None
        assert client.stats["misses"] == 1

    def test_wire_constants_match(self):
        ref, port = PKGS["reference"].px, PKGS["port"].px
        for k in ("HASH_LEN", "OP_GET", "OP_PUT", "ST_HIT", "ST_MISS", "ST_OK",
                  "ST_ERR", "MAX_CHUNK_BYTES"):
            assert getattr(port, k) == getattr(ref, k), k


def make_store(pkg, root, rng_seed=0, *, elems=8192):
    rng = np.random.default_rng(rng_seed)
    store = pkg.checkpoint.CheckpointStore(str(root / "store"))
    state = {"w": rng.normal(size=(elems,)).astype(np.float32),
             "b": rng.normal(size=(257,)).astype(np.float32)}
    store.save(1, state)
    return store, state


def copy_pool(src, dst) -> None:
    for h, path in src.all_chunks():
        with open(path, "rb") as f:
            dst.write(h, f.read(), sync_dir=False)


def manifest_refs(pkg, store):
    man, reader = store.latest_valid()
    reader.close()
    refs = {}
    for rec in man.tensors:
        for c in rec.get("chunks", ()):
            refs.setdefault(c["h"], pkg.chunkstore.ChunkRef.from_json(c))
    return list(refs.values())


def template(state):
    return {k: np.zeros_like(v) for k, v in state.items()}


def assert_restored(got, state):
    for k in state:
        np.testing.assert_array_equal(np.asarray(got[k]), state[k])


def _read_through(pkg, root, store, *, seed_peer=True):
    cs = pkg.chunkstore
    local = cs.ChunkPool(str(root / "local" / "chunks"))
    peer = cs.ChunkPool(str(root / "peer" / "chunks"))
    if seed_peer:
        copy_pool(store.pool, peer)
    srv = pkg.px.PeerChunkServer(peer).start()
    client = pkg.px.PeerChunkClient([srv.address])
    return pkg.px.ReadThroughPool(local, client, store.pool), srv


class TestReadThrough:
    @pytest.mark.parametrize("streaming", [False, True])
    def test_restore_warm_from_peer_bit_identical(self, tmp_path, streaming):
        stats = {}
        for name, pkg in PKGS.items():
            store, state = make_store(pkg, tmp_path / name)
            rt, srv = _read_through(pkg, tmp_path / name, store)
            try:
                got, _ = store.restore(template(state), streaming=streaming,
                                       chunk_pool=rt)
                assert_restored(got, state)
                assert rt.stats["peer_hits"] > 0
                assert rt.stats["store_reads"] == 0
                got2, _ = store.restore(template(state), streaming=streaming,
                                        chunk_pool=rt)
                assert rt.stats["local_hits"] > 0
                assert_restored(got2, state)
                stats[name] = dict(rt.stats)
            finally:
                srv.close()
        assert stats["port"] == stats["reference"]

    def test_empty_peer_falls_back_to_store(self, tmp_path, pkg):
        store, state = make_store(pkg, tmp_path)
        rt, srv = _read_through(pkg, tmp_path, store, seed_peer=False)
        try:
            got, _ = store.restore(template(state), chunk_pool=rt)
            assert_restored(got, state)
            assert rt.stats["store_reads"] > 0
            assert rt.stats["peer_hits"] == 0
        finally:
            srv.close()

    def test_port_restores_through_a_reference_peer(self, tmp_path):
        """A port replacement reads through a reference member's server."""
        ref, port = PKGS["reference"], PKGS["port"]
        store, state = make_store(port, tmp_path)
        peer = ref.chunkstore.ChunkPool(str(tmp_path / "peer" / "chunks"))
        copy_pool(store.pool, peer)
        srv = ref.px.PeerChunkServer(peer).start()
        try:
            local = port.chunkstore.ChunkPool(str(tmp_path / "local" / "chunks"))
            rt = port.px.ReadThroughPool(
                local, port.px.PeerChunkClient([srv.address]), store.pool)
            got, _ = store.restore(template(state), chunk_pool=rt)
            assert_restored(got, state)
            assert rt.stats["peer_hits"] > 0 and rt.stats["store_reads"] == 0
        finally:
            srv.close()


class TestWarmPrefetch:
    def test_warm_restore_from_peers(self, tmp_path):
        results = {}
        for name, pkg in PKGS.items():
            store, state = make_store(pkg, tmp_path / name)
            rt, srv = _read_through(pkg, tmp_path / name, store)
            try:
                refs = manifest_refs(pkg, store)
                assert refs
                res = pkg.px.warm_restore_from_peers(rt, refs, batch=2)
                assert res["warmed"] == len(refs) and res["missed"] == 0
                res2 = pkg.px.warm_restore_from_peers(rt, refs)
                assert res2["already_local"] == len(refs)
                got, _ = store.restore(template(state), chunk_pool=rt)
                assert_restored(got, state)
                assert rt.stats["store_reads"] == 0
                results[name] = (res, res2, sorted(r.hash for r in refs))
            finally:
                srv.close()
        # same chunk addresses, same prefetch counts in both packages
        assert results["port"] == results["reference"]


class TestPeerFaults:
    def test_peer_dies_mid_transfer_store_fallback_bit_identical(
            self, tmp_path, pkg):
        store, state = make_store(pkg, tmp_path)
        cs = pkg.chunkstore
        local = cs.ChunkPool(str(tmp_path / "local" / "chunks"))
        peer = cs.ChunkPool(str(tmp_path / "peer" / "chunks"))
        copy_pool(store.pool, peer)
        srv = pkg.px.PeerChunkServer(peer).start()
        try:
            client = pkg.px.PeerChunkClient([srv.address], timeout_s=0.5)
            rt = pkg.px.ReadThroughPool(local, client, store.pool)
            plan = pkg.faults.FaultPlan().add("peer.send", nth=1, count=-1,
                                              error="crash")
            with pkg.faults.active(plan):
                got, _ = store.restore(template(state), chunk_pool=rt)
            assert plan.fired()
            assert_restored(got, state)
            assert rt.stats["store_reads"] > 0
            assert rt.stats["peer_hits"] == 0
        finally:
            srv.close()

    def test_unreachable_peer_fault_store_fallback(self, tmp_path, pkg):
        store, state = make_store(pkg, tmp_path)
        rt, srv = _read_through(pkg, tmp_path, store, seed_peer=False)
        try:
            plan = pkg.faults.FaultPlan().add("peer.fetch", nth=1, count=-1,
                                              error="etimedout")
            with pkg.faults.active(plan):
                got, _ = store.restore(template(state), chunk_pool=rt)
            assert plan.fired()
            assert_restored(got, state)
            assert rt.stats["store_reads"] > 0
        finally:
            srv.close()

    def test_partial_peer_loss_still_warms_from_survivor(self, tmp_path, pair):
        """The first peer dies mid-transfer on every fetch (a fault planned
        in the server's package), the second answers."""
        server_pkg, client_pkg = pair
        store, state = make_store(server_pkg, tmp_path)
        servers = []
        for name in ("a", "b"):
            p = server_pkg.chunkstore.ChunkPool(str(tmp_path / name / "chunks"))
            copy_pool(store.pool, p)
            servers.append(server_pkg.px.PeerChunkServer(p).start())
        try:
            plan = server_pkg.faults.FaultPlan().add(
                "peer.send", nth=1, count=-1, error="crash",
                path_substr=servers[0].pool.root)
            client = client_pkg.px.PeerChunkClient(
                [s.address for s in servers], timeout_s=0.5)
            refs = manifest_refs(client_pkg, store)
            with server_pkg.faults.active(plan):
                for ref in refs:
                    data = client.fetch(ref)
                    assert data is not None
                    assert client_pkg.chunkstore.chunk_content_ok(ref, data)
            assert client.stats["hits"] == len(refs)
        finally:
            for s in servers:
                s.close()


def _seeding_fleet(pkg, root):
    core = pkg.core
    clock = core.VirtualClock()
    store = pkg.checkpoint.CheckpointStore(str(root / "store"),
                                           time_fn=clock.now)
    exchange = pkg.px.FleetPeerExchange(str(root / "fabric"), 3)
    try:
        spec = core.FleetSpec(providers=("aws", "gcp", "azure"),
                              schedules=(core.PeriodicEviction(150.0),
                                         core.NoEviction(), core.NoEviction()),
                              provisioning_delay_s=60.0)
        fleet = core.FleetCoordinator(store,
                                      core.CheckpointPolicy.transparent(100.0),
                                      clock, spec, time_model=core.TimeModel(),
                                      peer_exchange=exchange)
        rep = fleet.run(total_steps=40, step_time_s=10.0)
        assert rep.completed
        assert fleet.peer_seed_events, "eviction notice never seeded peers"
        ev = fleet.peer_seed_events[0]
        assert ev["survivors"] == 2 and ev["chunks"] > 0
        assert rep.checkpoints["peer_seed_events"] == len(fleet.peer_seed_events)
        assert rep.checkpoints["peer_seeded_chunks"] > 0
        assert rep.checkpoints["peer_seeded_bytes"] > 0
        seeded = [sorted(h for h, _p in pool.all_chunks())
                  for i, (pool, _srv) in enumerate(exchange.members)
                  if i != ev["member"]]
        assert all(seeded)
        return ({k: ev[k] for k in ("member", "step", "chunks", "bytes",
                                    "survivors")}, seeded)
    finally:
        exchange.close()


class TestFleetSeeding:
    def test_notice_window_seeds_survivors_alike(self, tmp_path):
        runs = {name: _seeding_fleet(pkg, tmp_path / name)
                for name, pkg in PKGS.items()}
        # the same checkpoint's chunks, pushed to the same survivors
        assert runs["port"] == runs["reference"]

    def test_seed_budget_takes_newest_first(self, tmp_path, pkg):
        """Under a budget of two chunks' bytes the evictee pushes the two
        most recently written, to every survivor."""
        cs = pkg.chunkstore
        src = cs.ChunkPool(str(tmp_path / "src" / "chunks"))
        hashes = []
        for i in range(4):
            data = bytes([i]) * 1000
            h = cs.chunk_digest(data)
            src.write(h, data)
            os.utime(src.path(h), (1000.0 + i, 1000.0 + i))
            hashes.append(h)
        exchange = pkg.px.FleetPeerExchange(str(tmp_path / "fabric"), 3)
        try:
            res = exchange.seed_from(0, src, hashes, budget_bytes=2000)
            assert res == {"chunks": 2, "bytes": 2000, "survivors": 2}
            for pool, _srv in exchange.members[1:]:
                assert sorted(h for h, _p in pool.all_chunks()) == sorted(
                    hashes[2:])
        finally:
            exchange.close()

    def test_rescale_events_carry_fingerprint_counts(self, tmp_path, pkg):
        core = pkg.core
        clock = core.VirtualClock()
        store = pkg.checkpoint.CheckpointStore(str(tmp_path / "store"),
                                               time_fn=clock.now)
        spec = core.FleetSpec(providers=("aws", "gcp"),
                              schedules=(core.PeriodicEviction(200.0),
                                         core.NoEviction()),
                              provisioning_delay_s=60.0)
        fleet = core.FleetCoordinator(store,
                                      core.CheckpointPolicy.transparent(100.0),
                                      clock, spec, time_model=core.TimeModel())
        rep = fleet.run(total_steps=40, step_time_s=10.0)
        assert rep.completed
        planned = [ev for ev in fleet.rescale_events if "mesh_shape" in ev]
        assert planned
        for ev in planned:
            assert "fingerprints_kept" in ev and "fingerprints_dropped" in ev
