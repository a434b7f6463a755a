"""The port's object-store chunk backend held against the reference's (twins
of ``tests/test_backend.py``): the in-process object store, round trips,
idempotent uploads, the backend crash-point matrix, the outage spool and
reconcile, and the local -> peer -> object-store resolution order. Each
package activates its own ``FaultPlan`` built the same way; scenario cases
run both packages and compare committed steps, spooled steps and the object
keys the server holds (the chunk addresses).
"""

from __future__ import annotations

import hashlib
import importlib
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

PKG_ROOTS = {"reference": "repro", "port": "repro_torch"}


def _load(root: str) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")
    return SimpleNamespace(faults=importlib.import_module(f"{root}.faults"),
                           checkpoint=mod("checkpoint"),
                           bk=mod("checkpoint.backend"),
                           px=mod("checkpoint.peer_exchange"),
                           chunkstore=mod("checkpoint.chunkstore"),
                           coordinator=mod("core.coordinator"))


PKGS = {name: _load(root) for name, root in PKG_ROOTS.items()}


@pytest.fixture(params=list(PKGS))
def pkg(request):
    return PKGS[request.param]


def make_state(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((64, 33)).astype(np.float32),
        "m": (rng.standard_normal(4096) * 8).astype(np.int32),
        "step": seed,
    }


def template(state: dict) -> dict:
    return {k: (np.zeros_like(v) if isinstance(v, np.ndarray) else 0)
            for k, v in state.items()}


def assert_state_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(np.asarray(got[k]), v)
        else:
            assert got[k] == v


def make_backend_store(pkg, root, *, server=None, part_size=1024, **kw):
    server = server or pkg.bk.InProcessObjectStore()
    backend = pkg.bk.ObjectStoreBackend(server)
    kw.setdefault("chunk_size", 4096)
    kw.setdefault("retention", 5)
    store = pkg.checkpoint.CheckpointStore(str(root), backend=backend, **kw)
    store.pool.part_size = part_size
    return store, server


def tmp_debris(root) -> list:
    return [d for d in os.listdir(root) if ".tmp-" in d]


def object_keys(server) -> list:
    return sorted(k for k in server.objects if k.startswith("chunks/"))


class TestObjectStoreServer:
    def test_put_head_ranged_get(self, pkg):
        s = pkg.bk.InProcessObjectStore()
        s.put("chunks/ab/abcd", b"0123456789")
        assert s.head("chunks/ab/abcd") == 10
        assert s.head("chunks/ab/missing") is None
        assert s.get_range("chunks/ab/abcd", 3, 4) == b"3456"
        with pytest.raises(OSError):
            s.get_range("chunks/ab/missing", 0, 4)

    def test_multipart_assembles_in_part_order(self, pkg):
        s = pkg.bk.InProcessObjectStore()
        uid = s.create_multipart("k")
        s.upload_part("k", uid, 1, b"bbb")
        s.upload_part("k", uid, 0, b"aaa")
        s.complete_multipart("k", uid)
        assert s.get_range("k", 0, 6) == b"aaabbb"

    def test_outage_raises_etimedout(self, pkg):
        s = pkg.bk.InProcessObjectStore()
        s.put("k", b"x")
        s.set_outage(True)
        with pytest.raises(OSError):
            s.head("k")
        s.set_outage(False)
        assert s.head("k") == 1

    def test_object_keys_alike(self):
        h = "ab" * 20
        assert (PKGS["port"].bk.object_key(h)
                == PKGS["reference"].bk.object_key(h))


class TestRoundTrip:
    @pytest.mark.parametrize("mode", ["delta", "full"])
    def test_serial_and_streaming_bit_identical(self, tmp_path, mode):
        keys = {}
        for name, pkg in PKGS.items():
            store, server = make_backend_store(pkg, tmp_path / name, mode=mode)
            s1, s2 = make_state(1), make_state(2)
            store.save(1, s1)
            store.save(2, s2)
            got, man = store.restore(template(s2))
            assert man.step == 2
            assert_state_equal(got, s2)
            got_s, _ = store.restore(template(s2), streaming=True)
            assert_state_equal(got_s, s2)
            got1, man1 = store.restore(template(s1), step=1)
            assert man1.step == 1
            assert_state_equal(got1, s1)
            if mode == "delta":
                assert server.stats["puts"] > 0 and server.stats["parts"] > 0
            keys[name] = object_keys(server)
        # the same chunks under the same object keys
        assert keys["port"] == keys["reference"]

    def test_cold_restore_from_backend_only(self, tmp_path, pkg):
        store, server = make_backend_store(pkg, tmp_path)
        s1 = make_state(7)
        store.save(1, s1)
        shutil.rmtree(store.pool.root)
        fresh, _ = make_backend_store(pkg, tmp_path, server=server)
        got, man = fresh.restore(template(s1))
        assert man.step == 1
        assert_state_equal(got, s1)
        assert fresh.pool.stats["backend_reads"] > 0
        before = server.stats["gets"]
        got_s, _ = fresh.restore(template(s1), streaming=True)
        assert_state_equal(got_s, s1)
        assert fresh.pool.stats["cache_hits"] > 0
        assert server.stats["gets"] == before

    def test_port_objects_restore_in_the_reference(self, tmp_path):
        """Chunks a port store uploaded restore, cold, in a reference store
        over the same object store."""
        port, ref = PKGS["port"], PKGS["reference"]
        store, server = make_backend_store(port, tmp_path / "port")
        s1 = make_state(5)
        store.save(1, s1)
        step_dir = ref.checkpoint.manifest.step_dirname(1)
        shutil.copytree(os.path.join(str(tmp_path / "port"), step_dir),
                        os.path.join(str(tmp_path / "ref"), step_dir))
        fresh, _ = make_backend_store(ref, tmp_path / "ref", server=server)
        got, man = fresh.restore(template(s1))
        assert man.step == 1
        assert_state_equal(got, s1)
        assert fresh.pool.stats["backend_reads"] > 0


class TestIdempotentUpload:
    def test_reput_of_committed_address_is_noop(self, pkg):
        server = pkg.bk.InProcessObjectStore()
        backend = pkg.bk.ObjectStoreBackend(server)
        data = np.random.default_rng(3).bytes(5000)
        h = hashlib.sha1(data).hexdigest()
        key = pkg.bk.object_key(h)
        assert pkg.bk.upload_chunk(backend, h, data, part_size=2048) == len(data)
        gen = server.put_generations[key]
        assert pkg.bk.upload_chunk(backend, h, data, part_size=2048) == 0
        assert server.put_generations[key] == gen

    def test_torn_upload_debris_rewritten_never_appended(self, pkg):
        server = pkg.bk.InProcessObjectStore()
        backend = pkg.bk.ObjectStoreBackend(server)
        data = np.random.default_rng(4).bytes(3000)
        h = hashlib.sha1(data).hexdigest()
        key = pkg.bk.object_key(h)
        server.put(key, data[:100])
        assert pkg.bk.upload_chunk(backend, h, data,
                                   part_size=1 << 20) == len(data)
        assert server.head(key) == len(data)
        assert backend.get_range(key, 0, len(data)) == data


CRASH_CLASS = {
    ("backend.put", "torn"),
    ("backend.put", "crash"),
    ("backend.complete", "rollback"),
    ("backend.complete", "crash"),
}
ABSORBED = {("backend.complete", "eio")}


def _abort_degrade_recover(pkg, root, op, error) -> dict:
    store, server = make_backend_store(pkg, root)
    s1, s2, s3 = make_state(1), make_state(2), make_state(3)
    store.save(1, s1)
    if op == "backend.get":
        shutil.rmtree(store.pool.root)
        fresh, _ = make_backend_store(pkg, root, server=server)
        before = pkg.bk.snapshot_stats()["backend_retries"]
        plan = pkg.faults.FaultPlan().add("backend.get", error=error, count=2)
        with pkg.faults.active(plan):
            got, man = fresh.restore(template(s1))
        assert plan.fired() >= 1 and man.step == 1
        assert_state_equal(got, s1)
        assert pkg.bk.snapshot_stats()["backend_retries"] > before
        return {"outcome": "restored", "committed": fresh.committed_steps()}
    count = 1 if (op, error) in CRASH_CLASS else -1
    plan = pkg.faults.FaultPlan().add(op, error=error, count=count)
    if (op, error) in CRASH_CLASS:
        with pkg.faults.active(plan):
            with pytest.raises(pkg.faults.SimulatedCrash):
                store.save(2, s2)
        outcome = "crashed"
    elif (op, error) in ABSORBED:
        with pkg.faults.active(plan):
            info = store.save(2, s2)
        assert not info.spooled and plan.fired() >= 1
        assert store.committed_steps() == [1, 2]
        got2, _ = store.restore(template(s2))
        assert_state_equal(got2, s2)
        return {"outcome": "absorbed", "committed": store.committed_steps()}
    else:
        with pkg.faults.active(plan):
            info = store.save(2, s2)
        assert info.spooled and store.spooled_steps() == [2]
        assert store.pool.spooled_bytes() > 0
        outcome = "spooled"
    assert plan.fired() >= 1, f"crash point {op}/{error} never hit"
    reopened, _ = make_backend_store(pkg, root, server=server)
    assert reopened.committed_steps() == [1]
    got, man = reopened.restore(template(s1))
    assert man.step == 1
    assert_state_equal(got, s1)
    if outcome == "spooled":
        assert store.reconcile_spooled() == 1
        assert store.committed_steps() == [1, 2]
    store.save(3, s3)
    got3, man3 = store.restore(template(s3))
    assert man3.step == 3
    assert_state_equal(got3, s3)
    assert tmp_debris(root) == []
    return {"outcome": outcome, "committed": store.committed_steps()}


class TestBackendCrashMatrix:
    @pytest.mark.parametrize(
        "op,error", PKGS["reference"].faults.BACKEND_CRASH_POINTS,
        ids=[f"{op}-{error}"
             for op, error in PKGS["reference"].faults.BACKEND_CRASH_POINTS])
    def test_abort_degrade_recover_alike(self, tmp_path, op, error):
        runs = {name: _abort_degrade_recover(pkg, tmp_path / name, op, error)
                for name, pkg in PKGS.items()}
        assert runs["port"] == runs["reference"]


class TestOutageSpoolReconcile:
    def test_end_to_end(self, tmp_path, pkg):
        bk = pkg.bk
        store, server = make_backend_store(pkg, tmp_path)
        s1, s2, s3 = make_state(11), make_state(12), make_state(13)
        stats0 = bk.snapshot_stats()
        store.save(1, s1)
        server.set_outage(True)
        info2 = store.save(2, s2)
        info3 = store.save(3, s3)
        assert info2.spooled and info3.spooled
        assert store.spooled_steps() == [2, 3]
        assert store.committed_steps() == [1]
        stats1 = bk.snapshot_stats()
        assert stats1["backend_outages"] > stats0["backend_outages"]
        assert stats1["spooled_bytes"] > stats0["spooled_bytes"]
        got, man = store.restore(template(s1))
        assert man.step == 1
        assert_state_equal(got, s1)
        server.set_outage(False)
        assert store.reconcile_spooled() == 2
        assert store.committed_steps() == [1, 2, 3]
        assert store.spooled_steps() == [] and store.pool.spooled_bytes() == 0
        shutil.rmtree(store.pool.root)
        fresh, _ = make_backend_store(pkg, tmp_path, server=server)
        got3, man3 = fresh.restore(template(s3))
        assert man3.step == 3
        assert_state_equal(got3, s3)
        got2, man2 = fresh.restore(template(s2), step=2)
        assert man2.step == 2
        assert_state_equal(got2, s2)

    def test_next_save_drains_backlog_first(self, tmp_path, pkg):
        store, server = make_backend_store(pkg, tmp_path)
        server.set_outage(True)
        assert store.save(1, make_state(21)).spooled
        server.set_outage(False)
        assert not store.save(2, make_state(22)).spooled
        assert store.committed_steps() == [1, 2]

    def test_stat_keys_mirror_coordinator_fields(self, pkg):
        st = pkg.coordinator.CoordinatorStats()
        for key in pkg.bk.snapshot_stats():
            assert hasattr(st, key), key


class TestThreeLevelResolution:
    def test_restore_resolves_local_then_peer_then_store(self, tmp_path, pkg):
        store, server = make_backend_store(pkg, tmp_path)
        s1 = make_state(31)
        store.save(1, s1)
        chunks = sorted(store.pool.all_chunks())
        peer = pkg.chunkstore.ChunkPool(str(tmp_path / "peer" / "chunks"))
        for h, path in chunks[: len(chunks) // 2]:
            with open(path, "rb") as f:
                peer.write(h, f.read(), sync_dir=False)
        shutil.rmtree(store.pool.root)
        fresh, _ = make_backend_store(pkg, tmp_path, server=server)
        local = pkg.chunkstore.ChunkPool(str(tmp_path / "local" / "chunks"))
        srv = pkg.px.PeerChunkServer(peer).start()
        try:
            rt = pkg.px.ReadThroughPool(local, pkg.px.PeerChunkClient([srv.address]),
                                        fresh.pool)
            got, man = fresh.restore(template(s1), chunk_pool=rt)
            assert man.step == 1
            assert_state_equal(got, s1)
            assert rt.stats["peer_hits"] > 0 and rt.stats["store_reads"] > 0
            assert fresh.pool.stats["backend_reads"] > 0
            gets = server.stats["gets"]
            got2, _ = fresh.restore(template(s1), chunk_pool=rt)
            assert_state_equal(got2, s1)
            assert rt.stats["local_hits"] > 0
            assert server.stats["gets"] == gets
        finally:
            srv.close()
