"""The port's priority codec scheduler held against the reference's (twins
of ``tests/test_codec_sched.py``): lane order, cooperative yields, shutdown,
restores under a concurrent writer, and the queue-wait/decode split. The
scheduler cases run on a private one-worker scheduler in each package, where
execution order is pop order and so comparable; the store cases run both
packages on the same states and compare the restored bits.

Also here: an urgent save holds a concurrent periodic save's chunk writes
(the port's ``chunkstore.urgent_window``), and the periodic save still
commits afterwards.
"""

from __future__ import annotations

import importlib
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

PKG_ROOTS = {"reference": "repro", "port": "repro_torch"}


def _load(root: str) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")
    return SimpleNamespace(checkpoint=mod("checkpoint"),
                           cs=mod("checkpoint.codec_sched"),
                           chunkstore=mod("checkpoint.chunkstore"),
                           core=mod("core"))


PKGS = {name: _load(root) for name, root in PKG_ROOTS.items()}


@pytest.fixture(params=list(PKGS))
def pkg(request):
    return PKGS[request.param]


def sched1(pkg):
    return pkg.cs.CodecScheduler(max_workers=1)


def lane_order(pkg) -> list:
    cs = pkg.cs
    s = sched1(pkg)
    order = []
    gate = threading.Event()
    futs = [s.submit(cs.PERIODIC, lambda: (gate.wait(5), order.append("gate")))]
    time.sleep(0.05)
    futs.append(s.submit(cs.PERIODIC, lambda: order.append("p1")))
    futs.append(s.submit(cs.RESTORE, lambda: order.append("r1")))
    futs.append(s.submit(cs.URGENT, lambda: order.append("u1")))
    futs.append(s.submit(cs.RESTORE, lambda: order.append("r2")))
    gate.set()
    for f in futs:
        f.result(timeout=5)
    s.shutdown(wait=True, timeout=5)
    return order


class TestPriorityOrder:
    def test_strict_priority_pop_order_alike(self):
        orders = {name: lane_order(pkg) for name, pkg in PKGS.items()}
        assert orders["port"] == orders["reference"] == [
            "gate", "u1", "r1", "r2", "p1"]

    def test_lane_constants_match(self):
        ref, port = PKGS["reference"].cs, PKGS["port"].cs
        assert (port.URGENT, port.RESTORE, port.PERIODIC) == (
            ref.URGENT, ref.RESTORE, ref.PERIODIC)

    def test_fifo_within_lane(self, pkg):
        s = sched1(pkg)
        order = []
        gate = threading.Event()
        futs = [s.submit(pkg.cs.PERIODIC, gate.wait, 5)]
        time.sleep(0.05)
        futs += [s.submit(pkg.cs.RESTORE, lambda i=i: order.append(i))
                 for i in range(5)]
        gate.set()
        for f in futs:
            f.result(timeout=5)
        assert order == list(range(5))
        s.shutdown(wait=True, timeout=5)

    def test_errors_propagate_through_future(self, pkg):
        s = sched1(pkg)

        def boom():
            raise IOError("disk gone")

        with pytest.raises(IOError):
            s.submit(pkg.cs.RESTORE, boom).result(timeout=5)
        s.shutdown(wait=True, timeout=5)

    def test_rejects_unknown_priority(self, pkg):
        s = sched1(pkg)
        with pytest.raises(ValueError):
            s.submit(7, lambda: None)
        s.shutdown(wait=True, timeout=5)


class TestMaybeYield:
    def test_periodic_job_runs_queued_restore_inline(self, pkg):
        cs = pkg.cs
        s = sched1(pkg)
        order = []
        started, queued = threading.Event(), threading.Event()

        def periodic():
            started.set()
            assert queued.wait(5)
            helped = s.maybe_yield()
            order.append("periodic")
            return helped

        fut = s.submit(cs.PERIODIC, periodic)
        assert started.wait(5)
        r = s.submit(cs.RESTORE, lambda: order.append("restore"))
        u = s.submit(cs.URGENT, lambda: order.append("urgent"))
        queued.set()
        assert fut.result(timeout=5) == 2
        r.result(timeout=5)
        u.result(timeout=5)
        assert order == ["urgent", "restore", "periodic"]
        assert s.snapshot_stats()["yields"] == 2
        s.shutdown(wait=True, timeout=5)

    def test_restore_job_never_yields(self, pkg):
        cs = pkg.cs
        s = sched1(pkg)
        ran = []

        def restore_job():
            s.submit(cs.URGENT, lambda: ran.append("urgent"))
            assert s.maybe_yield() == 0
            ran.append("restore")

        s.submit(cs.RESTORE, restore_job).result(timeout=5)
        s.shutdown(wait=True, timeout=5)
        assert ran[0] == "restore"

    def test_noop_off_worker_threads(self, pkg):
        s = sched1(pkg)
        assert s.maybe_yield() == 0
        assert pkg.cs.maybe_yield() == 0
        s.shutdown(wait=True, timeout=5)

    def test_helped_time_excluded_from_periodic_exec(self, pkg):
        cs = pkg.cs
        s = sched1(pkg)
        started, queued = threading.Event(), threading.Event()

        def periodic():
            started.set()
            assert queued.wait(5)
            s.maybe_yield()

        fut = s.submit(cs.PERIODIC, periodic)
        assert started.wait(5)
        r = s.submit(cs.RESTORE, lambda: time.sleep(0.2))
        queued.set()
        fut.result(timeout=5)
        r.result(timeout=5)
        st = s.snapshot_stats()
        assert st["restore"]["exec_s"] >= 0.2
        assert st["periodic"]["exec_s"] < 0.2
        s.shutdown(wait=True, timeout=5)

    def test_stats_keys_alike(self):
        keys = {}
        for name, pkg in PKGS.items():
            s = sched1(pkg)
            keys[name] = sorted(s.snapshot_stats())
            s.shutdown(wait=True, timeout=5)
        assert keys["port"] == keys["reference"]


class TestLifecycle:
    def test_shutdown_cancels_pending_and_joins(self, pkg):
        cs = pkg.cs
        s = sched1(pkg)
        gate = threading.Event()
        running = s.submit(cs.PERIODIC, gate.wait, 5)
        time.sleep(0.05)
        queued = s.submit(cs.PERIODIC, lambda: None)
        gate.set()
        running.result(timeout=5)
        s.shutdown(wait=True, timeout=5, cancel_pending=True)
        assert queued.cancelled() or queued.done()
        with pytest.raises(RuntimeError):
            s.submit(cs.RESTORE, lambda: None)

    def test_shutdown_drains_queued_urgent_jobs(self, pkg):
        cs = pkg.cs
        s = sched1(pkg)
        gate = threading.Event()
        running = s.submit(cs.PERIODIC, gate.wait, 5)
        time.sleep(0.05)
        urgent = s.submit(cs.URGENT, lambda: "committed")
        periodic = s.submit(cs.PERIODIC, lambda: None)
        s.shutdown(wait=False, cancel_pending=True)
        assert urgent.result(timeout=1) == "committed"
        assert periodic.cancelled()
        gate.set()
        running.result(timeout=5)
        s.shutdown(wait=True, timeout=5)

    def test_urgent_submit_after_shutdown_runs_inline(self, pkg):
        s = sched1(pkg)
        s.shutdown(wait=True, timeout=5, cancel_pending=True)
        fut = s.submit(pkg.cs.URGENT, lambda: 7)
        assert fut.done() and fut.result() == 7
        with pytest.raises(RuntimeError):
            s.submit(pkg.cs.PERIODIC, lambda: None)

    def test_urgent_save_after_global_shutdown_commits(self, tmp_path):
        """The atexit race, end to end in the port: the global scheduler is
        already shut down and a termination save still commits, with its
        writes on the urgent IO pool, and restores bit for bit."""
        port = PKGS["port"]
        cs = port.cs
        cs._reset_for_tests()
        try:
            cs.scheduler().shutdown(wait=True, timeout=5.0, cancel_pending=True)
            store = port.checkpoint.CheckpointStore(str(tmp_path), mode="delta")
            ckpt = port.checkpoint.AsyncCheckpointer(store)
            s = _state(3)
            info = ckpt.save_urgent(3, s, timeout_s=60)
            assert info is not None and info.step == 3
            assert store.committed_steps() == [3]
        finally:
            cs._reset_for_tests()
        got, man = store.restore(_template(s))
        assert man.step == 3
        for a, b in zip(_leaves(got), _leaves(s)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_global_scheduler_is_singleton_and_lanes_share_it(self, pkg):
        cs = pkg.cs
        a, b = cs.scheduler(), cs.scheduler()
        assert a is b
        lane = cs.lane(cs.RESTORE)
        assert isinstance(lane, cs.CodecLane)
        assert lane.scheduler is a and lane.priority == cs.RESTORE


def _state(step, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": rng.standard_normal((256, 256)).astype(np.float32),
                   "b": rng.standard_normal((256,)).astype(np.float32)},
        "opt": {"mu": {"w": rng.standard_normal((256, 256)).astype(np.float32)}},
        "step": step,
    }


def _template(s):
    if isinstance(s, dict):
        return {k: _template(v) for k, v in s.items()}
    return np.zeros(s.shape, s.dtype) if hasattr(s, "shape") else s


def _leaves(s) -> list:
    if isinstance(s, dict):
        return [x for k in sorted(s) for x in _leaves(s[k])]
    return [s]


class TestContendedCorrectness:
    @pytest.mark.parametrize("mode", ["delta", "full"])
    def test_restore_bit_identical_under_concurrent_writer(self, tmp_path,
                                                           pkg, mode):
        store = pkg.checkpoint.CheckpointStore(str(tmp_path / "a"), mode=mode,
                                               retention=100)
        expect = _state(1, seed=1)
        store.save(1, expect)
        stop = threading.Event()
        errs = []

        def writer():
            wstore = pkg.checkpoint.CheckpointStore(str(tmp_path / "b"),
                                                    mode=mode, retention=4)
            i = 0
            try:
                while not stop.is_set():
                    i += 1
                    wstore.save(i, _state(i, seed=i))
            except BaseException as e:
                errs.append(e)

        t = threading.Thread(target=writer, daemon=True)
        t.start()
        try:
            for _ in range(3):
                got, man = store.restore(_template(expect))
                assert man.step == 1
                for a, b in zip(_leaves(got), _leaves(expect)):
                    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        finally:
            stop.set()
            t.join(timeout=30)
        assert not errs

    def test_yielded_periodic_saves_commit_the_same_chunks(self, tmp_path):
        """Periodic saves interleaved with restores commit valid manifests,
        and both packages pool the same chunks for the same states."""
        pools = {}
        for name, pkg in PKGS.items():
            store = pkg.checkpoint.CheckpointStore(str(tmp_path / name),
                                                   mode="delta", retention=100)
            base = _state(1, seed=1)
            store.save(1, base)
            stop = threading.Event()
            errs = []

            def restorer():
                try:
                    while not stop.is_set():
                        _got, man = store.restore(_template(base))
                        assert man.step >= 1
                except BaseException as e:
                    errs.append(e)

            t = threading.Thread(target=restorer, daemon=True)
            t.start()
            try:
                for i in range(2, 5):
                    store.save(i, _state(i, seed=i))
            finally:
                stop.set()
                t.join(timeout=30)
            assert not errs
            assert store.committed_steps() == [1, 2, 3, 4]
            got, man = store.restore(_template(base))
            assert man.step == 4
            for a, b in zip(_leaves(got), _leaves(_state(4, seed=4))):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            pools[name] = sorted(h for h, _p in store.pool.all_chunks())
        assert pools["port"] == pools["reference"]


class TestUrgentWindow:
    def test_periodic_chunks_hold_while_an_urgent_save_writes(self, tmp_path):
        """While an urgent window is open a periodic save writes no chunk;
        it commits once the window closes."""
        port = PKGS["port"]
        cs = port.chunkstore
        store = port.checkpoint.CheckpointStore(str(tmp_path), mode="delta",
                                                chunk_size=4096)
        done = threading.Event()
        errs = []

        def periodic():
            try:
                store.save(1, _state(1, seed=1))
            except BaseException as e:
                errs.append(e)
            done.set()

        with cs.urgent_window():
            t = threading.Thread(target=periodic, daemon=True)
            t.start()
            time.sleep(0.3)
            assert not done.is_set()
            assert sum(1 for _ in store.pool.all_chunks()) == 0
        assert done.wait(30)
        t.join(timeout=5)
        assert not errs and store.committed_steps() == [1]


class TestLedgerSplit:
    def test_restore_latest_splits_queue_wait_from_decode(self, tmp_path):
        charged = {}
        for name, pkg in PKGS.items():
            core = pkg.core
            clock = core.VirtualClock()
            store = pkg.checkpoint.CheckpointStore(str(tmp_path / name),
                                                   time_fn=clock.now)
            coord = core.SpotOnCoordinator(store,
                                           core.CheckpointPolicy.transparent(1e9),
                                           clock, time_model=core.TimeModel())
            s = _state(3)
            store.save(3, s)
            assert coord.restore_latest(_template(s)) is not None
            assert len(coord.ledger.observed["restore_queue_wait"]) == 1
            assert len(coord.ledger.observed["restore_decode"]) == 1
            assert coord.stats.restore_decode_s > 0.0
            assert coord.stats.restore_queue_wait_s >= 0.0
            assert coord.ledger.charged["restore_wall"] > 0.0
            charged[name] = coord.ledger.charged["restore"]
            coord.close()
        # the modeled read cost is charged on the same bytes in both
        assert charged["port"] == charged["reference"]
