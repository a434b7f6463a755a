"""The port's ``SpotOnCoordinator`` held against the reference's (twins of
``tests/test_coordinator.py``): the paper's policy contract, deadline edges,
application and off modes, and latest-valid restore. Each case runs in both
packages on the same clock schedule and states; the scenario cases compare
the coordinators' counters, the committed steps and the manifests' kinds.

Also here: the urgent save's legs, which only the port records — wall legs
that partition the save's wall time, and the codec workers' busy seconds.
"""

from __future__ import annotations

import importlib
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

PKG_ROOTS = {"reference": "repro", "port": "repro_torch"}


def _load(root: str) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")
    return SimpleNamespace(checkpoint=mod("checkpoint"), core=mod("core"),
                           coordinator=mod("core.coordinator"))


PKGS = {name: _load(root) for name, root in PKG_ROOTS.items()}


@pytest.fixture(params=list(PKGS))
def pkg(request):
    return PKGS[request.param]


def state(step):
    return {"w": np.full((16,), float(step), np.float32), "step": step}


def make(pkg, root, policy, tm=None):
    core = pkg.core
    clock = core.VirtualClock()
    store = pkg.checkpoint.CheckpointStore(str(root), time_fn=clock.now)
    coord = core.SpotOnCoordinator(store, policy(core.CheckpointPolicy), clock,
                                   time_model=tm(core) if tm else core.TimeModel())
    md = core.SimulatedMetadataService(clock, "vm-0")
    coord.attach_instance(md, "vm-0")
    return coord, md, clock, store


def counters(coord, store) -> dict:
    s = coord.stats
    return {"periodic": s.periodic_ckpts, "termination": s.termination_ckpts,
            "termination_failures": s.termination_failures,
            "stage": s.stage_ckpts, "restores": s.restores,
            "committed": store.committed_steps()}


def both(tmp_path, scenario) -> dict:
    """Run ``scenario(pkg, root)`` in both packages; the port's result must
    equal the reference's."""
    runs = {name: scenario(pkg, tmp_path / name) for name, pkg in PKGS.items()}
    assert runs["port"] == runs["reference"]
    return runs["port"]


def transparent(s):
    return lambda P: P.transparent(s)


class TestTransparent:
    def test_periodic_cadence(self, tmp_path):
        def run(pkg, root):
            coord, md, clock, store = make(pkg, root, transparent(100.0))
            for step in range(1, 31):
                clock.advance(10.0)
                coord.on_step_end(step, lambda s=step: state(s))
            coord.flush()
            coord.close()
            return counters(coord, store)
        got = both(tmp_path, run)
        assert got["periodic"] == pytest.approx(3, abs=1)

    def test_termination_checkpoint_on_preempt(self, tmp_path):
        def run(pkg, root):
            coord, md, clock, store = make(pkg, root, transparent(1e9))
            md.simulate_eviction()
            clock.advance(2.0)
            sig = coord.on_step_end(7, lambda: state(7))
            assert sig is pkg.core.Signal.PREEMPTING
            got, man = store.restore(state(0))
            coord.close()
            return {**counters(coord, store), "kind": man.kind,
                    "step": got["step"]}
        got = both(tmp_path, run)
        assert got["termination"] == 1
        assert got["kind"] == "termination" and got["step"] == 7

    def test_termination_missing_window_fails_gracefully(self, tmp_path):
        def run(pkg, root):
            coord, md, clock, store = make(
                pkg, root, transparent(1e9),
                tm=lambda c: c.TimeModel(write_bw=1.0, latency_s=1000.0))
            md.simulate_eviction()
            clock.advance(1.0)
            assert coord.on_step_end(3, lambda: state(3)) is pkg.core.Signal.PREEMPTING
            coord.close()
            return counters(coord, store)
        assert both(tmp_path, run)["termination_failures"] == 1

    def test_same_event_handled_once(self, tmp_path, pkg):
        coord, md, clock, store = make(pkg, tmp_path, transparent(1e9))
        md.simulate_eviction()
        clock.advance(2.0)
        assert coord.on_step_end(1, lambda: state(1)) is pkg.core.Signal.PREEMPTING
        clock.advance(2.0)
        assert coord.on_step_end(2, lambda: state(2)) is pkg.core.Signal.CONTINUE
        coord.close()


class TestDeadlineEdges:
    def test_zero_budget_fails_without_write(self, tmp_path):
        def run(pkg, root):
            coord, md, clock, store = make(pkg, root, transparent(1e9))
            ev = md.schedule_preempt(notice_s=30.0)
            clock.advance(ev.not_before - clock.now())
            assert coord.on_step_end(5, lambda: state(5)) is pkg.core.Signal.PREEMPTING
            coord.close()
            return counters(coord, store)
        got = both(tmp_path, run)
        assert got["termination_failures"] == 1 and got["termination"] == 0
        assert got["committed"] == []

    def test_negative_budget_fails_without_write(self, tmp_path):
        def run(pkg, root):
            coord, md, clock, store = make(pkg, root, transparent(1e9))
            md.schedule_preempt(notice_s=30.0)
            clock.advance(90.0)
            assert coord.on_step_end(5, lambda: state(5)) is pkg.core.Signal.PREEMPTING
            coord.close()
            return counters(coord, store)
        got = both(tmp_path, run)
        assert got["termination_failures"] == 1 and got["committed"] == []

    def test_virtual_cost_exceeding_window_charges_only_budget(self, tmp_path):
        def run(pkg, root):
            coord, md, clock, store = make(
                pkg, root, transparent(1e9),
                tm=lambda c: c.TimeModel(write_bw=1.0, latency_s=500.0))
            ev = md.simulate_eviction()
            clock.advance(2.0)
            t_before = clock.now()
            budget = ev.not_before - t_before
            assert coord.on_step_end(3, lambda: state(3)) is pkg.core.Signal.PREEMPTING
            assert clock.now() - t_before == pytest.approx(budget)
            coord.close()
            return {**counters(coord, store), "charged": clock.now() - t_before}
        assert both(tmp_path, run)["termination_failures"] == 1

    def test_duplicate_event_id_suppressed(self, tmp_path):
        def run(pkg, root):
            coord, md, clock, store = make(pkg, root, transparent(1e9))
            md.simulate_eviction()
            clock.advance(2.0)
            sigs = [coord.on_step_end(1, lambda: state(1))]
            for step in (2, 3, 4):
                clock.advance(2.0)
                sigs.append(coord.on_step_end(step, lambda s=step: state(s)))
            coord.close()
            return {**counters(coord, store), "signals": [s.name for s in sigs]}
        got = both(tmp_path, run)
        assert got["signals"] == ["PREEMPTING"] + ["CONTINUE"] * 3
        assert got["termination"] == 1

    def test_distinct_event_handled_separately(self, tmp_path):
        def run(pkg, root):
            coord, md, clock, store = make(pkg, root, transparent(1e9))
            md.simulate_eviction()
            clock.advance(2.0)
            assert coord.on_step_end(1, lambda: state(1)) is pkg.core.Signal.PREEMPTING
            md.clear()
            md.simulate_eviction()
            clock.advance(2.0)
            assert coord.on_step_end(2, lambda: state(2)) is pkg.core.Signal.PREEMPTING
            coord.close()
            return counters(coord, store)
        assert both(tmp_path, run)["termination"] == 2


class TestApplication:
    def test_cannot_checkpoint_on_demand(self, tmp_path):
        def run(pkg, root):
            coord, md, clock, store = make(pkg, root, lambda P: P.application())
            md.simulate_eviction()
            clock.advance(2.0)
            assert coord.on_step_end(9, lambda: state(9)) is pkg.core.Signal.PREEMPTING
            coord.close()
            return counters(coord, store)
        got = both(tmp_path, run)
        assert got["termination"] == 0 and got["committed"] == []

    def test_stage_boundary_checkpoints(self, tmp_path):
        def run(pkg, root):
            coord, md, clock, store = make(pkg, root, lambda P: P.application())
            coord.on_stage_end(0, 100, state(100))
            got, man = store.restore(state(0))
            coord.close()
            return {**counters(coord, store), "kind": man.kind,
                    "stage": man.extra["stage"], "step": got["step"]}
        got = both(tmp_path, run)
        assert got["stage"] == 0 and got["kind"] == "application"
        assert got["step"] == 100

    def test_no_periodic(self, tmp_path, pkg):
        coord, md, clock, store = make(pkg, tmp_path, lambda P: P.application())
        for step in range(1, 50):
            clock.advance(60.0)
            coord.on_step_end(step, lambda s=step: state(s))
        coord.flush()
        assert coord.stats.periodic_ckpts == 0
        coord.close()


class TestOff:
    def test_nothing_saved(self, tmp_path, pkg):
        coord, md, clock, store = make(pkg, tmp_path, lambda P: P.off())
        md.simulate_eviction()
        clock.advance(2.0)
        assert coord.on_step_end(1, lambda: state(1)) is pkg.core.Signal.PREEMPTING
        coord.on_stage_end(0, 1, state(1))
        coord.flush()
        assert store.committed_steps() == []
        coord.close()


class TestRestore:
    def test_restore_latest_valid(self, tmp_path):
        def run(pkg, root):
            coord, md, clock, store = make(pkg, root, transparent(1.0))
            store.save(4, state(4))
            store.save(8, state(8))
            got, man = coord.restore_latest(state(0))
            coord.close()
            return {**counters(coord, store), "step": got["step"]}
        got = both(tmp_path, run)
        assert got["step"] == 8 and got["restores"] == 1

    def test_restore_none_when_empty(self, tmp_path, pkg):
        coord, md, clock, store = make(pkg, tmp_path, transparent(1.0))
        assert coord.restore_latest(state(0)) is None
        coord.close()

    def test_stats_fields_match(self):
        ref = set(PKGS["reference"].coordinator.CoordinatorStats.__dataclass_fields__)
        port = set(PKGS["port"].coordinator.CoordinatorStats.__dataclass_fields__)
        assert port == ref


class TestUrgentLegs:
    """The port records each committed urgent save's legs."""

    @pytest.mark.parametrize("async_writes", [True, False])
    def test_wall_legs_partition_the_wall_time(self, tmp_path, async_writes):
        port = PKGS["port"]
        core = port.core
        coord, md, clock, store = make(
            port, tmp_path,
            lambda P: P(periodic_interval_s=1e9, async_writes=async_writes))
        big = {"w": np.random.default_rng(0).standard_normal(
            (512, 1024)).astype(np.float32), "step": 3}
        md.simulate_eviction()
        clock.advance(2.0)
        assert coord.on_step_end(3, lambda: big) is core.Signal.PREEMPTING
        legs = coord.last_urgent_legs
        coord.close()
        walls = port.coordinator.URGENT_WALL_LEGS
        assert set(walls) <= set(legs)
        assert legs["other_s"] >= 0.0
        parts = sum(legs[k] for k in walls) + legs["other_s"]
        assert parts == pytest.approx(legs["wall_s"], rel=1e-9, abs=1e-9)
        # the chunk leg is where the bytes went; its workers were busy
        assert legs["chunks_s"] > 0 and legs["hash_busy_s"] > 0
        assert legs["write_busy_s"] > 0 and legs["fsync_busy_s"] > 0

    def test_failed_urgent_save_records_no_legs(self, tmp_path):
        port = PKGS["port"]
        coord, md, clock, store = make(
            port, tmp_path, transparent(1e9),
            tm=lambda c: c.TimeModel(write_bw=1.0, latency_s=1000.0))
        md.simulate_eviction()
        clock.advance(1.0)
        coord.on_step_end(3, lambda: state(3))
        assert coord.stats.termination_failures == 1
        assert coord.last_urgent_legs == {}
        coord.close()

    @pytest.mark.parametrize("fail", [False, True])
    def test_each_urgent_save_is_recorded(self, tmp_path, fail):
        """Committed or not, an urgent save leaves its step, its notice
        budget, its wall seconds, its outcome and its legs."""
        port = PKGS["port"]
        tm = (lambda c: c.TimeModel(write_bw=1.0, latency_s=1000.0)) \
            if fail else None
        coord, md, clock, store = make(port, tmp_path, transparent(1e9),
                                       tm=tm)
        md.simulate_eviction()
        clock.advance(1.0)
        coord.on_step_end(3, lambda: state(3))
        coord.close()
        [rec] = coord.urgent_saves
        assert (rec["step"], rec["committed"]) == (3, not fail)
        assert rec["budget_s"] == pytest.approx(port.core.events
                                                .DEFAULT_NOTICE_S - 1.0)
        assert rec["wall_s"] >= 0.0
        assert rec["legs"] == coord.last_urgent_legs
        assert bool(rec["legs"]) is not fail
