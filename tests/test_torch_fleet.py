"""The port's fleet coordinator held against the reference's (twins of
``tests/test_fleet.py``).

Both packages run the same fleet — providers, eviction schedules, cadence
and seeds — against a shared store of their own, and each must meet the
reference test's assertions. The reports are then compared on what the
schedules decide (evictions per provider, instances, outages, rescale
events and their mesh plans), and a checkpoint the port's fleet committed is
restored by the reference, bit for bit.
"""

from __future__ import annotations

import importlib
import os
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

PKG_ROOTS = {"reference": "repro", "port": "repro_torch"}


def _load(root: str) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")
    return SimpleNamespace(checkpoint=mod("checkpoint"),
                           mf=mod("checkpoint.manifest"), core=mod("core"))


PKGS = {name: _load(root) for name, root in PKG_ROOTS.items()}


@pytest.fixture(params=list(PKGS))
def pkg(request):
    return PKGS[request.param]


def run_fleet(pkg, root, *, providers=("azure", "aws", "gcp"),
              schedules=None, total_steps=50, step_time_s=10.0,
              periodic_s=100.0, retention=50, fault_injector=None,
              provisioning_delay_s=60.0):
    core = pkg.core
    clock = core.VirtualClock()
    store = pkg.checkpoint.CheckpointStore(str(root), time_fn=clock.now,
                                           retention=retention,
                                           fault_injector=fault_injector)
    spec = core.FleetSpec(providers=providers,
                          schedules=schedules(core) if schedules else None,
                          provisioning_delay_s=provisioning_delay_s)
    fleet = core.FleetCoordinator(store, core.CheckpointPolicy.transparent(periodic_s),
                                  clock, spec, time_model=core.TimeModel())
    report = fleet.run(total_steps=total_steps, step_time_s=step_time_s)
    return report, store, fleet


def staggered(core):
    return (core.PeriodicEviction(150.0), core.PeriodicEviction(200.0),
            core.PeriodicEviction(250.0))


def schedule_view(rep) -> dict:
    """What a fleet's eviction schedules decide, independent of how long
    the real restores and writes took."""
    return {
        "completed": rep.completed,
        "full_outages": rep.full_outages,
        "final_state_consistent": rep.final_state_consistent,
        "providers": {k: (v["evictions"], v["instances"])
                      for k, v in rep.per_provider.items()},
        "rescales": [(e["alive"], e.get("mesh_shape"), e.get("mesh_axes"),
                      e.get("dp"), e.get("tp"))
                     for e in rep.rescale_events],
    }


class TestMixedFleet:
    def test_completes_under_staggered_evictions(self, tmp_path):
        views = {}
        for name, pkg in PKGS.items():
            rep, _store, _f = run_fleet(pkg, tmp_path / name,
                                        schedules=staggered)
            assert rep.completed and rep.final_state_consistent
            for prov in ("azure", "aws", "gcp"):
                assert rep.per_provider[prov]["evictions"] >= 1
                assert rep.checkpoints["by_provider"][prov]["termination"] >= 1
            assert all(p["spot_usd"] > 0 for p in rep.per_provider.values())
            views[name] = schedule_view(rep)
        assert views["port"] == views["reference"]

    def test_provider_tags_on_shared_store(self, tmp_path, pkg):
        rep, store, _f = run_fleet(pkg, tmp_path, schedules=staggered)
        tagged = set()
        for step in store.committed_steps():
            man = pkg.mf.read_manifest(os.path.join(store.root,
                                                    pkg.mf.step_dirname(step)))
            if "provider" in man.extra:
                tagged.add(man.extra["provider"])
        assert tagged and tagged <= {"azure", "aws", "gcp"}

    def test_rescale_events_track_alive_capacity(self, tmp_path, pkg):
        rep, _, _f = run_fleet(pkg, tmp_path, schedules=staggered)
        assert len(rep.rescale_events) >= 3
        first = rep.rescale_events[0]
        assert first["alive"] == 3 and first["mesh_shape"] == (3, 1)
        assert any(e["alive"] < 3 for e in rep.rescale_events[1:])

    def test_single_eviction_costs_capacity_not_progress(self, tmp_path):
        views = {}
        for name, pkg in PKGS.items():
            rep, _, _f = run_fleet(
                pkg, tmp_path / name,
                schedules=lambda c: (c.TraceEviction((200.0,)), c.NoEviction(),
                                     c.NoEviction()), total_steps=40)
            assert rep.completed
            assert rep.full_outages == 0 and rep.restores == 0
            assert rep.lost_steps == 0
            assert rep.per_provider["azure"]["evictions"] == 1
            views[name] = (schedule_view(rep), rep.steps_executed)
        assert views["port"] == views["reference"]

    def test_full_outage_restores_latest_valid(self, tmp_path):
        views = {}
        for name, pkg in PKGS.items():
            rep, _, _f = run_fleet(
                pkg, tmp_path / name, providers=("azure", "azure", "azure"),
                schedules=lambda c: tuple(c.TraceEviction((200.0,))
                                          for _ in range(3)),
                total_steps=40, periodic_s=50.0)
            assert rep.completed and rep.full_outages >= 1
            assert rep.restores >= 1 and rep.final_state_consistent
            assert rep.lost_steps <= 4
            views[name] = schedule_view(rep)
        assert views["port"] == views["reference"]

    def test_homogeneous_fleet(self, tmp_path, pkg):
        rep, _, _f = run_fleet(pkg, tmp_path, providers=("azure", "azure"),
                               schedules=lambda c: (c.PeriodicEviction(150.0),
                                                    c.NoEviction()),
                               total_steps=30)
        assert rep.completed
        assert set(rep.per_provider) == {"azure"}
        assert rep.per_provider["azure"]["instances"] >= 3

    def test_schedule_count_mismatch_rejected(self, tmp_path, pkg):
        core = pkg.core
        clock = core.VirtualClock()
        store = pkg.checkpoint.CheckpointStore(str(tmp_path), time_fn=clock.now)
        with pytest.raises(ValueError):
            core.FleetCoordinator(store, core.CheckpointPolicy.transparent(100.0),
                                  clock, core.FleetSpec(providers=("azure", "aws"),
                                                        schedules=(core.NoEviction(),)))

    def test_capacity_short_of_the_model_degree_is_recorded(self, tmp_path):
        """A plan the survivors cannot host is an error event in both."""
        events = {}
        for name, pkg in PKGS.items():
            core = pkg.core
            clock = core.VirtualClock()
            store = pkg.checkpoint.CheckpointStore(str(tmp_path / name),
                                                   time_fn=clock.now)
            spec = core.FleetSpec(providers=("aws", "gcp"), model_parallel=2,
                                  schedules=(core.TraceEviction((150.0,)),
                                             core.NoEviction()),
                                  provisioning_delay_s=60.0)
            fleet = core.FleetCoordinator(store,
                                          core.CheckpointPolicy.transparent(100.0),
                                          clock, spec, time_model=core.TimeModel())
            rep = fleet.run(total_steps=30, step_time_s=10.0)
            assert rep.completed
            events[name] = [(e["alive"], e.get("mesh_shape"), "error" in e,
                             e.get("dp"), e.get("tp"))
                            for e in rep.rescale_events]
        assert events["port"] == events["reference"]
        assert any(err for _a, _s, err, _d, _t in events["port"])


class TestAtomicityUnderFleet:
    def test_failed_write_stays_invisible_run_completes(self, tmp_path, pkg):
        boom = {"armed": True}

        def injector(phase):
            if phase == "manifest_written" and boom["armed"]:
                boom["armed"] = False
                raise IOError("nfs died mid-eviction")

        rep, store, _f = run_fleet(
            pkg, tmp_path,
            schedules=lambda c: tuple(c.TraceEviction((200.0,))
                                      for _ in range(3)),
            total_steps=40, periodic_s=50.0, fault_injector=injector)
        assert rep.completed
        assert (rep.checkpoints["termination_failures"]
                + rep.checkpoints["periodic_failures"]) >= 1
        for step in store.committed_steps():
            path = os.path.join(store.root, pkg.mf.step_dirname(step))
            assert pkg.mf.is_committed(path)
            pkg.mf.read_manifest(path)

    def test_concurrent_writers_do_not_corrupt(self, tmp_path, pkg):
        rep, store, _f = run_fleet(
            pkg, tmp_path,
            schedules=lambda c: (c.PeriodicEviction(120.0),
                                 c.PeriodicEviction(170.0),
                                 c.PeriodicEviction(220.0)),
            total_steps=60, periodic_s=30.0)
        assert rep.completed
        opened = store.latest_valid()
        assert opened is not None
        man, reader = opened
        reader.validate()


class TestInterchange:
    def test_port_fleet_checkpoint_restores_in_the_reference(self, tmp_path):
        port, ref = PKGS["port"], PKGS["reference"]
        rep, store, _f = run_fleet(port, tmp_path, schedules=staggered)
        assert rep.completed
        template = {"w": np.zeros((1024,), np.float32), "step": 0}
        got_port, man_port = store.restore(template)
        got_ref, man_ref = ref.checkpoint.CheckpointStore(
            str(tmp_path)).restore(template)
        assert man_ref.step == man_port.step
        assert got_ref["step"] == got_port["step"] == man_port.step
        assert (np.asarray(got_ref["w"]).tobytes()
                == np.asarray(got_port["w"]).tobytes())
        # the fleet's replicated state: every element equals its step
        assert np.all(np.asarray(got_ref["w"]) == float(man_ref.step))

    def test_fleet_exports_match(self):
        for name in ("FleetCoordinator", "FleetReport", "FleetSpec"):
            assert hasattr(PKGS["port"].core, name), name
        ref_fields = set(PKGS["reference"].core.FleetReport.__dataclass_fields__)
        assert set(PKGS["port"].core.FleetReport.__dataclass_fields__) == ref_fields
