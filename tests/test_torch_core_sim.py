"""The port's spot-cloud simulator held against the reference's (twins of
``tests/test_core_sim.py``): the metadata documents, instance lifecycle,
scale-set replacement, eviction schedules, the cost model and the straggler
detector. Every case runs in both packages; where the simulator yields a
sequence (eviction times, documents, lifetimes) the two are compared
element for element.
"""

from __future__ import annotations

import importlib
import itertools
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

PKG_ROOTS = {"reference": "repro", "port": "repro_torch"}


def _load(root: str) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")
    return SimpleNamespace(core=mod("core"), spot_sim=mod("core.spot_sim"))


PKGS = {name: _load(root) for name, root in PKG_ROOTS.items()}


@pytest.fixture(params=list(PKGS))
def pkg(request):
    return PKGS[request.param]


def alike(fn):
    """``fn(pkg)`` in both packages; the port's value must equal the
    reference's."""
    got = {name: fn(pkg) for name, pkg in PKGS.items()}
    assert got["port"] == got["reference"]
    return got["port"]


class TestMetadataService:
    def test_document_shape_matches_azure(self, pkg):
        core = pkg.core
        md = core.SimulatedMetadataService(core.VirtualClock(), "vm-0001")
        doc = md.get_scheduled_events()
        assert set(doc) == {"DocumentIncarnation", "Events"}
        assert doc["Events"] == []
        md.simulate_eviction()
        e = md.get_scheduled_events()["Events"][0]
        assert set(e) == {"EventId", "EventType", "ResourceType", "Resources",
                          "EventStatus", "NotBefore", "EventSource",
                          "Description"}
        assert e["EventType"] == "Preempt"
        assert e["ResourceType"] == "VirtualMachine"
        assert e["Resources"] == ["vm-0001"]
        assert e["EventStatus"] == "Scheduled"

    def test_documents_alike(self):
        def doc(pkg):
            core = pkg.core
            clock = core.VirtualClock(start=100.0)
            md = core.SimulatedMetadataService(clock, "vm-a")
            md.simulate_eviction()
            events = md.get_scheduled_events()["Events"]
            # event ids are random: compare every other field
            return ([{k: v for k, v in e.items() if k != "EventId"}
                     for e in events],
                    md.get_scheduled_events()["DocumentIncarnation"])
        alike(doc)

    def test_minimum_30s_notice(self, pkg):
        clock = pkg.core.VirtualClock(start=100.0)
        md = pkg.core.SimulatedMetadataService(clock, "vm")
        ev = md.schedule_preempt(notice_s=1.0)
        assert ev.not_before - clock.now() >= 30.0

    def test_incarnation_increments(self, pkg):
        md = pkg.core.SimulatedMetadataService(pkg.core.VirtualClock(), "vm")
        inc0 = md.get_scheduled_events()["DocumentIncarnation"]
        md.simulate_eviction()
        assert md.get_scheduled_events()["DocumentIncarnation"] == inc0 + 1

    def test_first_preempt_filters_by_resource(self, pkg):
        md = pkg.core.SimulatedMetadataService(pkg.core.VirtualClock(), "vm-a")
        md.simulate_eviction()
        doc = md.get_scheduled_events()
        assert pkg.core.first_preempt(doc, "vm-a") is not None
        assert pkg.core.first_preempt(doc, "vm-b") is None


class TestInstanceLifecycle:
    def test_preempt_then_terminate_at_notbefore(self):
        def life(pkg):
            clock = pkg.core.VirtualClock()
            inst = pkg.core.SpotInstance(name="vm", clock=clock)
            inst.boot()
            inst.announce_preemption(notice_s=30.0)
            states = [(inst.state.name, inst.alive)]
            clock.advance(29.0)
            inst.tick()
            states.append((inst.state.name, inst.alive))
            clock.advance(2.0)
            inst.tick()
            states.append((inst.state.name, inst.alive))
            return states, inst.lifetime_s()
        states, lifetime = alike(life)
        assert states[0] == ("EVICTING", True) and states[1][1]
        assert states[2][0] == "TERMINATED"
        assert lifetime == pytest.approx(31.0)


class TestScaleSet:
    def test_replacement_after_eviction(self):
        def run(pkg):
            core = pkg.core
            clock = core.VirtualClock()
            pool = core.ScaleSet(clock=clock, schedule=core.PeriodicEviction(100.0),
                                 provisioning_delay_s=20.0, notice_s=30.0)
            pool.start()
            first = pool.wait_for_instance()
            clock.advance(101.0)
            pool.tick()
            evicting = first.state.name
            clock.advance(31.0)
            dead = pool.tick() is None
            second = pool.wait_for_instance()
            return (evicting, dead, second.name != first.name,
                    pool.instances_created, pool.evictions_announced,
                    clock.now())
        got = alike(run)
        assert got[:5] == ("EVICTING", True, True, 2, 1)

    def test_ondemand_never_evicted(self, pkg):
        core = pkg.core
        clock = core.VirtualClock()
        pool = core.ScaleSet(clock=clock, schedule=core.PeriodicEviction(50.0),
                             kind="ondemand")
        pool.start()
        inst = pool.wait_for_instance()
        clock.advance(1000.0)
        assert pool.tick() is inst

    def test_accounting(self):
        def run(pkg):
            core = pkg.core
            clock = core.VirtualClock()
            acct = core.CostAccountant(core.AZURE_D8S_V3)
            pool = core.ScaleSet(clock=clock, schedule=core.NoEviction(),
                                 accountant=acct)
            pool.start()
            pool.wait_for_instance()
            clock.advance(3600.0)
            pool.tick()
            pool.shutdown()
            return acct.summary(clock.now())
        assert alike(run)["spot_usd"] == pytest.approx(0.076)


class TestSchedules:
    def test_periodic(self):
        times = alike(lambda p: list(itertools.islice(
            p.core.PeriodicEviction(60.0).eviction_times(10.0), 3)))
        assert times == [70.0, 130.0, 190.0]

    def test_poisson_same_draws(self):
        times = alike(lambda p: list(itertools.islice(
            p.core.PoissonEviction(100.0, seed=1).eviction_times(0.0), 500)))
        gaps = np.diff([0.0] + times)
        assert abs(np.mean(gaps) - 100.0) / 100.0 < 0.15

    def test_trace(self):
        assert alike(lambda p: list(p.core.TraceEviction((5.0, 9.0))
                                    .eviction_times(100.0))) == [105.0, 109.0]


class TestCostModel:
    def test_paper_discount(self):
        assert alike(lambda p: p.core.AZURE_D8S_V3.spot_discount) == \
            pytest.approx(0.8, abs=0.01)

    def test_price_sheets_alike(self):
        alike(lambda p: [(s.name, s.spot_per_hr, s.ondemand_per_hr,
                          s.storage_per_100gib_month)
                         for s in (p.core.AZURE_D8S_V3, p.core.AWS_M5_2XLARGE,
                                   p.core.GCP_N2_STANDARD_8, p.core.TPU_V5E_CHIP)])

    def test_storage_pricing(self):
        def cost(pkg):
            acct = pkg.core.CostAccountant(pkg.core.AZURE_D8S_V3)
            acct.provision_storage(100.0, now=0.0)
            return acct.storage_cost(30 * 24 * 3600.0)
        assert alike(cost) == pytest.approx(16.0, rel=1e-6)


class TestStraggler:
    def test_fires_only_on_persistent_slowness(self):
        def run(pkg):
            det = pkg.core.StragglerDetector(factor=2.0, min_samples=10, patience=3)
            return [det.observe(1.0) for _ in range(20)] + [
                det.observe(5.0) for _ in range(3)]
        fired = alike(run)
        assert not any(fired[:22]) and fired[22]

    def test_single_blip_tolerated(self):
        def run(pkg):
            det = pkg.core.StragglerDetector(factor=2.0, min_samples=5, patience=3)
            for _ in range(10):
                det.observe(1.0)
            return [det.observe(9.0)] + [det.observe(1.0) for _ in range(3)]
        assert not any(alike(run))
