"""The port's multi-cloud providers held against the reference's (twins of
``tests/test_providers.py``): the registry, each cloud's metadata schema and
notice semantics, pools, the coordinator on each provider, and the port's
trainer completing under eviction on every provider with the reference's
checkpoint invariants. Schema and pool cases run in both packages and
compare what they return; the coordinator cases compare counters, committed
steps and manifest tags.
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
                           providers=mod("core.providers"),
                           aws=mod("core.providers.aws"))


PKGS = {name: _load(root) for name, root in PKG_ROOTS.items()}
PROVIDERS = ["azure", "aws", "gcp"]


@pytest.fixture(params=list(PKGS))
def pkg(request):
    return PKGS[request.param]


def alike(fn):
    got = {name: fn(pkg) for name, pkg in PKGS.items()}
    assert got["port"] == got["reference"]
    return got["port"]


def state(step):
    return {"w": np.full((16,), float(step), np.float32), "step": step}


def make_coord(pkg, root, provider, policy=None, tm=None):
    core = pkg.core
    clock = core.VirtualClock()
    store = pkg.checkpoint.CheckpointStore(str(root), time_fn=clock.now)
    coord = core.SpotOnCoordinator(
        store, policy or core.CheckpointPolicy.transparent(1e9), clock,
        provider=provider, time_model=tm or core.TimeModel())
    md = provider.make_metadata(clock, "inst-0")
    coord.attach_instance(md, "inst-0")
    return coord, md, clock, store


class TestRegistry:
    def test_get_provider_by_name(self, pkg):
        for name in PROVIDERS:
            assert pkg.core.get_provider(name).name == name

    def test_passthrough_and_unknown(self, pkg):
        p = pkg.providers.AwsProvider()
        assert pkg.core.get_provider(p) is p
        with pytest.raises(ValueError):
            pkg.core.get_provider("ibm")

    def test_notice_floors_alike(self):
        floors = alike(lambda p: {n: p.core.get_provider(n).notice_s
                                  for n in PROVIDERS})
        assert floors == {"azure": 30.0, "aws": 120.0, "gcp": 30.0}

    def test_prices_and_prefixes_alike(self):
        alike(lambda p: {n: (p.core.get_provider(n).instance_prefix,
                             p.core.get_provider(n).prices.spot_per_hr)
                         for n in PROVIDERS})


class TestAwsSchema:
    def test_instance_action_document_shape(self, pkg):
        clock = pkg.core.VirtualClock(start=1000.0)
        md = pkg.providers.AwsProvider().make_metadata(clock, "i-0001")
        assert md.get_instance_action() is None
        ev = md.schedule_preempt(notice_s=120.0)
        doc = md.get_instance_action()
        assert set(doc) == {"action", "time"}
        assert doc["action"] == "terminate" and doc["time"].endswith("Z")
        assert pkg.aws.iso_to_ts(doc["time"]) == pytest.approx(ev.not_before,
                                                               abs=1e-3)
        assert ev.not_before == pytest.approx(1120.0, abs=1e-3)

    def test_documents_alike(self):
        def doc(pkg):
            clock = pkg.core.VirtualClock(start=1000.0)
            md = pkg.providers.AwsProvider().make_metadata(clock, "i-0001")
            md.schedule_preempt(notice_s=120.0)
            return md.get_instance_action()
        alike(doc)

    def test_two_minute_floor(self, pkg):
        md = pkg.providers.AwsProvider().make_metadata(pkg.core.VirtualClock(),
                                                       "i-0")
        assert md.schedule_preempt(notice_s=10.0).not_before >= 120.0

    def test_poll_orders_preempt_before_rebalance(self):
        def kinds(pkg):
            prov = pkg.providers.AwsProvider()
            clock = pkg.core.VirtualClock()
            md = prov.make_metadata(clock, "i-0")
            md.announce_rebalance()
            md.schedule_preempt()
            return [n.kind for n in prov.poll(md, "i-0", clock.now())]
        port = PKGS["port"].providers
        assert alike(kinds) == [port.PREEMPT_KIND, port.REBALANCE_KIND]

    def test_iso_roundtrip(self):
        assert alike(lambda p: p.aws.iso_to_ts(p.aws.ts_to_iso(1234567.25))) \
            == pytest.approx(1234567.25)


class TestGcpSchema:
    def test_preempted_flag(self, pkg):
        md = pkg.providers.GcpProvider().make_metadata(pkg.core.VirtualClock(),
                                                       "gce-0")
        assert md.get_preempted() == "FALSE"
        md.schedule_preempt()
        assert md.get_preempted() == "TRUE"

    def test_poll_synthesizes_stable_deadline(self):
        def polls(pkg):
            prov = pkg.providers.GcpProvider()
            clock = pkg.core.VirtualClock(start=50.0)
            md = prov.make_metadata(clock, "gce-0")
            assert prov.poll(md, "gce-0", clock.now()) == []
            md.schedule_preempt()
            clock.advance(1.0)
            (n1,) = prov.poll(md, "gce-0", clock.now())
            clock.advance(5.0)
            (n2,) = prov.poll(md, "gce-0", clock.now())
            assert n2.event_id == n1.event_id
            return [(n.kind, n.deadline) for n in (n1, n2)]
        got = alike(polls)
        assert got[0][1] == pytest.approx(80.0) and got[1] == got[0]

    def test_poll_after_kill_time_has_no_budget(self, pkg):
        prov = pkg.providers.GcpProvider()
        clock = pkg.core.VirtualClock()
        md = prov.make_metadata(clock, "gce-0")
        md.schedule_preempt()
        clock.advance(45.0)
        (n,) = prov.poll(md, "gce-0", clock.now())
        assert n.deadline <= 30.0 < clock.now()


class TestPools:
    @pytest.mark.parametrize("name,prefix", [("azure", "vm-"), ("aws", "i-"),
                                             ("gcp", "gce-")])
    def test_replacement_and_naming(self, name, prefix):
        def run(pkg):
            prov = pkg.core.get_provider(name)
            clock = pkg.core.VirtualClock()
            pool = prov.make_pool(clock, pkg.core.PeriodicEviction(200.0),
                                  provisioning_delay_s=20.0)
            pool.start()
            first = pool.wait_for_instance()
            clock.advance(201.0)
            pool.tick()
            clock.advance(prov.notice_s + 1.0)
            pool.tick()
            second = pool.wait_for_instance()
            return first.name, second.name, pool.instances_created, clock.now()
        first, second, created, _now = alike(run)
        assert first.startswith(prefix) and second != first and created == 2

    def test_aws_rebalance_precedes_eviction(self):
        def run(pkg):
            prov = pkg.providers.AwsProvider()
            clock = pkg.core.VirtualClock()
            pool = prov.make_pool(clock, pkg.core.PeriodicEviction(1000.0))
            pool.start()
            inst = pool.wait_for_instance()
            clock.advance(750.0)
            pool.tick()
            return (inst.metadata.get_rebalance_recommendation() is not None,
                    inst.metadata.get_instance_action() is None,
                    pool.rebalance_recommendations)
        assert alike(run) == (True, True, 1)


class TestCoordinatorIntegration:
    @pytest.mark.parametrize("name", PROVIDERS)
    def test_termination_checkpoint_on_preempt(self, tmp_path, name):
        def run(pkg):
            prov = pkg.core.get_provider(name)
            coord, md, clock, store = make_coord(pkg, tmp_path / pkg.core.__name__,
                                                 prov)
            prov.simulate_eviction(md)
            clock.advance(2.0)
            sig = coord.on_step_end(7, lambda: state(7))
            got, man = store.restore(state(0))
            coord.close()
            return (sig.name, coord.stats.termination_ckpts, man.kind,
                    got["step"], man.extra["provider"], man.extra["instance"])
        assert alike(run) == ("PREEMPTING", 1, "termination", 7, name, "inst-0")

    def test_aws_rebalance_triggers_proactive_ckpt(self, tmp_path):
        def run(pkg):
            prov = pkg.providers.AwsProvider()
            coord, md, clock, store = make_coord(pkg, tmp_path / pkg.core.__name__,
                                                 prov)
            md.announce_rebalance()
            clock.advance(2.0)
            sig = coord.on_step_end(3, lambda: state(3))
            coord.flush()
            first = (sig.name, coord.stats.rebalance_ckpts,
                     store.committed_steps())
            clock.advance(2.0)
            coord.on_step_end(4, lambda: state(4))
            coord.flush()
            coord.close()
            return first, coord.stats.rebalance_ckpts
        assert alike(run) == (("CONTINUE", 1, [3]), 1)

    def test_rebalance_opt_out(self, tmp_path):
        def run(pkg):
            prov = pkg.providers.AwsProvider()
            policy = pkg.core.CheckpointPolicy(periodic_interval_s=1e9,
                                               checkpoint_on_rebalance=False)
            coord, md, clock, store = make_coord(pkg, tmp_path / pkg.core.__name__,
                                                 prov, policy=policy)
            md.announce_rebalance()
            clock.advance(2.0)
            sig = coord.on_step_end(1, lambda: state(1))
            coord.flush()
            coord.close()
            return sig.name, store.committed_steps()
        assert alike(run) == ("CONTINUE", [])


class TestTrainerAcrossProviders:
    """The port's trainer completes under eviction on every provider with
    the reference's invariants (latest-valid restore, atomic commit), at the
    same smoke scale, on the CPU."""

    @pytest.mark.parametrize("name", PROVIDERS)
    def test_completes_under_eviction(self, tmp_path, name):
        from repro_torch.configs import get_smoke_config
        from repro_torch.optim import AdamWConfig
        from repro_torch.train import SpotTrainer, TrainJob

        core = PKGS["port"].core
        prov = core.get_provider(name)
        clock = core.VirtualClock()
        acct = core.CostAccountant(prov.prices)
        pool = prov.make_pool(clock, core.PeriodicEviction(250.0), acct,
                              provisioning_delay_s=60.0)
        store = PKGS["port"].checkpoint.CheckpointStore(str(tmp_path / name),
                                                        time_fn=clock.now)
        coord = core.SpotOnCoordinator(store, core.CheckpointPolicy.transparent(100.0),
                                       clock, provider=prov,
                                       time_model=core.TimeModel())
        job = TrainJob(cfg=get_smoke_config("phi3_mini_3p8b"),
                       opt=AdamWConfig(total_steps=40), total_steps=40,
                       n_stages=2, batch=2, seq_len=16)
        rep = SpotTrainer(job, coord, pool, clock, step_time_s=10.0,
                          max_sessions=40, device="cpu").run()
        coord.close()
        assert rep.completed
        assert rep.evictions_seen >= 1 and rep.restores >= 1
        assert rep.lost_steps == 0
        assert rep.extra["provider"] == name
        assert store.latest_valid() is not None
        assert acct.summary(clock.now())["spot_usd"] > 0


class TestStragglerRearm:
    def test_rearms_after_fire(self):
        def run(pkg):
            det = pkg.core.StragglerDetector(factor=2.0, min_samples=5, patience=2)
            for _ in range(10):
                det.observe(1.0)
            return [det.observe(9.0) for _ in range(7)]
        assert alike(run) == [False, True] + [False] * 5
