"""The port's fault-injection layer, retry and commit protocol held against
the reference's (twins of ``tests/test_faults.py``).

Each package activates its own ``FaultPlan``: the same plan is built once in
each, drives the same saves over the same states, and the two runs are
compared — which step a fresh store recovers, the committed steps, the
coordinator's counters and the chunk files themselves, byte for byte.

The ENOSPC twin advances the virtual clock past the periodic cadence (101 s,
not 100 s): the reference test's first save charges 2.000028108 s of modeled
extract and write, after which ``now - last_periodic`` at a 100 s advance
reads just under 100.0 in floating point, so its cadence check never starts
the save the test expects to fail. The twin holds both packages to the
degradation semantics of the coordinator (skip-and-alert after a storage
fault, urgent saves still attempted, cooldown then probe) instead, and a
separate case shows both packages round the 100 s boundary alike.
"""

from __future__ import annotations

import errno
import importlib
import logging
import os
import random
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

PKG_ROOTS = {"reference": "repro", "port": "repro_torch"}


def _load(root: str) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")
    return SimpleNamespace(faults=importlib.import_module(f"{root}.faults"),
                           checkpoint=mod("checkpoint"), ioutil=mod("checkpoint.ioutil"),
                           core=mod("core"), retry=mod("core.retry"))


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


def make_store(pkg, root, **kw):
    kw.setdefault("chunk_size", 4096)
    kw.setdefault("retention", 5)
    return pkg.checkpoint.CheckpointStore(str(root), **kw)


def tmp_debris(root) -> list:
    return [d for d in os.listdir(root) if ".tmp-" in d]


def chunk_files(pkg, root) -> dict[str, bytes]:
    """The chunks the committed manifests of a store reference: address ->
    stored bytes. (Orphans of an aborted save depend on which encode job
    the fault hit first, so they are left out.)"""
    mf = importlib.import_module(f"{PKG_ROOTS[pkg]}.checkpoint.manifest")
    store = make_store(PKGS[pkg], root)
    out = {}
    for step in store.committed_steps():
        man = mf.read_manifest(os.path.join(str(root), mf.step_dirname(step)))
        for h in man.chunk_hashes():
            with open(store.pool.path(h), "rb") as f:
                out[h] = f.read()
    return out


# -- the FaultPlan itself -----------------------------------------------------


class TestFaultPlan:
    def test_nth_and_count_window(self, pkg):
        plan = pkg.faults.FaultPlan().add("chunk.write", nth=2, count=2,
                                          error="eio")
        hits = [plan.check("chunk.write") is not None for _ in range(5)]
        assert hits == [False, True, True, False, False]

    def test_persistent_rule_matches_wildcard(self, pkg):
        plan = pkg.faults.FaultPlan().add("chunk.*", nth=2, count=-1)
        assert plan.check("chunk.fsync") is None
        assert plan.check("chunk.replace").action == "crash"
        assert plan.check("chunk.write").action == "crash"
        assert plan.check("manifest.write") is None
        assert plan.fired() == 2

    def test_path_substr_filter(self, pkg):
        plan = pkg.faults.FaultPlan().add("chunk.write", path_substr="deadbeef",
                                          error="eio")
        assert plan.check("chunk.write", "/pool/ab/abcd1234") is None
        inj = plan.check("chunk.write", "/pool/de/deadbeef01")
        assert inj is not None and inj.err == errno.EIO

    def test_unknown_error_kind_rejected(self, pkg):
        plan = pkg.faults.FaultPlan().add("chunk.write", error="ekaboom")
        with pytest.raises(ValueError):
            plan.check("chunk.write")

    def test_crash_point_lists_match(self):
        ref, port = PKGS["reference"].faults, PKGS["port"].faults
        assert port.COMMIT_CRASH_POINTS == ref.COMMIT_CRASH_POINTS
        assert port.BACKEND_CRASH_POINTS == ref.BACKEND_CRASH_POINTS

    def test_each_plan_fires_only_in_its_own_package(self, tmp_path):
        """A plan active in one package leaves the other's saves alone."""
        ref, port = PKGS["reference"], PKGS["port"]
        plan = port.faults.FaultPlan().add("chunk.write", error="crash")
        with port.faults.active(plan):
            make_store(ref, tmp_path / "ref").save(1, make_state(1))
            with pytest.raises(port.faults.SimulatedCrash):
                make_store(port, tmp_path / "port").save(1, make_state(1))
        assert plan.fired() == 1


# -- bounded retry / backoff --------------------------------------------------


class TestRetry:
    def test_transient_retried_with_exponential_backoff(self, pkg):
        sleeps = []
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise OSError(errno.EIO, "flaky disk")
            return "ok"

        policy = pkg.retry.RetryPolicy(max_attempts=4, base_delay_s=1.0,
                                       multiplier=2.0, jitter=0.0)
        assert pkg.retry.call_with_retry(flaky, policy=policy,
                                         sleep=sleeps.append) == "ok"
        assert calls["n"] == 3
        assert sleeps == [1.0, 2.0]

    def test_persistent_errno_fails_immediately(self, pkg):
        calls = {"n": 0}

        def full_disk():
            calls["n"] += 1
            raise OSError(errno.ENOSPC, "disk full")

        with pytest.raises(OSError) as ei:
            pkg.retry.call_with_retry(full_disk, sleep=lambda d: None)
        assert ei.value.errno == errno.ENOSPC
        assert calls["n"] == 1

    def test_exhaustion_reraises_after_bound(self, pkg):
        calls = {"n": 0}

        def dead_disk():
            calls["n"] += 1
            raise OSError(errno.EIO, "dead disk")

        policy = pkg.retry.RetryPolicy(max_attempts=3, base_delay_s=0.0)
        with pytest.raises(OSError):
            pkg.retry.call_with_retry(dead_disk, policy=policy,
                                      sleep=lambda d: None)
        assert calls["n"] == 3

    def test_jitter_matches_the_reference_draw_for_draw(self):
        delays = {}
        for name, pkg in PKGS.items():
            policy = pkg.retry.RetryPolicy(base_delay_s=1.0, jitter=0.5)
            delays[name] = [policy.delay_s(k, random.Random(7))
                            for k in (1, 2, 3)]
        assert delays["port"] == delays["reference"]
        assert all(0.5 <= d / min(policy.max_delay_s, 2.0 ** (k - 1)) <= 1.5
                   for k, d in enumerate(delays["port"], start=1))

    def test_simulated_crash_passes_straight_through(self, pkg):
        calls = {"n": 0}

        def killed():
            calls["n"] += 1
            raise pkg.faults.SimulatedCrash("kill -9")

        with pytest.raises(pkg.faults.SimulatedCrash):
            pkg.retry.call_with_retry(killed, sleep=lambda d: None)
        assert calls["n"] == 1


# -- the crash-point matrix ---------------------------------------------------

#: points at or after the COMMITTED marker: the aborted save's own step is
#: recoverable; every earlier point must recover the prior checkpoint
NEW_STEP_POINTS = {
    ("marker.write", "torn"),
    ("marker.write", "crash"),
    ("commit.committed", "crash"),
}


def _abort_recover_selfheal(pkg, root, op, error) -> dict:
    store = make_store(pkg, root)
    s1, s2, s3 = make_state(1), make_state(2), make_state(3)
    store.save(1, s1)
    count = -1 if error not in ("crash", "torn", "rollback") else 1
    plan = pkg.faults.FaultPlan().add(op, error=error, count=count)
    with pkg.faults.active(plan):
        with pytest.raises((pkg.faults.SimulatedCrash, OSError)):
            store.save(2, s2)
    assert plan.fired() >= 1, f"crash point {op}/{error} never hit"
    reopened = make_store(pkg, root)
    opened = reopened.latest_valid()
    assert opened is not None, "recovery lost every checkpoint"
    recovered = opened[0].step
    expect = {1: s1, 2: s2}[recovered]
    got, man = reopened.restore(template(expect))
    assert man.step == recovered
    assert_state_equal(got, expect)
    store.save(3, s3)
    got3, man3 = store.restore(template(s3))
    assert man3.step == 3
    assert_state_equal(got3, s3)
    assert tmp_debris(root) == []
    return {"recovered": recovered, "committed": store.committed_steps()}


class TestCrashPointMatrix:
    @pytest.mark.parametrize(
        "op,error", PKGS["reference"].faults.COMMIT_CRASH_POINTS,
        ids=[f"{op}-{error}"
             for op, error in PKGS["reference"].faults.COMMIT_CRASH_POINTS])
    def test_abort_recover_selfheal_alike(self, tmp_path, op, error):
        runs = {name: _abort_recover_selfheal(pkg, tmp_path / name, op, error)
                for name, pkg in PKGS.items()}
        expect_step = 2 if (op, error) in NEW_STEP_POINTS else 1
        assert runs["port"]["recovered"] == expect_step
        assert runs["port"] == runs["reference"]
        # the surviving chunks are the same addresses holding the same bytes
        assert (chunk_files("port", tmp_path / "port")
                == chunk_files("reference", tmp_path / "reference"))


# -- gc: staging debris vs. live saves ----------------------------------------


class TestGcStagingDebris:
    def test_sweep_during_inflight_save_spares_stage_and_pins(self, pkg,
                                                              tmp_path):
        store = make_store(pkg, tmp_path)
        store.save(1, make_state(11))
        plan = pkg.faults.FaultPlan().add("commit.manifest_written",
                                          error="crash")
        with pkg.faults.active(plan):
            with pytest.raises(pkg.faults.SimulatedCrash):
                store.save(2, make_state(12))
        debris = tmp_debris(tmp_path)
        assert len(debris) == 1
        seen = {}

        def hook(phase):
            if phase == "manifest_written":
                store.gc(stale_staging_age_s=0.0, stale_chunk_age_s=0.0,
                         sweep_chunks=True)
                seen["tmp"] = tmp_debris(tmp_path)

        store.fault_injector = hook
        s2 = make_state(13)
        store.save(2, s2)
        assert len(seen["tmp"]) == 1
        assert debris[0] not in seen["tmp"]
        got, man = make_store(pkg, tmp_path).restore(template(s2))
        assert man.step == 2
        assert_state_equal(got, s2)

    def test_foreign_debris_is_age_gated(self, pkg, tmp_path):
        store = make_store(pkg, tmp_path)
        store.save(1, make_state(21))
        foreign = os.path.join(str(tmp_path),
                               "step_00000002.tmp-ffffff-deadbeef")
        os.makedirs(foreign)
        store.gc(stale_staging_age_s=3600.0)
        assert os.path.isdir(foreign)
        store.gc(stale_staging_age_s=0.0)
        assert not os.path.exists(foreign)


# -- fsync_dir degradation ----------------------------------------------------


class TestFsyncDirDegradation:
    def test_unsupported_fs_warns_once_and_continues(self, pkg, tmp_path,
                                                     monkeypatch, caplog):
        ioutil = pkg.ioutil
        monkeypatch.setattr(ioutil, "_fsync_warned", False)
        monkeypatch.setattr(ioutil.os, "fsync", lambda fd: (_ for _ in ()).throw(
            OSError(errno.EINVAL, "Invalid argument")))
        with caplog.at_level(logging.WARNING, logger=ioutil.log.name):
            ioutil.fsync_dir(str(tmp_path))
            ioutil.fsync_dir(str(tmp_path))
        warned = [r for r in caplog.records if "fsync unsupported" in r.message]
        assert len(warned) == 1

    def test_real_io_error_propagates(self, pkg, tmp_path, monkeypatch):
        monkeypatch.setattr(pkg.ioutil.os, "fsync",
                            lambda fd: (_ for _ in ()).throw(
                                OSError(errno.EIO, "Input/output error")))
        with pytest.raises(OSError) as ei:
            pkg.ioutil.fsync_dir(str(tmp_path))
        assert ei.value.errno == errno.EIO


# -- storage degradation: skip-and-alert --------------------------------------


def make_coord(pkg, root, periodic_s=100.0, async_writes=False):
    core = pkg.core
    clock = core.VirtualClock()
    store = make_store(pkg, root, time_fn=clock.now)
    policy = core.CheckpointPolicy(periodic_interval_s=periodic_s,
                                   async_writes=async_writes)
    coord = core.SpotOnCoordinator(store, policy, clock,
                                   time_model=core.TimeModel())
    md = core.SimulatedMetadataService(clock, "vm-0")
    coord.attach_instance(md, "vm-0")
    return coord, md, clock, store


def _stats(coord) -> dict:
    s = coord.stats
    return {k: getattr(s, k) for k in (
        "periodic_ckpts", "periodic_failures", "saves_degraded",
        "termination_ckpts", "termination_failures", "rebalance_ckpts",
        "poll_failures")}


def _enospc_past_the_cadence(pkg, root) -> dict:
    """The reference ENOSPC scenario with every cadence advance past the
    interval (101 s), held to the coordinator's degradation semantics."""
    core = pkg.core
    coord, md, clock, store = make_coord(pkg, root)
    clock.advance(100.0)
    coord.on_step_end(1, lambda: make_state(1))
    assert coord.stats.periodic_ckpts == 1
    plan = pkg.faults.FaultPlan().add("chunk.write", error="enospc", count=-1)
    with pkg.faults.active(plan):
        # full disk at the next cadence: the save fails, training does not,
        # and the coordinator enters the skip-and-alert window
        clock.advance(101.0)
        assert coord.on_step_end(2, lambda: make_state(2)) is core.Signal.CONTINUE
        assert coord.stats.periodic_failures == 1
        assert coord.stats.saves_degraded == 1
        # the next cadence lands inside the cooldown: skipped, no second
        # ENOSPC round trip
        clock.advance(101.0)
        coord.on_step_end(3, lambda: make_state(3))
        assert coord.stats.periodic_ckpts == 1
        assert coord.stats.periodic_failures == 1
        assert coord.stats.saves_degraded == 2
        # an eviction notice mid-degradation: the urgent save still
        # attempts, and this state dedups against step 1's chunks
        md.simulate_eviction()
        clock.advance(1.0)
        assert coord.on_step_end(4, lambda: make_state(1)) is core.Signal.PREEMPTING
        assert coord.stats.termination_ckpts == 1
    # cooldown over: the next periodic probes storage again and succeeds
    clock.advance(300.0)
    coord.on_step_end(5, lambda: make_state(5))
    assert coord.stats.periodic_ckpts == 2
    assert store.committed_steps() == [1, 4, 5]
    clock.advance(1.0)
    coord.on_step_end(6, lambda: make_state(5))
    assert coord.stats.faults_injected >= 1
    coord.close()
    # how many chunk writes met the full disk depends on how far the
    # parallel encode jobs got before the first failure: not compared
    assert plan.fired() >= 1
    return {**_stats(coord), "committed": store.committed_steps()}


class TestStorageDegradation:
    def test_enospc_periodic_degrades_urgent_still_commits(self, tmp_path):
        runs = {name: _enospc_past_the_cadence(pkg, tmp_path / name)
                for name, pkg in PKGS.items()}
        assert runs["port"] == runs["reference"]
        assert (chunk_files("port", tmp_path / "port")
                == chunk_files("reference", tmp_path / "reference"))

    def test_exact_cadence_boundary_rounds_alike(self, tmp_path):
        """At a 100 s advance after a modeled save, both coordinators read
        the cadence as not yet due (float rounding of the clock): the
        reference test's failure is the same in both packages."""
        seen = {}
        for name, pkg in PKGS.items():
            coord, md, clock, store = make_coord(pkg, tmp_path / name)
            clock.advance(100.0)
            coord.on_step_end(1, lambda: make_state(1))
            clock.advance(100.0)
            coord.on_step_end(2, lambda: make_state(2))
            seen[name] = (clock.now() - coord._last_periodic_at,
                          _stats(coord))
            coord.close()
        assert seen["port"] == seen["reference"]
        elapsed, stats = seen["port"]
        assert elapsed < 100.0 and stats["periodic_ckpts"] == 1


# -- metadata-poll retry and assume-evictable ---------------------------------


def _transient_poll(pkg, root) -> dict:
    coord, md, clock, store = make_coord(pkg, root, periodic_s=1e9)
    plan = pkg.faults.FaultPlan().add("provider.poll", error="etimedout",
                                      count=2)
    with pkg.faults.active(plan):
        clock.advance(10.0)
        before = clock.now()
        assert coord.on_step_end(1, lambda: make_state(1)) is pkg.core.Signal.CONTINUE
    assert plan.fired() == 2
    assert coord.stats.poll_failures == 0
    assert clock.now() > before
    clock.advance(10.0)
    coord.on_step_end(2, lambda: make_state(1))
    assert coord.stats.io_retries >= 2
    coord.close()
    # the backoff's jitter draws are unseeded: how far the clock moved is
    # left out of the comparison
    return {**_stats(coord), "io_retries": coord.stats.io_retries}


def _persistent_poll(pkg, root) -> dict:
    coord, md, clock, store = make_coord(pkg, root, periodic_s=1e9)
    plan = pkg.faults.FaultPlan().add("provider.poll", error="eio", count=-1)
    with pkg.faults.active(plan):
        for step in range(1, 7):
            clock.advance(10.0)
            coord.on_step_end(step, lambda: make_state(1))
    assert coord.stats.poll_failures == 6
    assert coord.stats.rebalance_ckpts == 2
    assert store.committed_steps()
    clock.advance(10.0)
    coord.on_step_end(7, lambda: make_state(1))
    assert coord._poll_fail_streak == 0
    coord.close()
    return {**_stats(coord), "committed": store.committed_steps()}


class TestPollDegradation:
    def test_transient_poll_fault_absorbed_by_backoff(self, tmp_path):
        runs = {name: _transient_poll(pkg, tmp_path / name)
                for name, pkg in PKGS.items()}
        assert runs["port"] == runs["reference"]

    def test_persistent_poll_failure_assumes_evictable(self, tmp_path):
        runs = {name: _persistent_poll(pkg, tmp_path / name)
                for name, pkg in PKGS.items()}
        assert runs["port"] == runs["reference"]


# -- fleet eviction storm with live faults ------------------------------------


def _storm(pkg, root):
    core = pkg.core
    plan = (pkg.faults.FaultPlan()
            .add("chunk.write", error="eio", count=1)
            .add("chunk.fsync", error="eio", count=1)
            .add("provider.poll", error="etimedout", count=1))
    with pkg.faults.active(plan):
        clock = core.VirtualClock()
        store = pkg.checkpoint.CheckpointStore(str(root), time_fn=clock.now,
                                               retention=50)
        spec = core.FleetSpec(providers=("azure", "aws", "gcp"),
                              schedules=(core.PeriodicEviction(150.0),
                                         core.PeriodicEviction(200.0),
                                         core.PeriodicEviction(250.0)),
                              provisioning_delay_s=60.0)
        fleet = core.FleetCoordinator(store,
                                      core.CheckpointPolicy.transparent(100.0),
                                      clock, spec, time_model=core.TimeModel())
        rep = fleet.run(total_steps=50, step_time_s=10.0)
    return rep, plan


class TestFleetStormUnderFaults:
    def test_storm_completes_and_surfaces_fault_counters(self, tmp_path):
        reps = {}
        for name, pkg in PKGS.items():
            rep, plan = _storm(pkg, tmp_path / name)
            assert rep.completed and rep.final_state_consistent
            assert plan.fired() == 3
            assert rep.checkpoints["io_retries"] >= 2
            assert rep.checkpoints["faults_injected"] >= 3
            assert rep.checkpoints["saves_degraded"] == 0
            reps[name] = rep
        # the async writers race the injected faults (which save's chunk
        # write meets the EIO varies run to run, in either package), so the
        # reports are compared on what the schedule alone decides
        ref, port = reps["reference"], reps["port"]
        assert port.completed == ref.completed
        assert port.full_outages == ref.full_outages
        assert ({k: v["evictions"] for k, v in port.per_provider.items()}
                == {k: v["evictions"] for k, v in ref.per_provider.items()})
        assert (port.checkpoints["saves_degraded"]
                == ref.checkpoints["saves_degraded"])
