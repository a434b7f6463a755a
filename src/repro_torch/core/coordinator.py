"""SpotOnCoordinator — the paper's checkpoint coordinator (Fig. 1).

Runs beside the workload (in-process here; a sidecar in the paper), and owns:

* scheduling **periodic checkpoints** (transparent mode),
* polling the cloud metadata service through its ``CloudProvider`` backend
  (Azure Scheduled Events / AWS IMDS / GCP preempted flag) and, on a
  normalized preempt notice, taking an opportunistic **termination
  checkpoint** (transparent mode only — the application-specific mode
  *cannot checkpoint on demand*, per the paper). Advance *rebalance*
  recommendations (AWS) trigger a proactive checkpoint without stopping,
* on restart, finding the **most recent valid checkpoint** and restoring,
* (beyond paper, needed at 1000-node scale) a **straggler policy** that turns a
  persistently slow instance into a voluntary eviction: checkpoint + replace.

Time accounting is delegated to a ``TimeLedger`` (core/ledger.py): when a
``TimeModel`` is configured (virtual-time benchmarks) the ledger charges
modeled durations to the clock — extract cost for async periodic saves (write
IO overlaps training), extract+write for blocking termination / stage
checkpoints, read cost for restores. In wall-clock mode durations are charged
by physics. With a delta-mode store (the default) write costs are charged on
``CheckpointInfo.new_bytes`` — the dirty chunks actually pushed to the shared
volume — not the logical state size; that is precisely why an urgent
termination checkpoint fits the eviction-notice window at low churn.
Periodic saves additionally run through the **device-delta tracker**
(``checkpoint.device_delta``): per-block fingerprints stay device-resident
between saves, so the extract leg moves only fingerprint-dirty blocks
device→host — the modeled extract cost is charged on ``Snapshot.d2h_bytes``
(the bytes that actually crossed the link), and
``CoordinatorStats``/``TimeLedger`` record ``d2h_bytes`` /
``d2h_bytes_skipped`` plus the extract stall so the saving is observable in
every run report. Urgent and stage saves bypass the tracker.
Checkpoints written through the coordinator carry ``{"provider", "instance"}``
tags in their manifest extras, so a fleet's shared store records which cloud
wrote each checkpoint.

The coordinator also owns **MTTR** (mean time to recovery — eviction to the
first training step completed on the replacement): ``detach`` starts the
window, the first ``on_step_end`` after it closes the window, and samples
accumulate in ``CoordinatorStats.mttr_samples`` plus the ledger's
observation trail (``TimeLedger.observe``). Restores default to the
streaming disk→device pipeline, which is what the fast-resume benchmark
(``benchmarks/resume_bench.py``) measures.
"""

from __future__ import annotations

import enum
import errno
import logging
import time as _time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

from ..checkpoint import backend as chunk_backend
from ..checkpoint import codec_sched
from ..checkpoint.async_ckpt import AsyncCheckpointer
from ..checkpoint.serialize import is_moment_name
from ..checkpoint.sharded import Snapshot, extract_snapshot, prestage
from ..checkpoint.store import CheckpointStore
from ..faults import inject as fault_inject
from . import retry
from .clock import Clock, VirtualClock
from .ledger import TimeLedger, TimeModel  # noqa: F401  (TimeModel re-export)
from .policy import CheckpointPolicy, Mode
from .providers import (CloudProvider, PreemptNotice, PREEMPT_KIND,
                        REBALANCE_KIND, get_provider)

log = logging.getLogger("spoton")

# storage faults that describe a state (full/read-only/dead disk) rather
# than an event: a save failing with one of these enters the degradation
# window. EIO is included because the IO layer's bounded retries already
# ran — an EIO surfacing here is persistent by construction.
_STORAGE_FAULT_ERRNOS = frozenset(retry.PERSISTENT_ERRNOS) | {errno.EIO}


def _storage_fault(exc: BaseException | None) -> bool:
    """True when ``exc`` (or any chained cause — async failures arrive
    wrapped in RuntimeError) is a persistent storage-level fault."""
    seen = 0
    while exc is not None and seen < 8:
        if isinstance(exc, OSError) and exc.errno in _STORAGE_FAULT_ERRNOS:
            return True
        exc = exc.__cause__ or exc.__context__
        seen += 1
    return False


class Signal(enum.Enum):
    CONTINUE = "continue"
    PREEMPTING = "preempting"   # stop cleanly before NotBefore
    STRAGGLER = "straggler"     # ask the pool for a replacement


class StragglerDetector:
    """Flags an instance whose step time stays above factor×rolling-median.

    Firing re-arms the detector (window + streak cleared): the flag evicts the
    instance, so stale samples from it must not condemn the replacement — the
    detector needs ``min_samples`` fresh observations before it can fire again.
    """

    def __init__(self, factor: float = 2.0, window: int = 50,
                 min_samples: int = 20, patience: int = 5):
        self.factor = factor
        self.window: deque[float] = deque(maxlen=window)
        self.min_samples = min_samples
        self.patience = patience
        self._slow_streak = 0

    def observe(self, step_duration_s: float) -> bool:
        if len(self.window) >= self.min_samples:
            median = sorted(self.window)[len(self.window) // 2]
            if step_duration_s > self.factor * median:
                self._slow_streak += 1
            else:
                self._slow_streak = 0
        self.window.append(step_duration_s)
        if self._slow_streak >= self.patience:
            self.reset()
            return True
        return False

    def reset(self) -> None:
        self._slow_streak = 0
        self.window.clear()


@dataclass
class CoordinatorStats:
    periodic_ckpts: int = 0
    periodic_failures: int = 0
    termination_ckpts: int = 0
    termination_failures: int = 0
    rebalance_ckpts: int = 0
    stage_ckpts: int = 0
    restores: int = 0
    ckpt_bytes_written: int = 0
    ckpt_time_s: float = 0.0
    restore_time_s: float = 0.0
    # device→host traffic of the save path: bytes that crossed the link vs.
    # bytes the device fingerprint path proved unchanged and never staged,
    # and the cumulative wall time training was stalled inside extract
    d2h_bytes: int = 0
    d2h_bytes_skipped: int = 0
    save_stall_s: float = 0.0
    # restore-QoS scheduler split, from the codec scheduler's RESTORE lane:
    # queue-wait (job submitted → worker picked it up: a starved scheduler)
    # vs decode execution (worker busy on the bytes: a slow disk). Lane
    # counters are process-wide, so under concurrent restores from several
    # coordinators the split is a fleet aggregate, not per-member.
    restore_queue_wait_s: float = 0.0
    restore_decode_s: float = 0.0
    # times a periodic-save encode handed its worker to a higher-priority
    # job at a chunk boundary (cooperative preemption)
    save_yields: int = 0
    # robustness counters (process-wide deltas folded per coordinator, like
    # save_yields): bounded-retry attempts the IO layer burned on transient
    # faults, faults the torture layer injected (0 outside torture runs),
    # and periodic saves skipped-and-alerted while storage was degraded
    # (ENOSPC / persistent EIO) — urgent saves keep committing through it
    io_retries: int = 0
    faults_injected: int = 0
    saves_degraded: int = 0
    # object-store backend robustness (process-wide deltas, like io_retries):
    # bounded-retry attempts burned on backend.get/put/head ops, outage
    # windows the consecutive-failure detector entered, and bytes spooled to
    # the local cache while the store was unreachable (reconciled later)
    backend_retries: int = 0
    backend_outages: int = 0
    spooled_bytes: int = 0
    # consecutive-failure count of the metadata poll at its worst — how
    # close the coordinator came to assuming eviction blind
    poll_failures: int = 0
    # MTTR: eviction (detach) → first training step completed on the
    # replacement. Covers provisioning, restore, recompilation and data
    # fast-forward — the full window the fast-resume pipeline minimizes.
    mttr_samples: list[float] = field(default_factory=list)

    @property
    def mttr_mean_s(self) -> float:
        return (sum(self.mttr_samples) / len(self.mttr_samples)
                if self.mttr_samples else 0.0)


class SpotOnCoordinator:
    def __init__(
        self,
        store: CheckpointStore,
        policy: CheckpointPolicy,
        clock: Clock,
        *,
        provider: CloudProvider | str | None = None,
        mesh_info: dict | None = None,
        time_model: TimeModel | None = None,
        ledger: TimeLedger | None = None,
        straggler: StragglerDetector | None = None,
        device_delta: bool = True,
    ):
        self.store = store
        self.policy = policy
        self.clock = clock
        self.provider = get_provider(provider if provider is not None else "azure")
        self.mesh_info = mesh_info or {}
        self.ledger = ledger if ledger is not None else TimeLedger(clock, time_model)
        self.straggler = straggler
        self.stats = CoordinatorStats()
        self._async = AsyncCheckpointer(store) if policy.async_writes else None
        # device-resident delta detection for periodic saves (delta-mode
        # stores): fingerprints live on device between saves, so unchanged
        # blocks never cross the device→host link. Urgent/termination and
        # application (stage) saves always bypass it.
        self.delta_tracker = None
        if device_delta and store.mode == "delta":
            from ..checkpoint.device_delta import DeviceDeltaTracker
            self.delta_tracker = DeviceDeltaTracker(
                store.pool, chunk_size=store.chunk_size,
                compress=store.compress,
                quantize_moments=store.quantize_moments)
        self._metadata: Any = None
        self._instance_name: str | None = None
        self._last_periodic_at = clock.now()
        self._handled_notices: set[str] = set()
        self._last_poll_at = -float("inf")
        # MTTR bookkeeping: set at detach (the eviction moment), consumed by
        # the first completed step on the replacement instance
        self._evicted_at: float | None = None
        # last-seen global yield count (the scheduler counter is
        # process-wide and monotonic; we fold deltas)
        self._seen_yields = codec_sched.snapshot_stats()["yields"]
        # same delta-folding for the retry layer's and fault injector's
        # process-wide counters
        self._seen_io_retries = retry.snapshot_stats()["io_retries"]
        self._seen_faults = fault_inject.snapshot_stats()["faults_injected"]
        self._seen_backend = chunk_backend.snapshot_stats()
        # storage degradation: while set, periodic saves skip-and-alert
        # until the cooldown passes (urgent saves ignore it — the notice
        # window is always worth attempting). Capped so fleet members,
        # whose own periodic cadence is disabled (interval=inf, the fleet
        # drives saves), still re-probe storage eventually.
        self.degraded_cooldown_s = min(2.0 * policy.periodic_interval_s, 300.0)
        self._degraded_until: float | None = None
        # metadata-poll degradation: after this many consecutive failed
        # polls (each already retried with backoff), assume the instance is
        # evictable and checkpoint proactively instead of flying blind
        self.assume_evictable_after = 3
        self._poll_fail_streak = 0

    @property
    def time_model(self) -> TimeModel | None:
        return self.ledger.time_model

    # -- lifecycle --------------------------------------------------------------

    def attach_instance(self, metadata: Any, name: str) -> None:
        """Bind to the (new) instance's metadata endpoint after (re)start."""
        self._metadata = metadata
        self._instance_name = name
        self._last_periodic_at = self.clock.now()
        if self.straggler is not None:
            self.straggler.reset()

    def detach(self) -> None:
        """Unbind from a dying instance; starts the MTTR clock."""
        self._metadata = None
        self._instance_name = None
        self._evicted_at = self.clock.now()

    # -- checkpoint actions --------------------------------------------------------

    def _tags(self, **extra) -> dict:
        """Provider/instance provenance recorded in each manifest's extras."""
        tags = {"provider": self.provider.name}
        if self._instance_name is not None:
            tags["instance"] = self._instance_name
        tags.update(extra)
        return tags

    def save_periodic_now(self, step: int, state) -> bool:
        """Take one periodic-style checkpoint immediately (used by the fleet
        coordinator, which owns the cadence across members)."""
        return self._save_periodic(step, state)

    def _account_extract(self, snap: Snapshot | None = None, *,
                         d2h_bytes: int = 0, d2h_skipped: int = 0,
                         stall_s: float = 0.0) -> None:
        """Fold one extract's device→host traffic + stall into stats and the
        ledger's audit trail (observations/counters, never clock charges —
        the modeled extract cost is charged separately by the save paths).
        Pass a Snapshot, or the raw numbers (the urgent path only has a
        CheckpointInfo)."""
        if snap is not None:
            d2h_bytes, d2h_skipped, stall_s = (snap.d2h_bytes,
                                               snap.d2h_skipped, snap.stall_s)
        self.stats.d2h_bytes += d2h_bytes
        self.stats.d2h_bytes_skipped += d2h_skipped
        self.stats.save_stall_s += stall_s
        self.ledger.observe("save_stall", stall_s)
        self.ledger.count("d2h_bytes", d2h_bytes)
        self.ledger.count("d2h_bytes_skipped", d2h_skipped)

    def _drain_async_stats(self) -> None:
        """Fold finished background writes into the stats. Periodic/rebalance
        saves account their *physical* bytes here (delta saves write only
        dirty chunks); urgent saves were accounted synchronously. Also folds
        the codec scheduler's cooperative-yield counter (process-wide) so
        run reports show how often background encodes ceded their worker."""
        yields = codec_sched.snapshot_stats()["yields"]
        delta = yields - self._seen_yields
        if delta > 0:
            self._seen_yields = yields
            self.stats.save_yields += delta
            self.ledger.count("save_yields", delta)
        io_retries = retry.snapshot_stats()["io_retries"]
        delta = io_retries - self._seen_io_retries
        if delta > 0:
            self._seen_io_retries = io_retries
            self.stats.io_retries += delta
            self.ledger.count("io_retries", delta)
        injected = fault_inject.snapshot_stats()["faults_injected"]
        delta = injected - self._seen_faults
        if delta > 0:
            self._seen_faults = injected
            self.stats.faults_injected += delta
            self.ledger.count("faults_injected", delta)
        bstats = chunk_backend.snapshot_stats()
        for key in ("backend_retries", "backend_outages", "spooled_bytes"):
            delta = bstats[key] - self._seen_backend[key]
            if delta > 0:
                self._seen_backend[key] = bstats[key]
                setattr(self.stats, key, getattr(self.stats, key) + delta)
                self.ledger.count(key, delta)
        if self._async is None:
            return
        for info in self._async.drain_completed():
            if info.kind != "termination":
                self.stats.ckpt_bytes_written += info.new_bytes
            if getattr(info, "spooled", False):
                # the save is parked in the outage spool, not committed:
                # enter the same skip-and-alert window a storage fault does
                # (reconcile commits the backlog once the store returns)
                self._mark_degraded(RuntimeError(
                    "object store outage: save spooled locally"))

    def _mark_degraded(self, e: BaseException) -> None:
        self.stats.saves_degraded += 1
        self.ledger.count("saves_degraded", 1)
        self._degraded_until = self.clock.now() + self.degraded_cooldown_s
        log.warning(
            "storage degraded (%s): periodic checkpoints skip-and-alert "
            "for %.0fs; urgent saves still attempt", e,
            self.degraded_cooldown_s)

    def _save_periodic(self, step: int, state, *, stat: str = "periodic") -> bool:
        t0 = self.clock.now()
        if self._degraded_until is not None:
            if t0 < self._degraded_until:
                # skip-and-alert: storage said "full/broken" recently enough
                # that re-encoding the full state would only burn compute.
                # The committed history is intact; count the skip so run
                # reports surface the degradation window.
                self.stats.saves_degraded += 1
                self.ledger.count("saves_degraded", 1)
                self._last_periodic_at = t0
                return False
            self._degraded_until = None  # cooldown over: probe storage again
        # prestage at decision time: with the tracker, fingerprint + diff
        # kernels dispatch now (dirty-block gather instead of full DMAs);
        # without it, the device→host copies start before extract gathers
        state = prestage(state, tracker=(self.delta_tracker
                                         if self.store.mode == "delta"
                                         else None))
        try:
            if self._async is not None:
                snap = self._async.save_async(step, state, kind="transparent",
                                              mesh_info=self.mesh_info,
                                              extra=self._tags(),
                                              tracker=self.delta_tracker)
            else:
                snap = extract_snapshot(
                    state, step=step, mesh_info=self.mesh_info,
                    tracker=(self.delta_tracker
                             if self.store.mode == "delta" else None))
                info = self.store.save_snapshot(snap, kind="transparent",
                                                extra=self._tags())
                self.stats.ckpt_bytes_written += info.new_bytes
                if info.spooled:
                    self._mark_degraded(RuntimeError(
                        "object store outage: save spooled locally"))
        except (RuntimeError, OSError) as e:
            # a failed periodic save must not kill training: the committed
            # history is untouched (atomic commit) and the next cadence
            # retries with fresher state
            log.warning("periodic checkpoint failed: %s", e)
            self.stats.periodic_failures += 1
            self._last_periodic_at = self.clock.now()
            if _storage_fault(e):
                # ENOSPC/EDQUOT/EROFS, or EIO that already exhausted the IO
                # layer's bounded retries: a *state*, not an event — enter
                # the skip-and-alert window instead of re-failing each tick
                self._mark_degraded(e)
            return False
        self._account_extract(snap)
        # the extract leg is charged on the bytes that actually crossed the
        # link (the fingerprint path makes this ≪ state size at low churn);
        # only the write leg is conditional — async overlaps it with
        # training, sync pays it for the dirty chunks (info.new_bytes)
        cost = self.ledger.extract_s(snap.d2h_bytes) + (
            0.0 if self._async is not None
            else self.ledger.write_s(info.new_bytes))
        self.ledger.charge(cost, category="ckpt")
        if stat == "rebalance":
            self.stats.rebalance_ckpts += 1
        else:
            self.stats.periodic_ckpts += 1
        self.stats.ckpt_time_s += (self.clock.now() - t0)
        self._last_periodic_at = self.clock.now()
        return True

    def _save_termination(self, step: int, state, deadline: float) -> bool:
        """Opportunistic: returns False if the notice window was missed."""
        t0 = self.clock.now()
        budget = deadline - t0
        if budget <= 0:
            self.stats.termination_failures += 1
            return False
        # urgent saves bypass the device-delta tracker entirely — the notice
        # window cannot pay digest kernels whose results extract would then
        # discard — so the prestage is the plain full-state copy kick; on a
        # quantize-moments store the moments are left out of it, since the
        # extract quantizes them on the device and copies them at 1/4 width
        state = prestage(state, skip=(is_moment_name
                                      if self.store.quantize_moments else None))
        try:
            if self._async is not None:
                info = self._async.save_urgent(step, state, mesh_info=self.mesh_info,
                                               extra=self._tags(),
                                               timeout_s=max(budget, 0.1))
            else:
                snap = extract_snapshot(state, step=step, mesh_info=self.mesh_info)
                info = self.store.save_snapshot(snap, kind="termination",
                                                extra=self._tags())
        except (TimeoutError, RuntimeError, OSError) as e:
            log.warning("termination checkpoint failed: %s", e)
            self.stats.termination_failures += 1
            return False
        self._account_extract(d2h_bytes=info.d2h_bytes,
                              d2h_skipped=info.d2h_bytes_skipped,
                              stall_s=info.save_stall_ms / 1e3)
        # extract covers the bytes that crossed the device→host link (the
        # full state for urgent saves — at 1/4 width for on-device-quantized
        # moments); the write leg is only the chunks the urgent save
        # actually pushed — unchanged chunks of the last snapshot are reused
        # from the pool, which is what keeps the notice-window write minimal
        # under delta mode
        cost = self.ledger.extract_s(info.d2h_bytes) + self.ledger.write_s(info.new_bytes)
        if self.ledger.time_model is not None and cost > budget:
            # virtual-time world: the write would not have finished in time
            self.ledger.charge(budget, category="ckpt")
            self.stats.termination_failures += 1
            return False
        self.ledger.charge(cost, category="ckpt")
        self.stats.termination_ckpts += 1
        self.stats.ckpt_bytes_written += info.new_bytes
        self.stats.ckpt_time_s += (self.clock.now() - t0)
        return True

    def on_stage_end(self, stage: int, step: int, state) -> None:
        """Application-specific checkpoint point (k-mer stage boundary)."""
        if not self.policy.stage_boundary_enabled:
            return
        t0 = self.clock.now()
        snap = extract_snapshot(state, step=step, mesh_info=self.mesh_info)
        info = self.store.save_snapshot(snap, kind="application",
                                        extra=self._tags(stage=stage))
        self._account_extract(snap)
        # app-specific saves are synchronous in the app's critical path; the
        # write leg is physical bytes so the APPLICATION-vs-TRANSPARENT
        # comparison stays symmetric under a delta-mode store
        self.ledger.charge(self.ledger.extract_s(snap.nbytes)
                           + self.ledger.write_s(info.new_bytes), category="ckpt")
        self.stats.stage_ckpts += 1
        self.stats.ckpt_bytes_written += info.new_bytes
        self.stats.ckpt_time_s += (self.clock.now() - t0)

    # -- the per-step hook ----------------------------------------------------------

    def _poll_notices(self, now: float) -> tuple[PreemptNotice | None,
                                                 PreemptNotice | None]:
        """Provider-normalized poll. Returns (preempt, rebalance) — each the
        first not-yet-handled notice of its kind, or None."""
        if self._metadata is None or now - self._last_poll_at < self.policy.poll_interval_s:
            return None, None
        self._last_poll_at = now
        try:
            # bounded retry with jittered backoff around the endpoint read;
            # clock.sleep keeps the backoff fake-clock-testable (and charged
            # in virtual-time worlds, where waiting is never free)
            notices = retry.call_with_retry(
                lambda: self.provider.poll_once(
                    self._metadata, self._instance_name or "", now),
                policy=retry.POLL_RETRY,
                classify=lambda e: (retry.is_transient(e)
                                    or isinstance(e, TimeoutError)),
                sleep=self.clock.sleep,
                describe=f"{self.provider.name} metadata poll")
        except Exception as e:
            # a notice endpoint that stays down is indistinguishable from an
            # eviction about to happen: degrade conservatively rather than
            # crash the coordinator or fly blind
            self._poll_fail_streak += 1
            self.stats.poll_failures = max(self.stats.poll_failures,
                                           self._poll_fail_streak)
            self.ledger.count("poll_failures", 1)
            log.warning("metadata poll failed (%d consecutive): %s",
                        self._poll_fail_streak, e)
            if self._poll_fail_streak % self.assume_evictable_after == 0:
                synthetic = PreemptNotice(
                    event_id=f"assume-evictable-{self._poll_fail_streak}",
                    deadline=now + self.provider.notice_s,
                    kind=REBALANCE_KIND,
                    raw={"reason": "metadata endpoint unreachable"})
                log.warning("assuming evictable after %d failed polls: "
                            "proactive checkpoint", self._poll_fail_streak)
                return None, synthetic
            return None, None
        self._poll_fail_streak = 0
        preempt = rebalance = None
        for n in notices:
            if n.event_id in self._handled_notices:
                continue
            if n.kind == PREEMPT_KIND and preempt is None:
                preempt = n
            elif n.kind == REBALANCE_KIND and rebalance is None:
                rebalance = n
        return preempt, rebalance

    def on_step_end(self, step: int, state_provider: Callable[[], Any],
                    step_duration_s: float | None = None) -> Signal:
        now = self.clock.now()
        if self._evicted_at is not None:
            # first step completed since the eviction: close the MTTR window
            mttr = now - self._evicted_at
            self.stats.mttr_samples.append(mttr)
            self.ledger.observe("mttr", mttr)
            self._evicted_at = None
        self._drain_async_stats()
        # 1. metadata poll (rate-limited like the paper's curl loop)
        preempt, rebalance = self._poll_notices(now)
        # 2. eviction imminent
        if preempt is not None:
            self._handled_notices.add(preempt.event_id)
            log.info("[%s] preempt notice for %s (deadline=%.1f)",
                     self.provider.name, self._instance_name, preempt.deadline)
            if self.policy.supports_on_demand:
                self._save_termination(step, state_provider(),
                                       deadline=preempt.deadline)
            # app-specific mode cannot act (paper semantics) — work since the
            # last stage boundary will be lost.
            self.provider.acknowledge(self._metadata, preempt)
            return Signal.PREEMPTING
        # 2b. rebalance recommendation (AWS): checkpoint proactively, keep going
        if rebalance is not None:
            self._handled_notices.add(rebalance.event_id)
            if (self.policy.supports_on_demand
                    and self.policy.checkpoint_on_rebalance):
                log.info("[%s] rebalance recommendation for %s: proactive ckpt",
                         self.provider.name, self._instance_name)
                self._save_periodic(step, state_provider(), stat="rebalance")
        # 3. periodic checkpoint
        if (self.policy.periodic_enabled
                and now - self._last_periodic_at >= self.policy.periodic_interval_s):
            self._save_periodic(step, state_provider())
        # 4. straggler policy
        if (self.straggler is not None and step_duration_s is not None
                and self.straggler.observe(step_duration_s)):
            log.warning("instance %s flagged as straggler", self._instance_name)
            if self.policy.supports_on_demand:
                self._save_termination(step, state_provider(),
                                       deadline=self.clock.now() + 3600.0)
            return Signal.STRAGGLER
        return Signal.CONTINUE

    # -- restart ----------------------------------------------------------------------

    def rescale_topology(self, addressable=None) -> dict[str, int]:
        """Elastic topology change: remap the device-delta tracker's
        fingerprints instead of invalidating them (see
        ``DeviceDeltaTracker.rescale``). ``addressable(name, lo, hi,
        total)`` says whether this process still owns a global byte span
        under the new mesh; None = fully-replicated DP, everything
        survives. No-op without a tracker."""
        if self.delta_tracker is None:
            return {"kept": 0, "dropped": 0}
        return self.delta_tracker.rescale(addressable)

    def restore_latest(self, template, *, streaming: bool = True,
                       chunk_pool=None):
        """Most-recent-valid restore; returns (state, manifest) or None.

        ``streaming`` (default) pipelines disk→decode→device transfers —
        bit-identical state, shorter resume leg of the MTTR window. The
        modeled read cost is charged under the ``restore`` category either
        way (the schedule changes, the bytes moved do not); on top of it
        the *measured* wall time of the decode is charged under
        ``restore_wall`` — the restore physically executes even in virtual
        mode, so two restores that contended differently land at different
        clock readings instead of collapsing onto the model's constant.
        The RESTORE-lane scheduler deltas across the call split that wall
        time into queue-wait (starved scheduler) vs decode (slow disk) on
        both ``CoordinatorStats`` and the ledger's observation trail."""
        t0 = self.clock.now()
        sched0 = codec_sched.snapshot_stats()["restore"]
        w0 = _time.perf_counter()
        try:
            state, man = self.store.restore(template, streaming=streaming,
                                            chunk_pool=chunk_pool)
        except FileNotFoundError:
            return None
        wall = _time.perf_counter() - w0
        sched1 = codec_sched.snapshot_stats()["restore"]
        queue_wait = sched1["queue_wait_s"] - sched0["queue_wait_s"]
        decode = sched1["exec_s"] - sched0["exec_s"]
        self.stats.restore_queue_wait_s += queue_wait
        self.stats.restore_decode_s += decode
        self.ledger.observe("restore_queue_wait", queue_wait)
        self.ledger.observe("restore_decode", decode)
        nbytes = sum(t["nbytes"] for t in man.tensors)
        self.ledger.charge(self.ledger.read_s(nbytes), category="restore")
        self.ledger.charge_measured(wall, category="restore_wall")
        self.stats.restores += 1
        self.stats.restore_time_s += (self.clock.now() - t0)
        return state, man

    def flush(self) -> None:
        if self._async is not None:
            try:
                self._async.wait_until_finished()
            except RuntimeError as e:
                log.warning("async checkpoint write failed at flush: %s", e)
                self.stats.periodic_failures += 1
                if _storage_fault(e):
                    self._mark_degraded(e)
            self._drain_async_stats()

    def close(self) -> None:
        if self._async is not None:
            try:
                self._async.close()
            except RuntimeError as e:
                log.warning("async checkpoint write failed at close: %s", e)
                self.stats.periodic_failures += 1
            self._drain_async_stats()
            self._async = None
