"""Spot-instance lifecycle + pool-manager simulator (multi-provider).

Models the slice of a spot cloud the paper depends on:

* a **spot instance** that runs until the platform preempts it — preemption is
  announced through its provider-shaped metadata document with the provider's
  guaranteed notice, then the instance is destroyed at the deadline (all
  un-checkpointed work is lost);
* a **pool manager** that keeps target capacity by provisioning a replacement
  after an eviction (paper §III: "scale sets act as a VM pool manager ...
  capable of restarting new spot instances upon eviction"). ``InstancePool``
  is the generic machinery; ``ScaleSet`` (Azure), ``AutoScalingGroup`` (AWS,
  with advance rebalance recommendations) and ``ManagedInstanceGroup`` (GCP)
  carry per-vendor defaults;
* **eviction schedules** driving when preemptions happen: the paper uses
  fixed 60/90-minute intervals via ``simulate-eviction``; we add Poisson and
  trace-driven schedules for beyond-paper experiments.

Everything is clock-driven (virtual or wall), single-threaded and
deterministic: the workload loop calls ``pool.tick()`` between work quanta.
"""

from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, Protocol

import numpy as np

from .clock import Clock
from .cost import CostAccountant
from .events import DEFAULT_NOTICE_S, SimulatedMetadataService


class InstanceState(enum.Enum):
    PROVISIONING = "provisioning"
    RUNNING = "running"
    EVICTING = "evicting"      # preempt announced, NotBefore not yet reached
    TERMINATED = "terminated"


@dataclass
class SpotInstance:
    name: str
    clock: Clock
    kind: str = "spot"                      # "spot" | "ondemand"
    state: InstanceState = InstanceState.PROVISIONING
    created_at: float = 0.0
    running_since: float | None = None
    terminated_at: float | None = None
    eviction_not_before: float | None = None
    # provider metadata endpoint; any object with schedule_preempt(notice_s=)
    # returning an event carrying .not_before (Azure Scheduled Events by default)
    metadata: Any = None
    metadata_factory: Callable[[Clock, str], Any] | None = None

    def __post_init__(self):
        if self.metadata is None:
            factory = self.metadata_factory or SimulatedMetadataService
            self.metadata = factory(self.clock, self.name)

    # -- platform actions ------------------------------------------------------

    def boot(self) -> None:
        self.state = InstanceState.RUNNING
        self.running_since = self.clock.now()

    def announce_preemption(self, notice_s: float = DEFAULT_NOTICE_S) -> None:
        if self.state is not InstanceState.RUNNING:
            return
        ev = self.metadata.schedule_preempt(notice_s=notice_s)
        self.eviction_not_before = ev.not_before
        self.state = InstanceState.EVICTING

    def tick(self) -> None:
        """Advance lifecycle; destroys the VM once NotBefore is reached."""
        if (self.state is InstanceState.EVICTING
                and self.clock.now() >= self.eviction_not_before):
            self.terminate()

    def terminate(self) -> None:
        if self.state is InstanceState.TERMINATED:
            return
        self.state = InstanceState.TERMINATED
        self.terminated_at = self.clock.now()

    # -- workload-facing -------------------------------------------------------

    @property
    def alive(self) -> bool:
        return self.state in (InstanceState.RUNNING, InstanceState.EVICTING)

    def lifetime_s(self) -> float:
        if self.running_since is None:
            return 0.0
        end = self.terminated_at if self.terminated_at is not None else self.clock.now()
        return end - self.running_since


# ---------------------------------------------------------------------------
# eviction schedules
# ---------------------------------------------------------------------------

class EvictionSchedule(Protocol):
    def eviction_times(self, start: float) -> Iterator[float]: ...


@dataclass(frozen=True)
class NoEviction:
    def eviction_times(self, start: float) -> Iterator[float]:
        return iter(())


@dataclass(frozen=True)
class PeriodicEviction:
    """The paper's evaluation schedule: an eviction every `interval_s`."""

    interval_s: float

    def eviction_times(self, start: float) -> Iterator[float]:
        return (start + self.interval_s * k for k in itertools.count(1))


@dataclass(frozen=True)
class PoissonEviction:
    """Memoryless evictions with mean inter-arrival `mean_interval_s`."""

    mean_interval_s: float
    seed: int = 0

    def eviction_times(self, start: float) -> Iterator[float]:
        rng = np.random.default_rng(self.seed)
        t = start
        while True:
            t += float(rng.exponential(self.mean_interval_s))
            yield t


@dataclass(frozen=True)
class TraceEviction:
    """Replay explicit eviction timestamps (offsets from start)."""

    offsets_s: tuple[float, ...]

    def eviction_times(self, start: float) -> Iterator[float]:
        return (start + o for o in self.offsets_s)


# ---------------------------------------------------------------------------
# pool managers
# ---------------------------------------------------------------------------

@dataclass
class InstancePool:
    """Capacity-1 replacement pool (the paper's setup), provider-generic.

    `hosts_per_instance` models a pod slice: one logical "instance" may stand
    for N accounting units (e.g. 256 chips) so the cost model scales. When a
    ``provider`` (core.providers.CloudProvider) is given, its metadata schema,
    instance-name prefix and notice floor are used; without one the pool
    behaves exactly like the original Azure Scale Set.
    """

    clock: Clock
    schedule: EvictionSchedule
    accountant: CostAccountant | None = None
    kind: str = "spot"                    # instance kind provisioned
    provisioning_delay_s: float = 60.0    # VM create + boot + custom-data
    notice_s: float | None = None         # None -> provider floor (or Azure's)
    hosts_per_instance: int = 1
    provider: Any = None                  # core.providers.CloudProvider | None
    name_prefix: str | None = None        # None -> provider prefix (or "vm-")
    rebalance_lead_s: float = 0.0         # AWS: hint this long before the kill
    _names: Iterator[int] = field(default_factory=lambda: itertools.count(0))
    _eviction_iter: Iterator[float] | None = None
    _next_eviction: float | None = None
    current: SpotInstance | None = None
    evictions_announced: int = 0
    rebalance_recommendations: int = 0
    instances_created: int = 0
    _pending_ready_at: float | None = None

    def __post_init__(self):
        if self.notice_s is None:
            self.notice_s = (self.provider.notice_s if self.provider is not None
                             else DEFAULT_NOTICE_S)
        if self.name_prefix is None:
            self.name_prefix = (self.provider.instance_prefix
                                if self.provider is not None else "vm-")

    def start(self) -> None:
        self._eviction_iter = iter(self.schedule.eviction_times(self.clock.now()))
        self._next_eviction = next(self._eviction_iter, None)
        self._provision()

    def _provision(self) -> None:
        # first boot is immediate-ish; replacements pay provisioning_delay_s
        delay = 0.0 if self.instances_created == 0 else self.provisioning_delay_s
        self._pending_ready_at = self.clock.now() + delay

    def _metadata_factory(self) -> Callable[[Clock, str], Any] | None:
        if self.provider is None:
            return None
        return self.provider.make_metadata

    def tick(self) -> SpotInstance | None:
        """Drive platform events up to `clock.now()`. Returns running instance
        (or None while a replacement is provisioning)."""
        now = self.clock.now()
        # bring up pending instance
        if self.current is None and self._pending_ready_at is not None and now >= self._pending_ready_at:
            name = f"{self.name_prefix}{next(self._names):04d}"
            inst = SpotInstance(name=name, clock=self.clock, kind=self.kind,
                                created_at=now,
                                metadata_factory=self._metadata_factory())
            inst.boot()
            self.current = inst
            self.instances_created += 1
            self._pending_ready_at = None
        inst = self.current
        if inst is None:
            return None
        if self.kind == "spot":
            # advance rebalance hint (AWS): issued `rebalance_lead_s` before
            # the interruption, on metadata services that support it
            if (self.rebalance_lead_s > 0 and self._next_eviction is not None
                    and now >= self._next_eviction - self.rebalance_lead_s):
                announce = getattr(inst.metadata, "announce_rebalance", None)
                if announce is not None and \
                        getattr(inst.metadata, "get_rebalance_recommendation",
                                lambda: None)() is None:
                    announce()
                    self.rebalance_recommendations += 1
            # fire due evictions
            while self._next_eviction is not None and now >= self._next_eviction:
                inst.announce_preemption(notice_s=self.notice_s)
                self.evictions_announced += 1
                self._next_eviction = next(self._eviction_iter, None)
        inst.tick()
        if not inst.alive:
            self._account(inst)
            self.current = None
            self._provision()
            return None
        return inst

    def shutdown(self) -> None:
        """Workload finished: terminate and account the final instance."""
        if self.current is not None:
            self.current.terminate()
            self._account(self.current)
            self.current = None

    def _account(self, inst: SpotInstance) -> None:
        if self.accountant is not None:
            self.accountant.record_instance(inst.kind, inst.lifetime_s(),
                                            count=self.hosts_per_instance)

    # -- helpers ---------------------------------------------------------------

    def wait_for_instance(self) -> SpotInstance:
        """Advance the clock through the provisioning gap if needed."""
        inst = self.tick()
        while inst is None:
            target = self._pending_ready_at
            assert target is not None, "pool stopped without pending instance"
            self.clock.sleep(max(target - self.clock.now(), 0.0) + 1e-9)
            inst = self.tick()
        return inst


@dataclass
class ScaleSet(InstancePool):
    """Azure VM Scale Set — the paper's pool manager (and the default)."""


@dataclass
class AutoScalingGroup(InstancePool):
    """AWS Auto Scaling Group: 120 s instance-action notice plus an advance
    rebalance recommendation `rebalance_lead_s` before the interruption."""

    rebalance_lead_s: float = 300.0


@dataclass
class ManagedInstanceGroup(InstancePool):
    """GCP Managed Instance Group: ~30 s ACPI-G2 preemption notice."""
