"""CloudProvider — everything the coordinator must know about one cloud.

The paper claims Spot-on "is compatible with the major cloud vendors"; what
actually differs between vendors is bundled here:

* the **metadata-service schema** an instance polls (Azure Scheduled Events
  JSON, AWS IMDS ``spot/instance-action`` + rebalance recommendation, GCP's
  ``instance/preempted`` flag),
* the **notice semantics** — guaranteed minimum warning before the kill
  (Azure >=30 s, AWS 120 s, GCP ~30 s) and whether an advance *rebalance*
  hint exists (AWS only),
* the **pool-manager behavior** that replaces evicted capacity (Scale Set /
  Auto Scaling Group / Managed Instance Group),
* the **price sheet** for cost accounting.

``poll`` normalizes whatever the vendor document looks like into
``PreemptNotice`` records, so the coordinator never parses vendor JSON.
Adding a fourth backend = subclass ``CloudProvider``, implement the four
factory/parse methods, register it in ``PROVIDERS``.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Any

from ..cost import PriceSheet

PREEMPT_KIND = "preempt"        # capacity will be taken: hard deadline
REBALANCE_KIND = "rebalance"    # elevated risk hint: checkpoint proactively


@dataclass(frozen=True)
class PlatformEvent:
    """What a simulated metadata service's ``schedule_preempt`` returns to
    the platform simulator: the actual kill time."""

    not_before: float


@dataclass(frozen=True)
class PreemptNotice:
    """Vendor-neutral eviction signal.

    ``event_id`` is stable across polls of the same underlying event (dedup
    key), ``deadline`` is a clock timestamp after which the instance may be
    destroyed. ``kind`` is PREEMPT_KIND or REBALANCE_KIND; a rebalance
    carries no kill guarantee — its deadline is informational.
    """

    event_id: str
    deadline: float
    kind: str = PREEMPT_KIND
    raw: dict = field(default_factory=dict)


class CloudProvider(abc.ABC):
    """One cloud vendor's spot semantics. Stateless where the vendor is
    stateless; providers that must synthesize deadlines (GCP) may keep
    per-instance poll state."""

    name: str = "abstract"
    notice_s: float = 30.0              # guaranteed minimum eviction notice
    pool_kind: str = "pool"             # human name of the pool manager
    instance_prefix: str = "vm-"
    prices: PriceSheet
    rebalance_lead_s: float = 0.0       # advance rebalance hint (AWS only)

    # -- factories -------------------------------------------------------------

    @abc.abstractmethod
    def make_metadata(self, clock, instance_name: str):
        """In-process simulator of this vendor's metadata endpoint."""

    @abc.abstractmethod
    def make_pool(self, clock, schedule, accountant=None, **kwargs):
        """Replacement-provisioning pool with this vendor's defaults."""

    # -- coordinator-facing ----------------------------------------------------

    @abc.abstractmethod
    def poll(self, metadata, instance_name: str, now: float) -> list[PreemptNotice]:
        """Read the metadata document(s) and normalize into notices.

        Preempt notices must precede rebalance notices in the returned list;
        the coordinator acts on the first unhandled one of each kind.
        """

    def poll_once(self, metadata, instance_name: str,
                  now: float) -> list[PreemptNotice]:
        """One fallible poll attempt: the coordinator's retry/degradation
        wrapper calls this, and the ``provider.poll`` fault point lets a
        FaultPlan stand in for a flaky metadata endpoint (a real endpoint
        surfaces as OSError/TimeoutError from the HTTP layer)."""
        from ... import faults

        faults.fault_point("provider.poll", instance_name or self.name)
        return self.poll(metadata, instance_name, now)

    def acknowledge(self, metadata, notice: PreemptNotice) -> None:
        """Vendor-specific ack (Azure StartRequests). Default: no-op."""

    # -- evaluation helpers ----------------------------------------------------

    def simulate_eviction(self, metadata) -> Any:
        """Trigger an eviction through the vendor's own mechanism (the paper
        uses ``az vmss simulate-eviction``; AWS/GCP analogues exist)."""
        return metadata.schedule_preempt(notice_s=self.notice_s)
