"""GCP backend — the ``instance/preempted`` metadata flag + MIG pool.

Schema fidelity: GCE exposes

    GET /computeMetadata/v1/instance/preempted -> "FALSE" | "TRUE"

and delivers an ACPI G2 soft-off at preemption start; the VM then has ~30 s
before the hard kill. Unlike Azure/AWS there is **no deadline in the
document** — an agent that observes the flag flip must synthesize its own
budget (observation time + 30 s). The provider therefore keeps per-instance
poll state so repeated polls of the same preemption return one stable notice
(same event id, same deadline) — exactly what a real guest agent does.
"""

from __future__ import annotations

import itertools

from ..cost import GCP_N2_STANDARD_8
from .base import CloudProvider, PlatformEvent, PreemptNotice, PREEMPT_KIND

DEFAULT_NOTICE_S = 30.0  # "Compute Engine gives you 30 seconds"


class SimulatedGceMetadata:
    """Per-instance GCE metadata server, driven by the simulator."""

    def __init__(self, clock, instance_name: str):
        self.clock = clock
        self.instance_name = instance_name
        self._preempted = False
        self._not_before: float | None = None

    # -- coordinator-facing ----------------------------------------------------

    def get_preempted(self) -> str:
        return "TRUE" if self._preempted else "FALSE"

    @property
    def preempt_not_before(self) -> float | None:
        """The platform's actual kill time. A real guest only learns this
        implicitly (ACPI G2 arrival); the simulator exposes it so a late
        poll cannot synthesize budget past the true deadline."""
        return self._not_before

    # -- platform-facing -------------------------------------------------------

    def schedule_preempt(self, *, notice_s: float = DEFAULT_NOTICE_S) -> PlatformEvent:
        self._preempted = True
        self._not_before = self.clock.now() + max(notice_s, DEFAULT_NOTICE_S)
        return PlatformEvent(self._not_before)

    def clear(self) -> None:
        self._preempted = False
        self._not_before = None


class GcpProvider(CloudProvider):
    name = "gcp"
    notice_s = DEFAULT_NOTICE_S
    pool_kind = "managed-instance-group"
    instance_prefix = "gce-"
    prices = GCP_N2_STANDARD_8

    def __init__(self):
        self._seq = itertools.count(1)
        # instance_name -> live notice (stable across polls of one preemption)
        self._active: dict[str, PreemptNotice] = {}

    def make_metadata(self, clock, instance_name: str) -> SimulatedGceMetadata:
        return SimulatedGceMetadata(clock, instance_name)

    def make_pool(self, clock, schedule, accountant=None, **kwargs):
        from ..spot_sim import ManagedInstanceGroup
        kwargs.setdefault("notice_s", self.notice_s)
        return ManagedInstanceGroup(clock=clock, schedule=schedule,
                                    accountant=accountant, provider=self,
                                    **kwargs)

    def poll(self, metadata, instance_name: str, now: float) -> list[PreemptNotice]:
        if metadata.get_preempted() != "TRUE":
            self._active.pop(instance_name, None)
            return []
        notice = self._active.get(instance_name)
        if notice is None:
            # first observation: the agent's budget starts counting NOW —
            # but never past the platform's actual kill time (a poll landing
            # late must not synthesize budget the VM doesn't have)
            deadline = now + self.notice_s
            not_before = getattr(metadata, "preempt_not_before", None)
            if not_before is not None:
                deadline = min(deadline, not_before)
            notice = PreemptNotice(
                event_id=f"gcp-preempt-{next(self._seq):06d}",
                deadline=deadline, kind=PREEMPT_KIND,
                raw={"preempted": "TRUE"})
            self._active[instance_name] = notice
        return [notice]
