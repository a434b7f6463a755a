"""Azure backend — Scheduled Events + Scale Set (the paper's setup).

The metadata schema lives in ``core/events.py`` (it predates the provider
abstraction and is kept there because the document shape is the paper's
ground truth); this module adapts it to the ``CloudProvider`` interface.
"""

from __future__ import annotations

from ..cost import AZURE_D8S_V3
from ..events import PREEMPT, SimulatedMetadataService
from .base import CloudProvider, PreemptNotice, PREEMPT_KIND


class AzureProvider(CloudProvider):
    name = "azure"
    notice_s = 30.0                    # Azure guarantees >=30 s
    pool_kind = "scale-set"
    instance_prefix = "vm-"
    prices = AZURE_D8S_V3

    def make_metadata(self, clock, instance_name: str) -> SimulatedMetadataService:
        return SimulatedMetadataService(clock, instance_name)

    def make_pool(self, clock, schedule, accountant=None, **kwargs):
        from ..spot_sim import ScaleSet
        kwargs.setdefault("notice_s", self.notice_s)
        return ScaleSet(clock=clock, schedule=schedule, accountant=accountant,
                        provider=self, **kwargs)

    def poll(self, metadata, instance_name: str, now: float) -> list[PreemptNotice]:
        doc = metadata.get_scheduled_events()
        notices = []
        for ev in doc.get("Events", ()):
            if ev.get("EventType") != PREEMPT:
                continue
            if instance_name is not None and instance_name not in ev.get("Resources", ()):
                continue
            notices.append(PreemptNotice(
                event_id=str(ev["EventId"]), deadline=float(ev["NotBefore"]),
                kind=PREEMPT_KIND, raw=ev))
        return notices

    def acknowledge(self, metadata, notice: PreemptNotice) -> None:
        # Azure: POST StartRequests expedites the event (paper §III-B).
        metadata.acknowledge_event(notice.event_id)
