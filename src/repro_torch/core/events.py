"""Cloud metadata 'Scheduled Events' service — faithful to Azure's schema.

The paper's coordinator polls Azure's Scheduled Events endpoint
(``http://169.254.169.254/metadata/scheduledevents``) and reacts to events of
``EventType == "Preempt"`` which carry a ``NotBefore`` at least 30 s in the
future. We reproduce the JSON document shape exactly (DocumentIncarnation +
Events list) so a backend for the real endpoint is a drop-in replacement, and
we provide ``simulate_eviction()`` mirroring ``az vmss simulate-eviction`` —
the paper's own method of triggering evictions for evaluation.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Protocol

from .clock import Clock

PREEMPT = "Preempt"
DEFAULT_NOTICE_S = 30.0  # Azure guarantees a minimum of 30 seconds


@dataclass
class ScheduledEvent:
    event_id: str
    event_type: str              # Preempt | Terminate | Reboot | Freeze
    resources: list[str]
    not_before: float            # clock timestamp (seconds)
    event_status: str = "Scheduled"
    resource_type: str = "VirtualMachine"
    event_source: str = "Platform"
    description: str = ""

    def to_json(self) -> dict:
        return {
            "EventId": self.event_id,
            "EventType": self.event_type,
            "ResourceType": self.resource_type,
            "Resources": list(self.resources),
            "EventStatus": self.event_status,
            "NotBefore": self.not_before,
            "EventSource": self.event_source,
            "Description": self.description,
        }


class MetadataService(Protocol):
    """What the coordinator needs from the cloud. A production backend GETs the
    real non-routable endpoint; the simulator below implements it in-process."""

    def get_scheduled_events(self) -> dict: ...
    def acknowledge_event(self, event_id: str) -> None: ...


class SimulatedMetadataService:
    """Per-instance Scheduled Events document, driven by the simulator."""

    _ids = itertools.count(1)

    def __init__(self, clock: Clock, instance_name: str):
        self.clock = clock
        self.instance_name = instance_name
        self._incarnation = 1
        self._events: list[ScheduledEvent] = []

    # -- coordinator-facing (Azure API shape) --------------------------------

    def get_scheduled_events(self) -> dict:
        return {
            "DocumentIncarnation": self._incarnation,
            "Events": [e.to_json() for e in self._events],
        }

    def acknowledge_event(self, event_id: str) -> None:
        """Azure: POST with StartRequests expedites the event. We mark Started;
        the platform may then act before NotBefore."""
        for e in self._events:
            if e.event_id == event_id:
                e.event_status = "Started"

    # -- platform-facing ------------------------------------------------------

    def schedule_preempt(self, *, notice_s: float = DEFAULT_NOTICE_S) -> ScheduledEvent:
        ev = ScheduledEvent(
            event_id=f"EV-{next(self._ids):06d}",
            event_type=PREEMPT,
            resources=[self.instance_name],
            not_before=self.clock.now() + max(notice_s, DEFAULT_NOTICE_S),
            description="Spot VM is being preempted.",
        )
        self._events.append(ev)
        self._incarnation += 1
        return ev

    def simulate_eviction(self) -> ScheduledEvent:
        """Mirrors ``az vmss simulate-eviction``: same event type and minimum
        notice as a genuine Azure preemption (paper §III-B)."""
        return self.schedule_preempt(notice_s=DEFAULT_NOTICE_S)

    def clear(self) -> None:
        self._events.clear()
        self._incarnation += 1


def first_preempt(document: dict, instance_name: str | None = None) -> dict | None:
    """Extract the first Preempt event addressed to `instance_name` (or any)."""
    for ev in document.get("Events", ()):
        if ev.get("EventType") != PREEMPT:
            continue
        if instance_name is not None and instance_name not in ev.get("Resources", ()):
            continue
        return ev
    return None
