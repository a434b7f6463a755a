"""AWS backend — IMDS spot ``instance-action`` + rebalance recommendation.

Schema fidelity: the real IMDSv2 endpoints are

    GET /latest/meta-data/spot/instance-action
        -> 404 while safe, else {"action": "terminate"|"stop"|"hibernate",
                                 "time": "2026-07-26T12:00:00Z"}  (ISO-8601 UTC)
    GET /latest/meta-data/events/recommendations/rebalance
        -> 404 while safe, else {"noticeTime": "..."}

AWS issues the instance-action exactly two minutes before the interruption;
the rebalance recommendation can arrive arbitrarily earlier and means
"elevated interruption risk" — Spot-on uses it to take a proactive
checkpoint without stopping work. Simulated timestamps map the simulation
clock to the Unix epoch so the ISO strings round-trip exactly like the wire
format.
"""

from __future__ import annotations

from datetime import datetime, timezone
from typing import Any

from ..cost import AWS_M5_2XLARGE
from .base import (CloudProvider, PlatformEvent, PreemptNotice, PREEMPT_KIND,
                   REBALANCE_KIND)

DEFAULT_NOTICE_S = 120.0  # the two-minute warning


def ts_to_iso(ts: float) -> str:
    return datetime.fromtimestamp(ts, tz=timezone.utc).isoformat().replace(
        "+00:00", "Z")


def iso_to_ts(s: str) -> float:
    return datetime.fromisoformat(s.replace("Z", "+00:00")).timestamp()


class SimulatedIMDS:
    """Per-instance IMDS document set, driven by the simulator."""

    def __init__(self, clock, instance_name: str):
        self.clock = clock
        self.instance_name = instance_name
        self._instance_action: dict | None = None
        self._rebalance: dict | None = None

    # -- coordinator-facing (IMDS shapes; None plays the 404) -----------------

    def get_instance_action(self) -> dict | None:
        return self._instance_action

    def get_rebalance_recommendation(self) -> dict | None:
        return self._rebalance

    # -- platform-facing -------------------------------------------------------

    def schedule_preempt(self, *, notice_s: float = DEFAULT_NOTICE_S) -> PlatformEvent:
        not_before = self.clock.now() + max(notice_s, DEFAULT_NOTICE_S)
        self._instance_action = {"action": "terminate",
                                 "time": ts_to_iso(not_before)}
        return PlatformEvent(not_before)

    def announce_rebalance(self) -> None:
        """Idempotent: a recommendation, once issued, stays until the
        instance dies (matches IMDS: the doc persists once present)."""
        if self._rebalance is None:
            self._rebalance = {"noticeTime": ts_to_iso(self.clock.now())}

    def clear(self) -> None:
        self._instance_action = None
        self._rebalance = None


class AwsProvider(CloudProvider):
    name = "aws"
    notice_s = DEFAULT_NOTICE_S
    pool_kind = "auto-scaling-group"
    instance_prefix = "i-"
    prices = AWS_M5_2XLARGE
    rebalance_lead_s = 300.0           # hint ~5 min before the termination

    def make_metadata(self, clock, instance_name: str) -> SimulatedIMDS:
        return SimulatedIMDS(clock, instance_name)

    def make_pool(self, clock, schedule, accountant=None, **kwargs):
        from ..spot_sim import AutoScalingGroup
        kwargs.setdefault("notice_s", self.notice_s)
        kwargs.setdefault("rebalance_lead_s", self.rebalance_lead_s)
        return AutoScalingGroup(clock=clock, schedule=schedule,
                                accountant=accountant, provider=self, **kwargs)

    def poll(self, metadata, instance_name: str, now: float) -> list[PreemptNotice]:
        notices: list[PreemptNotice] = []
        act = metadata.get_instance_action()
        if act is not None:
            notices.append(PreemptNotice(
                event_id=f"aws-{act['action']}-{act['time']}",
                deadline=iso_to_ts(act["time"]), kind=PREEMPT_KIND, raw=act))
        reb = metadata.get_rebalance_recommendation()
        if reb is not None:
            notices.append(PreemptNotice(
                event_id=f"aws-rebalance-{reb['noticeTime']}",
                deadline=iso_to_ts(reb["noticeTime"]), kind=REBALANCE_KIND,
                raw=reb))
        return notices
