"""TimeModel + TimeLedger — one place where modeled durations meet the clock.

The coordinator and trainer both need to charge virtual time: checkpoint
extract/write/read costs, per-step compute. Before this module each charged
the clock ad hoc (``isinstance(clock, VirtualClock)`` checks sprinkled through
coordinator and trainer); the ledger centralizes the rule and keeps an audit
trail of what was charged per category, which the fleet coordinator uses to
attribute time across members sharing one clock.

Wall-clock mode: charges are no-ops — durations are physical, the clock moves
by itself. Virtual mode: ``charge`` advances the VirtualClock and records the
amount under its category.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .clock import Clock, VirtualClock


@dataclass(frozen=True)
class TimeModel:
    """Virtual-time cost of checkpoint operations, by bytes moved."""

    extract_bw: float = 10e9     # device->host snapshot bandwidth
    write_bw: float = 0.5e9      # shared-NFS write bandwidth
    read_bw: float = 1.0e9       # shared-NFS read bandwidth
    latency_s: float = 2.0       # per-op fixed cost (mount, metadata, commit)

    def extract_s(self, nbytes: int) -> float:
        return nbytes / self.extract_bw

    def write_s(self, nbytes: int) -> float:
        return self.latency_s + nbytes / self.write_bw

    def read_s(self, nbytes: int) -> float:
        return self.latency_s + nbytes / self.read_bw


@dataclass
class TimeLedger:
    """Charges modeled durations to a clock and accounts them by category.

    Besides *charges* (which advance a VirtualClock), the ledger keeps
    *observations*: measured windows — MTTR, the eviction→first-step-back
    span — whose time already elapsed on the clock and must not be charged
    again, but which belong in the same audit trail.
    """

    clock: Clock
    time_model: TimeModel | None = None
    charged: dict[str, float] = field(default_factory=dict)
    observed: dict[str, list[float]] = field(default_factory=dict)
    counted: dict[str, int] = field(default_factory=dict)

    @property
    def virtual(self) -> bool:
        return isinstance(self.clock, VirtualClock)

    # -- modeled costs (0.0 when no model is configured) ----------------------

    def extract_s(self, nbytes: int) -> float:
        return self.time_model.extract_s(nbytes) if self.time_model else 0.0

    def write_s(self, nbytes: int) -> float:
        return self.time_model.write_s(nbytes) if self.time_model else 0.0

    def read_s(self, nbytes: int) -> float:
        return self.time_model.read_s(nbytes) if self.time_model else 0.0

    # -- charging -------------------------------------------------------------

    def charge(self, seconds: float, *, category: str = "ckpt") -> float:
        """Advance a VirtualClock by a modeled duration; no-op on wall clocks
        or when no TimeModel is configured (physics charges those)."""
        if seconds <= 0.0 or self.time_model is None or not self.virtual:
            return 0.0
        self.clock.advance(seconds)
        self.charged[category] = self.charged.get(category, 0.0) + seconds
        return seconds

    def charge_measured(self, seconds: float, *, category: str) -> float:
        """Advance a VirtualClock by a *measured* wall duration.

        For work that physically executes even under a virtual clock —
        the restore decode really reads the disk and really contends with
        real writer threads. Charging the measured wall time instead of a
        byte-count model makes virtual-mode samples (MTTR above all)
        wall-clock-coupled: two restores that ran at different speeds land
        at different clock readings instead of collapsing onto the model's
        constant. Needs no TimeModel; no-op on wall clocks (the duration
        already elapsed there)."""
        if seconds <= 0.0 or not self.virtual:
            return 0.0
        self.clock.advance(seconds)
        self.charged[category] = self.charged.get(category, 0.0) + seconds
        return seconds

    def charge_step(self, step_time_s: float | None) -> float:
        """Charge one training step's modeled duration (virtual mode only).
        Unlike ``charge`` this needs no TimeModel — step cost is given."""
        if step_time_s is None or not self.virtual:
            return 0.0
        self.clock.advance(step_time_s)
        self.charged["step"] = self.charged.get("step", 0.0) + step_time_s
        return step_time_s

    # -- observations ---------------------------------------------------------

    def observe(self, category: str, seconds: float) -> None:
        """Record a measured window (e.g. one MTTR sample) without moving
        the clock — the duration already elapsed; charging it again would
        double-count it."""
        self.observed.setdefault(category, []).append(seconds)

    def observed_total(self, category: str) -> float:
        return sum(self.observed.get(category, ()))

    # -- counters -------------------------------------------------------------

    def count(self, category: str, amount: int) -> None:
        """Accumulate a unitless quantity (bytes moved, bytes skipped) in the
        audit trail. Counters never touch the clock — they exist so the
        save path's device→host traffic (``d2h_bytes`` vs
        ``d2h_bytes_skipped``) is visible in the same ledger that accounts
        its time."""
        self.counted[category] = self.counted.get(category, 0) + int(amount)

    def counted_total(self, category: str) -> int:
        return self.counted.get(category, 0)

    def total(self, category: str | None = None) -> float:
        if category is not None:
            return self.charged.get(category, 0.0)
        return sum(self.charged.values())
