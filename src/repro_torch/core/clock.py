"""Time sources. Every component takes a Clock so the same code runs either in
real time (integration tests, scaled-interval benchmarks) or in virtual time
(replaying the paper's 60/90-minute eviction intervals in milliseconds)."""

from __future__ import annotations

import time


class Clock:
    def now(self) -> float:
        raise NotImplementedError

    def sleep(self, dt: float) -> None:
        raise NotImplementedError


class WallClock(Clock):
    def now(self) -> float:
        return time.monotonic()

    def sleep(self, dt: float) -> None:
        if dt > 0:
            time.sleep(dt)


class VirtualClock(Clock):
    """Deterministic simulated time; `sleep` advances instantly."""

    def __init__(self, start: float = 0.0):
        self._t = start

    def now(self) -> float:
        return self._t

    def sleep(self, dt: float) -> None:
        self.advance(dt)

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError("time goes forward")
        self._t += dt
