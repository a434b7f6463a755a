"""Bounded retry with exponential backoff and jitter for primitive IO.

One policy object, one entry point. ``call_with_retry`` retries *transient*
failures (classified by errno — a flaky disk or NFS hiccup) a bounded
number of times with multiplicative backoff and seeded jitter, then
re-raises. Persistent conditions (ENOSPC, EDQUOT, EROFS) and anything
without an errno are never retried: retrying a full disk just burns the
eviction-notice window. ``SimulatedCrash`` is a ``BaseException`` and passes
straight through — a dead process does not retry.

The sleep function is injectable so ``VirtualClock.sleep`` drives
fake-clock tests, and the jitter RNG is injectable for determinism.

Process-wide ``io_retries`` / ``io_giveups`` counters are folded into
``CoordinatorStats`` by the coordinator (same pattern as codec yields).

Keep this module dependency-free (stdlib only): ``repro_torch.checkpoint``
imports it lazily and must not drag in the rest of ``repro_torch.core``.
"""

from __future__ import annotations

import errno
import logging
import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, TypeVar

log = logging.getLogger(__name__)

T = TypeVar("T")

__all__ = [
    "IO_RETRY",
    "POLL_RETRY",
    "RetryPolicy",
    "TRANSIENT_ERRNOS",
    "PERSISTENT_ERRNOS",
    "call_with_retry",
    "is_transient",
    "snapshot_stats",
]

#: Errnos worth a second attempt: the operation may succeed verbatim.
TRANSIENT_ERRNOS = frozenset({
    errno.EIO,
    errno.EAGAIN,
    errno.EBUSY,
    errno.EINTR,
    errno.ETIMEDOUT,
    getattr(errno, "ESTALE", errno.EIO),
    getattr(errno, "ECONNRESET", errno.EIO),
})

#: Errnos that describe a *state*, not an event — retrying cannot help.
PERSISTENT_ERRNOS = frozenset({
    errno.ENOSPC,
    errno.EDQUOT,
    errno.EROFS,
})


def is_transient(exc: BaseException) -> bool:
    """True when the failure is worth retrying verbatim."""
    if isinstance(exc, OSError) and exc.errno is not None:
        return exc.errno in TRANSIENT_ERRNOS
    return False


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff: attempt k sleeps
    ``min(base * multiplier**(k-1), max) * (1 ± jitter)``."""

    max_attempts: int = 3
    base_delay_s: float = 0.02
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5

    def delay_s(self, attempt: int, rng: Optional[random.Random] = None) -> float:
        d = min(self.base_delay_s * self.multiplier ** (attempt - 1),
                self.max_delay_s)
        if self.jitter and rng is not None:
            d *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(d, 0.0)


#: Chunk/manifest writes and reads on the commit path: fail fast enough
#: that an urgent save still fits the eviction-notice window.
IO_RETRY = RetryPolicy(max_attempts=3, base_delay_s=0.02, max_delay_s=0.5)

#: Metadata-endpoint polls: more patient, the poll cadence is seconds.
POLL_RETRY = RetryPolicy(max_attempts=4, base_delay_s=0.2, max_delay_s=5.0)

_stats_lock = threading.Lock()
_io_retries = 0
_io_giveups = 0
_default_rng = random.Random(0x5907)


def snapshot_stats() -> Dict[str, int]:
    """Monotonic process-wide retry counters since import."""
    with _stats_lock:
        return {"io_retries": _io_retries, "io_giveups": _io_giveups}


def _count(retries: int = 0, giveups: int = 0) -> None:
    global _io_retries, _io_giveups
    with _stats_lock:
        _io_retries += retries
        _io_giveups += giveups


def call_with_retry(fn: Callable[[], T], *,
                    policy: RetryPolicy = IO_RETRY,
                    classify: Callable[[BaseException], bool] = is_transient,
                    sleep: Callable[[float], Any] = time.sleep,
                    rng: Optional[random.Random] = None,
                    describe: str = "io op") -> T:
    """Run ``fn`` with bounded retry on transient failures.

    Non-transient exceptions (per ``classify``) re-raise immediately;
    transient ones re-raise after ``policy.max_attempts`` total attempts.
    """
    attempt = 1
    while True:
        try:
            return fn()
        except Exception as exc:
            if not classify(exc):
                raise
            if attempt >= policy.max_attempts:
                _count(giveups=1)
                log.warning("%s: giving up after %d attempts (%s)",
                            describe, attempt, exc)
                raise
            delay = policy.delay_s(attempt, rng if rng is not None
                                   else _default_rng)
            _count(retries=1)
            log.debug("%s: transient failure (%s), retry %d/%d in %.3fs",
                      describe, exc, attempt, policy.max_attempts - 1, delay)
            sleep(delay)
            attempt += 1
