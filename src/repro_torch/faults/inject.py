"""Process-wide fault injection points for the checkpoint IO path.

The hot-path contract: with no plan installed, ``fault_point`` is one
global load and a ``None`` check, and ``write_bytes`` degrades to a plain
``f.write``. Install a :class:`~repro_torch.faults.plan.FaultPlan` (usually via
the :func:`active` context manager in tests, or ``SPOTON_FAULTS=1`` torture
suites) and every instrumented site consults it.

Injected-fault totals are process-wide monotonic counters, mirrored into
``CoordinatorStats.faults_injected`` by the coordinator the same way codec
yields are folded.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import IO, Any, Callable, Dict, Iterator, Optional, Tuple, Union

from .plan import FaultPlan, Injection, SimulatedCrash

__all__ = [
    "active",
    "fault_point",
    "install",
    "response_bytes",
    "send_bytes",
    "snapshot_stats",
    "uninstall",
    "write_bytes",
]

_plan: Optional[FaultPlan] = None
_stats_lock = threading.Lock()
_injected_total = 0


def install(plan: FaultPlan) -> None:
    global _plan
    _plan = plan


def uninstall() -> None:
    global _plan
    _plan = None


@contextmanager
def active(plan: FaultPlan) -> Iterator[FaultPlan]:
    """Install ``plan`` for the duration of the block."""
    install(plan)
    try:
        yield plan
    finally:
        uninstall()


def snapshot_stats() -> Dict[str, int]:
    """Monotonic process-wide count of faults injected since import."""
    with _stats_lock:
        return {"faults_injected": _injected_total}


def _count_injection() -> None:
    global _injected_total
    with _stats_lock:
        _injected_total += 1


def _raise_for(inj: Injection) -> None:
    _count_injection()
    if inj.action == "errno":
        raise inj.to_oserror()
    raise SimulatedCrash(f"injected crash at {inj.op} ({inj.path or '?'})")


def fault_point(op: str, path: str = "",
                rollback: Union[Tuple[str, str],
                                Callable[[], None], None] = None) -> None:
    """Consult the installed plan at one IO site.

    ``rollback=(dst, back)`` marks a point immediately *after* an
    ``os.replace`` whose durability is not yet guaranteed: a ``rollback``
    rule undoes the rename (``dst`` -> ``back``) before crashing, modelling
    power loss before the directory entry hit the platter. A zero-arg
    callable serves the same role for non-rename commits — e.g. the
    object-store analogue un-commits the just-completed blob — and runs
    before the crash is raised (OSError from the undo is swallowed, like a
    lost disk would swallow it).
    """
    plan = _plan
    if plan is None:
        return
    inj = plan.check(op, path)
    if inj is None:
        return
    if inj.action == "rollback":
        _count_injection()
        if callable(rollback):
            try:
                rollback()
            except OSError:
                pass
        elif rollback is not None:
            dst, back = rollback
            try:
                # deliberately UN-does a commit-protocol rename (crash
                # simulation) — the durability rules don't apply to it
                os.replace(dst, back)  # spotlint: ignore[SPOT001, SPOT002]
            except OSError:
                pass
        raise SimulatedCrash(f"injected rename rollback at {op} ({inj.path or '?'})")
    _raise_for(inj)


def write_bytes(f: IO[Any], data: Any, *, op: str, path: str = "") -> None:
    """``f.write(data)`` with torn-write capability (bytes or str payloads).

    A ``torn`` rule writes only a prefix (``torn_frac`` of the payload),
    flushes so the partial bytes are really in the file, then crashes —
    the on-disk state a power cut leaves behind mid-write.
    """
    plan = _plan
    if plan is None:
        f.write(data)
        return
    inj = plan.check(op, path)
    if inj is None:
        f.write(data)
        return
    if inj.action == "torn":
        _count_injection()
        cut = max(0, min(len(data), int(len(data) * inj.torn_frac)))
        f.write(data[:cut])
        f.flush()
        raise SimulatedCrash(f"injected torn write at {op} "
                             f"({cut}/{len(data)} bytes, {inj.path or '?'})")
    _raise_for(inj)


def send_bytes(send: Callable[[Any], None], data: Any, *,
               op: str, path: str = "") -> None:
    """``send(data)`` with torn-*request* capability for network writers.

    A ``torn`` rule delivers only a prefix to ``send`` — the bytes that
    made it onto the wire before the sender died — then crashes. Unlike
    :func:`write_bytes` there is no file to flush: whatever the receiver
    committed from the prefix is the debris (e.g. a truncated blob under a
    final object key) that idempotent, size-verified re-upload must repair.
    """
    plan = _plan
    if plan is None:
        send(data)
        return
    inj = plan.check(op, path)
    if inj is None:
        send(data)
        return
    if inj.action == "torn":
        _count_injection()
        cut = max(0, min(len(data), int(len(data) * inj.torn_frac)))
        send(data[:cut])
        raise SimulatedCrash(f"injected torn send at {op} "
                             f"({cut}/{len(data)} bytes, {inj.path or '?'})")
    _raise_for(inj)


def response_bytes(data: bytes, *, op: str, path: str = "") -> bytes:
    """Filter a network *response* payload through the plan.

    A ``torn`` rule returns only a prefix — a connection that died
    mid-body, which the caller's content-address verification must catch
    and turn into a retry (no crash is raised: the *reader* survives a torn
    response, unlike a torn writer). Errno/crash/rollback rules raise.
    """
    plan = _plan
    if plan is None:
        return data
    inj = plan.check(op, path)
    if inj is None:
        return data
    if inj.action == "torn":
        _count_injection()
        cut = max(0, min(len(data), int(len(data) * inj.torn_frac)))
        return data[:cut]
    _raise_for(inj)
    return data  # unreachable: _raise_for always raises
