"""Deterministic fault plans for the checkpoint IO path.

A :class:`FaultPlan` is a seedable, thread-safe schedule of faults keyed by
*op name* — a short string each instrumented IO site passes to
``faults.inject.fault_point`` / ``faults.inject.write_bytes``. Rules fire on
the Nth matching call and can raise errno faults (EIO, ENOSPC, ...), tear a
write partway through, roll back a rename (modelling a crash before the
directory entry became durable), or abort the process-equivalent with
:class:`SimulatedCrash`.

Instrumented op names (the fault surface):

======================  ======================================================
op                      site
======================  ======================================================
``chunk.write``         chunk-pool tmp-file payload write (torn-capable)
``chunk.fsync``         fsync of the chunk tmp file
``chunk.replace``       before the chunk tmp -> final ``os.replace``
``chunk.replaced``      after that rename (rollback-capable)
``chunk.read``         chunk payload read/decode on the restore path
``manifest.write``      manifest tmp-file write (torn-capable)
``manifest.replace``    before the manifest tmp -> final ``os.replace``
``manifest.replaced``   after that rename (rollback-capable)
``marker.write``        COMMITTED marker write (torn-capable)
``shard.write``         v1 shard container payload write (torn-capable)
``dir.fsync``           ``ioutil.fsync_dir``
``file.mmap``           container mmap on the read path
``store.replace``       before the stage -> final directory rename
``store.replaced``      after that rename (rollback-capable)
``commit.<phase>``      ``store.save_snapshot`` phase boundaries: ``staged``,
                        ``shards_written``, ``manifest_written``,
                        ``uploads_flushed``, ``renamed``, ``committed``
``provider.poll``       cloud metadata poll in the coordinator
``peer.send``           peer chunk server GET send (``crash`` = the serving
                        member dies mid-transfer: half the payload, then EOF)
``peer.fetch``          peer chunk client fetch attempt (errno = unreachable)
``backend.head``        object-store HEAD (errno = endpoint unreachable)
``backend.get``         object-store ranged GET response (``torn`` = the
                        connection died mid-body: a prefix is returned and
                        the content-address check must reject it)
``backend.put``         object-store PUT / multipart part upload (``torn`` =
                        a truncated blob lands under the final key before
                        the sender dies — re-PUT must size-verify, never
                        trust existence)
``backend.complete``    after multipart complete (errno = lost ack, the
                        object IS committed; ``rollback`` = un-commit the
                        blob then crash, the rename-rollback analogue)
======================  ======================================================

Rules match ops by ``fnmatch`` pattern, so ``chunk.*`` targets the whole
chunk-pool commit and ``*`` everything.
"""

from __future__ import annotations

import errno
import fnmatch
import random
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "BACKEND_CRASH_POINTS",
    "COMMIT_CRASH_POINTS",
    "FaultPlan",
    "FaultRule",
    "Injection",
    "SimulatedCrash",
]


class SimulatedCrash(BaseException):
    """Process-kill equivalent injected at a crash point.

    Deliberately a ``BaseException``: no ``except Exception`` cleanup
    handler may tidy up after it, because a real SIGKILL would not run
    that handler either. Anything the crash leaves on disk is exactly the
    debris recovery must tolerate.
    """


_ERRNO_BY_NAME = {
    "eio": errno.EIO,
    "enospc": errno.ENOSPC,
    "edquot": errno.EDQUOT,
    "eagain": errno.EAGAIN,
    "ebusy": errno.EBUSY,
    "etimedout": errno.ETIMEDOUT,
    "erofs": errno.EROFS,
    "estale": getattr(errno, "ESTALE", errno.EIO),
}

#: Enumerated crash points covering ``save_snapshot``'s commit sequence in
#: delta (chunk-pool) mode. The matrix test in ``tests/test_faults.py``
#: aborts a save at each point, reopens the store, and asserts the recovery
#: invariant: ``latest_valid()`` is a bit-identical committed checkpoint
#: (the prior one for every point before the COMMITTED marker), and the
#: next save commits cleanly over the debris.
COMMIT_CRASH_POINTS: Tuple[Tuple[str, str], ...] = (
    ("commit.staged", "crash"),
    ("chunk.write", "torn"),
    ("chunk.write", "crash"),
    ("chunk.fsync", "eio"),
    ("chunk.replace", "crash"),
    ("chunk.replaced", "rollback"),
    ("commit.shards_written", "crash"),
    ("manifest.write", "torn"),
    ("manifest.replace", "crash"),
    ("manifest.replaced", "rollback"),
    ("commit.manifest_written", "crash"),
    ("commit.uploads_flushed", "crash"),
    ("store.replace", "crash"),
    ("store.replaced", "rollback"),
    ("commit.renamed", "crash"),
    ("marker.write", "torn"),
    ("marker.write", "crash"),
    ("commit.committed", "crash"),
)

#: Crash/fault points covering the object-store upload and commit path,
#: exercised by ``tests/test_backend.py`` with an object-store-backed pool.
#: Same invariant as :data:`COMMIT_CRASH_POINTS`: abort (or errno) a save at
#: each point and ``latest_valid()`` stays a bit-identical committed
#: checkpoint — persistent errnos don't fail the save at all, they spool it
#: locally and reconcile when the store returns.
BACKEND_CRASH_POINTS: Tuple[Tuple[str, str], ...] = (
    ("backend.head", "etimedout"),
    ("backend.get", "eio"),
    ("backend.get", "torn"),
    ("backend.put", "eio"),
    ("backend.put", "torn"),
    ("backend.put", "crash"),
    ("backend.complete", "eio"),
    ("backend.complete", "rollback"),
    ("backend.complete", "crash"),
)


@dataclass
class FaultRule:
    """One scheduled fault.

    ``op`` is an fnmatch pattern over op names. The rule arms on the
    ``nth`` (1-based) matching call and stays armed for ``count``
    consecutive matching calls (``count=-1`` = persistent, i.e. every call
    from the nth on — how a dead disk looks, and what exhausts a bounded
    retry). ``error`` selects the behaviour:

    - ``"crash"``    — raise :class:`SimulatedCrash` (process dies here)
    - ``"torn"``     — write a prefix of the payload, then crash
    - ``"rollback"`` — undo the just-completed rename, then crash (a rename
      that never became durable)
    - an errno name (``"eio"``, ``"enospc"``, ...) — raise ``OSError`` with
      that errno, as a flaky/full disk would
    """

    op: str
    nth: int = 1
    count: int = 1
    error: str = "crash"
    path_substr: str = ""
    torn_frac: float = 0.5
    _seen: int = field(default=0, repr=False)

    def matches(self, op: str, path: str) -> bool:
        if not fnmatch.fnmatchcase(op, self.op):
            return False
        return not self.path_substr or self.path_substr in path


@dataclass(frozen=True)
class Injection:
    """What the injector should do at a matched site."""

    action: str  # "crash" | "torn" | "rollback" | "errno"
    err: int = 0
    torn_frac: float = 0.5
    op: str = ""
    path: str = ""

    def to_oserror(self) -> OSError:
        import os

        return OSError(self.err, os.strerror(self.err), self.path or None)


class FaultPlan:
    """Seedable schedule of :class:`FaultRule`\\ s, safe to share across the
    writer/codec threads that execute a save."""

    def __init__(self, rules: Sequence[FaultRule] = (), seed: int = 0):
        self.rules: List[FaultRule] = [FaultRule(**r.__dict__) if isinstance(r, FaultRule) else r
                                       for r in rules]
        self.rng = random.Random(seed)
        self.injected: List[Tuple[str, str, str]] = []  # (action, op, path)
        self.op_counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    def add(self, op: str, **kw: object) -> "FaultPlan":
        self.rules.append(FaultRule(op=op, **kw))  # type: ignore[arg-type]
        return self

    def check(self, op: str, path: str = "") -> Optional[Injection]:
        """Record one call at ``op`` and return the injection to perform,
        if any rule fires."""
        with self._lock:
            self.op_counts[op] = self.op_counts.get(op, 0) + 1
            for rule in self.rules:
                if not rule.matches(op, path):
                    continue
                rule._seen += 1
                if rule._seen < rule.nth:
                    continue
                if rule.count >= 0 and rule._seen >= rule.nth + rule.count:
                    continue
                inj = self._build(rule, op, path)
                self.injected.append((inj.action, op, path))
                return inj
        return None

    def _build(self, rule: FaultRule, op: str, path: str) -> Injection:
        if rule.error in ("crash", "torn", "rollback"):
            return Injection(action=rule.error, torn_frac=rule.torn_frac,
                             op=op, path=path)
        err = _ERRNO_BY_NAME.get(rule.error)
        if err is None:
            raise ValueError(f"unknown fault error kind: {rule.error!r}")
        return Injection(action="errno", err=err, op=op, path=path)

    def fired(self) -> int:
        with self._lock:
            return len(self.injected)
