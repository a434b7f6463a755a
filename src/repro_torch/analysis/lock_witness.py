"""Runtime lock-order witness — validate the static lock graph under test.

SPOT030 reasons about a *static* lock graph; this module checks the graph
the code actually exercises. When installed it replaces the
``threading.Lock`` / ``RLock`` / ``Condition`` factories with versions
that, for locks created from repo code (creation-site path filter), return
thin proxies recording per-thread acquisition order. Holding A while
acquiring B adds the observed edge A→B, attributed to the first thread and
creation sites that produced it; at teardown, any pair with both A→B and
B→A observed is an **order inversion** — a deadlock needing only the right
interleaving — and the test session fails.

This is the PyTorch port's witness: it wraps the locks created in the
port's files (``/repro_torch/``) and none of the JAX package's, so it can
run beside that package's own witness, each watching its own locks.

Identity is the lock's *creation site* (file:line of the factory call),
matching SPOT030's creation-site-class keys: every ``CheckpointStore``
instance's ``_commit_lock`` maps to one node, so an inversion between two
store instances is still caught.

``Condition.wait`` is modeled as release + re-acquire: edges into the
condition are re-recorded when the wait returns, and the condition is not
"held" while waiting. Re-entrant acquisition of the same site (RLock, or
two instances from one site) records no self-edge.

Opt-in: ``SPOTON_LOCK_WITNESS=1 pytest -p repro_torch.analysis.pytest_witness
...`` installs it for a whole pytest session (``pytest_witness``); a script
calls ``install_from_env`` or builds a ``LockWitness`` itself.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Callable, Optional


def _default_path_filter(filename: str) -> bool:
    fn = filename.replace(os.sep, "/")
    if fn.endswith("/lock_witness.py"):
        # Never witness the witness: with two witnesses stacked (a
        # test-local one over the env-var global one), the inner factory is
        # called from this file — wrapping there would hand Condition a
        # proxied lock whose ownership fallback misreads RLocks.
        return False
    return "/repro_torch/" in fn or fn.endswith("repro_torch")


class _Held(threading.local):
    def __init__(self) -> None:
        self.stack: list[str] = []


class LockWitness:
    def __init__(self, path_filter: Optional[Callable[[str], bool]] = None):
        self.path_filter = path_filter or _default_path_filter
        self._orig_lock = threading.Lock
        self._orig_rlock = threading.RLock
        self._orig_condition = threading.Condition
        # graph state is shared across threads; guard with an *original*
        # (unwitnessed) lock so the witness never observes itself
        self._graph_lock = self._orig_lock()
        # (held_site, acquired_site) -> description of first occurrence
        self.edges: dict[tuple[str, str], str] = {}
        # creation sites of the locks wrapped so far
        self.sites: set[str] = set()
        self._held = _Held()
        self._installed = False

    # -- bookkeeping ---------------------------------------------------------

    def _creation_site(self, depth: int = 2) -> Optional[str]:
        frame = sys._getframe(depth)
        # Under another witness's factory (the JAX package's, installed
        # later), the caller is that factory: the site is its caller.
        while frame.f_back is not None and frame.f_code.co_filename.replace(
                os.sep, "/").endswith("/lock_witness.py"):
            frame = frame.f_back
        filename = frame.f_code.co_filename
        if not self.path_filter(filename):
            return None
        site = f"{os.path.basename(filename)}:{frame.f_lineno}"
        self.sites.add(site)
        return site

    def _record_acquire(self, site: str) -> None:
        stack = self._held.stack
        if site not in stack:  # re-entrant same-site acquire: no self-edges
            for held in stack:
                key = (held, site)
                if key not in self.edges:
                    desc = (f"thread {threading.current_thread().name!r} "
                            f"acquired {site} while holding {held}")
                    with self._graph_lock:
                        self.edges.setdefault(key, desc)
        stack.append(site)

    def _record_release(self, site: str) -> None:
        stack = self._held.stack
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == site:
                del stack[i]
                return

    # -- results -------------------------------------------------------------

    def inversions(self) -> list[str]:
        with self._graph_lock:
            edges = dict(self.edges)
        out: list[str] = []
        reported: set[frozenset] = set()
        for (a, b), desc in sorted(edges.items()):
            if a == b or frozenset((a, b)) in reported:
                continue
            rev = edges.get((b, a))
            if rev is not None:
                reported.add(frozenset((a, b)))
                out.append(f"lock-order inversion between {a} and {b}:\n"
                           f"  {desc}\n  {rev}")
        return out

    def report(self) -> dict:
        """Sites wrapped, edges seen (``"held -> acquired"``) and
        inversions, as one JSON-ready dict."""
        with self._graph_lock:
            edges = sorted(self.edges)
        return {"sites": len(self.sites),
                "edges": [f"{a} -> {b}" for a, b in edges],
                "inversions": self.inversions()}

    # -- installation --------------------------------------------------------

    def install(self) -> None:
        if self._installed:
            return
        witness = self

        def make_lock(*a, **kw):
            site = witness._creation_site()
            real = witness._orig_lock(*a, **kw)
            return real if site is None else _WitnessLock(real, site, witness)

        def make_rlock(*a, **kw):
            site = witness._creation_site()
            real = witness._orig_rlock(*a, **kw)
            return real if site is None else _WitnessLock(real, site, witness)

        def make_condition(lock=None, *a, **kw):
            site = witness._creation_site()
            if isinstance(lock, _WitnessLock):
                lock = lock._real
            real = witness._orig_condition(lock, *a, **kw)
            return real if site is None \
                else _WitnessCondition(real, site, witness)

        threading.Lock = make_lock  # type: ignore[misc]
        threading.RLock = make_rlock  # type: ignore[misc]
        threading.Condition = make_condition  # type: ignore[misc,assignment]
        self._installed = True

    def uninstall(self) -> None:
        if not self._installed:
            return
        threading.Lock = self._orig_lock  # type: ignore[misc]
        threading.RLock = self._orig_rlock  # type: ignore[misc]
        threading.Condition = self._orig_condition  # type: ignore[misc]
        self._installed = False


class _WitnessLock:
    """Proxy around a real Lock/RLock recording acquisition order."""

    def __init__(self, real, site: str, witness: LockWitness):
        self._real = real
        self._site = site
        self._witness = witness

    def acquire(self, *a, **kw):
        got = self._real.acquire(*a, **kw)
        if got:
            self._witness._record_acquire(self._site)
        return got

    def release(self):
        self._real.release()
        self._witness._record_release(self._site)

    def locked(self):
        return self._real.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<WitnessLock {self._site} {self._real!r}>"


class _WitnessCondition:
    """Proxy around a real Condition; wait() is release + re-acquire."""

    def __init__(self, real, site: str, witness: LockWitness):
        self._real = real
        self._site = site
        self._witness = witness

    def acquire(self, *a, **kw):
        got = self._real.acquire(*a, **kw)
        if got:
            self._witness._record_acquire(self._site)
        return got

    def release(self):
        self._real.release()
        self._witness._record_release(self._site)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def wait(self, timeout=None):
        self._witness._record_release(self._site)
        try:
            return self._real.wait(timeout)
        finally:
            self._witness._record_acquire(self._site)

    def wait_for(self, predicate, timeout=None):
        # delegate to our wait() so held-state stays correct per iteration
        self._witness._record_release(self._site)
        try:
            return self._real.wait_for(predicate, timeout)
        finally:
            self._witness._record_acquire(self._site)

    def notify(self, n=1):
        self._real.notify(n)

    def notify_all(self):
        self._real.notify_all()

    def __repr__(self):
        return f"<WitnessCondition {self._site} {self._real!r}>"


# -- module-level convenience for a whole session (pytest_witness) ------------

_active: LockWitness | None = None


def install_from_env(env_var: str = "SPOTON_LOCK_WITNESS") -> LockWitness | None:
    """Install a process-wide witness when `env_var` is set; idempotent."""
    global _active
    if not os.environ.get(env_var):
        return None
    if _active is None:
        _active = LockWitness()
        _active.install()
    return _active


def active() -> LockWitness | None:
    return _active


def uninstall() -> list[str]:
    """Tear down the process-wide witness; returns observed inversions."""
    global _active
    if _active is None:
        return []
    _active.uninstall()
    inv = _active.inversions()
    _active = None
    return inv
