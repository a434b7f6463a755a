"""Multihost-style synchronization with an in-process simulation mode.

``sync_global_devices(name)`` blocks every participant until all of them
reach the same named point (the reference's
``jax.experimental.multihost_utils.sync_global_devices``). Three backends,
picked automatically:

* **simulated** — when a ``SimulatedBarrier`` is installed (via
  ``use_simulated_barrier``), participants are *threads* of one process.
  This is how CPU tests exercise the pod-restore rendezvous: N fleet members
  run restore concurrently and none may take its first step until every
  member has materialized its shards.
* **a process group of more than one rank** — ``dist.monitored_barrier``
  with a time limit: a rank that never arrives makes the others raise,
  never hang (gloo; every collective of the multi-device layer runs on CPU
  tensors or Python objects).
* **single process, no simulation** — a no-op; there is nobody to wait for.

The simulated barrier is keyed by name so distinct sync points never
release each other, and each named ``threading.Barrier`` is cyclic, so the
same name can be reused across restore attempts.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from datetime import timedelta

import torch.distributed as dist

__all__ = ["BARRIER_TIMEOUT_S", "SimulatedBarrier", "install_simulated_barrier",
           "new_group", "process_count", "process_index",
           "sync_global_devices", "use_simulated_barrier"]

BARRIER_TIMEOUT_S = 120.0


class SimulatedBarrier:
    """In-process stand-in for the multihost barrier: ``parties`` threads
    rendezvous per sync-point name. A timeout turns a lost participant into
    a loud ``RuntimeError`` instead of a silent hang."""

    def __init__(self, parties: int, *, timeout_s: float = 60.0):
        if parties < 1:
            raise ValueError("barrier needs at least one party")
        self.parties = parties
        self.timeout_s = timeout_s
        self._lock = threading.Lock()
        self._barriers: dict[str, threading.Barrier] = {}

    def _barrier_for(self, name: str) -> threading.Barrier:
        with self._lock:
            b = self._barriers.get(name)
            if b is None:
                b = self._barriers[name] = threading.Barrier(self.parties)
            return b

    def wait(self, name: str) -> None:
        try:
            self._barrier_for(name).wait(timeout=self.timeout_s)
        except threading.BrokenBarrierError:
            raise RuntimeError(
                f"simulated multihost barrier {name!r} broken: a participant "
                f"crashed or missed the {self.timeout_s}s rendezvous window"
            ) from None


_sim_lock = threading.Lock()
_simulated: SimulatedBarrier | None = None


def install_simulated_barrier(barrier: SimulatedBarrier | None) -> None:
    global _simulated
    with _sim_lock:
        _simulated = barrier


@contextmanager
def use_simulated_barrier(barrier: SimulatedBarrier):
    """Route ``sync_global_devices`` through ``barrier`` for the duration.

    Install once in the main thread *before* spawning the participant
    threads; the participants themselves only call ``sync_global_devices``.
    """
    install_simulated_barrier(barrier)
    try:
        yield barrier
    finally:
        install_simulated_barrier(None)


def process_count() -> int:
    """Ranks of the process group, 1 when none is up."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank, 0 when no process group is up."""
    return dist.get_rank() if dist.is_initialized() else 0


def new_group():
    """A gloo group of every rank, its waits bounded by ``BARRIER_TIMEOUT_S``.
    Collective: every rank makes its groups in the same order."""
    return dist.new_group(backend="gloo",
                          timeout=timedelta(seconds=BARRIER_TIMEOUT_S))


def sync_global_devices(name: str, group=None) -> None:
    """Block until every participant reaches the sync point ``name`` (in a
    process group, every rank of ``group``, the default group when None);
    raise when one has not arrived within ``BARRIER_TIMEOUT_S``."""
    with _sim_lock:
        sim = _simulated
    if sim is not None:
        sim.wait(name)
        return
    if process_count() > 1:
        try:
            dist.monitored_barrier(group=group,
                                   timeout=timedelta(seconds=BARRIER_TIMEOUT_S),
                                   wait_all_ranks=True)
        except RuntimeError as e:
            raise RuntimeError(f"multihost barrier {name!r} broken: {e}") from e
