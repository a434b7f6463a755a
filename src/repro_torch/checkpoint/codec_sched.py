"""Priority-aware codec scheduler — restore QoS on one shared worker pool.

The checkpoint layer used to run two flat ``ThreadPoolExecutor``s: a shared
encode/decode pool and a reserved "urgent" pool for termination saves. That
layout had the right instinct (the eviction-notice window must not queue
behind periodic traffic) and the wrong mechanism everywhere else: restore —
the MTTR window, the reason the framework exists — was a fair-share peer of
background save encodes, and measured restore throughput collapsed ~7x the
moment a single concurrent writer was saving into the same pool
(``BENCH_resume.json``: 1.87 GB/s idle → 0.27 GB/s under one writer).

This module replaces both pools with **one** worker pool fed by a
strict-priority queue with three lanes::

    URGENT   (0)  termination-save encodes — the eviction notice pays for
                  every queued task, nothing may sit in front of them
    RESTORE  (1)  restore/decode jobs — the MTTR window
    PERIODIC (2)  periodic-save encodes — background work; yields between
                  chunks (below) so it can be preempted mid-piece

Two mechanisms give restore its QoS:

* **Queue jumping** — workers always pop the highest-priority job available
  (FIFO within a lane), so a restore submitted while periodic encodes are
  queued runs before all of them. One pool, not two: folding the old
  reserved urgent executor into the URGENT lane means an urgent save no
  longer competes with a second pool for the same physical cores.
* **Cooperative preemption** — queue jumping alone cannot reclaim workers
  already *inside* a long periodic encode. Encode jobs are chunk-granular
  loops (``store_payload_chunks``, ``write_delta_blocks_piece``), so between
  chunks they call ``maybe_yield()``: a worker running a PERIODIC job pops
  and executes queued higher-priority jobs inline until none remain, then
  resumes its encode. Preemption latency is bounded by one chunk's encode
  (~1 MiB hash+compress+write), not one piece's. URGENT and RESTORE jobs
  never yield — ``maybe_yield`` is a no-op unless the current job is
  PERIODIC — so the eviction window and the restore path keep their latency.

Scheduling is observable: per-lane counters (jobs, queue-wait seconds, exec
seconds — exec excludes time spent running helped jobs, so lane totals don't
double-count) plus a global yield count, snapshot via ``snapshot_stats``.
The coordinator folds these into ``CoordinatorStats``/``TimeLedger`` so a
slow restore is attributable: queue-wait says "starved scheduler", exec says
"slow disk".

Worker threads are daemon (interpreter exit can never hang on a stuck 9p
fsync) and the process-wide scheduler registers an ``atexit`` shutdown that
cancels queued work and joins briefly — the old module-global executors were
leaked, and their non-daemon workers could hang exit after a failed
benchmark run.
"""

from __future__ import annotations

import atexit
import heapq
import itertools
import os
import threading
import time
from concurrent.futures import Future

URGENT = 0
RESTORE = 1
PERIODIC = 2

LANE_NAMES = {URGENT: "urgent", RESTORE: "restore", PERIODIC: "periodic"}

# the scheduler currently executing a job on this thread (any instance, not
# just the process-wide one) — lets chunk loops call the module-level
# maybe_yield() without knowing which scheduler their job came from
_ACTIVE = threading.local()


class _Job:
    __slots__ = ("prio", "seq", "fn", "args", "kwargs", "future", "t_submit")

    def __init__(self, prio: int, seq: int, fn, args, kwargs):
        self.prio = prio
        self.seq = seq
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.future: Future = Future()
        self.t_submit = time.perf_counter()

    def __lt__(self, other: "_Job") -> bool:
        # strict priority, FIFO within a lane
        return (self.prio, self.seq) < (other.prio, other.seq)


class CodecScheduler:
    """One worker pool, three strict-priority lanes, cooperative yields."""

    def __init__(self, max_workers: int):
        self.max_workers = max_workers
        self._cond = threading.Condition()
        self._heap: list[_Job] = []
        self._seq = itertools.count()
        self._threads: list[threading.Thread] = []
        self._idle = 0
        self._shutdown = False
        self._tls = threading.local()
        self._stats = {name: {"submitted": 0, "completed": 0,
                              "queue_wait_s": 0.0, "exec_s": 0.0}
                       for name in LANE_NAMES.values()}
        self._yields = 0

    # -- submission ---------------------------------------------------------

    def submit(self, priority: int, fn, /, *args, **kwargs) -> Future:
        if priority not in LANE_NAMES:
            raise ValueError(f"unknown codec priority {priority!r}")
        with self._cond:
            if not self._shutdown:
                job = _Job(priority, next(self._seq), fn, args, kwargs)
                heapq.heappush(self._heap, job)
                self._stats[LANE_NAMES[priority]]["submitted"] += 1
                if self._idle > 0:
                    self._cond.notify()
                elif len(self._threads) < self.max_workers:
                    t = threading.Thread(
                        target=self._worker, daemon=True,
                        name=f"spoton-codec-{len(self._threads)}")
                    self._threads.append(t)
                    t.start()
                return job.future
        if priority != URGENT:
            raise RuntimeError("codec scheduler is shut down")
        # URGENT work is a termination save racing interpreter teardown:
        # the atexit hook has already shut the lane workers down, but the
        # eviction-notice checkpoint must still become durable. Run the job
        # inline on the submitter's thread and hand back a completed
        # future — the caller sees the same submit/result contract.
        with self._cond:
            self._stats[LANE_NAMES[URGENT]]["submitted"] += 1
        job = _Job(URGENT, next(self._seq), fn, args, kwargs)
        self._run(job)
        return job.future

    # -- workers ------------------------------------------------------------

    def _worker(self) -> None:
        while True:
            with self._cond:
                while not self._heap and not self._shutdown:
                    self._idle += 1
                    self._cond.wait()
                    self._idle -= 1
                if not self._heap:
                    return            # shutdown and nothing left to drain
                job = heapq.heappop(self._heap)
            self._run(job)

    def _run(self, job: _Job) -> None:
        if not job.future.set_running_or_notify_cancel():
            return                    # cancelled while queued
        t0 = time.perf_counter()
        prev_prio = getattr(self._tls, "prio", None)
        prev_sched = getattr(_ACTIVE, "sched", None)
        # child_s accumulates helped-job wall time so a yielding PERIODIC
        # job's own exec excludes the restores it ran inline
        prev_child = getattr(self._tls, "child_s", 0.0)
        self._tls.prio = job.prio
        self._tls.child_s = 0.0
        _ACTIVE.sched = self
        try:
            result = job.fn(*job.args, **job.kwargs)
        except BaseException as e:
            job.future.set_exception(e)
        else:
            job.future.set_result(result)
        finally:
            dt = time.perf_counter() - t0
            self_dt = dt - self._tls.child_s
            self._tls.prio = prev_prio
            self._tls.child_s = prev_child + dt
            _ACTIVE.sched = prev_sched
            with self._cond:
                st = self._stats[LANE_NAMES[job.prio]]
                st["completed"] += 1
                st["queue_wait_s"] += t0 - job.t_submit
                st["exec_s"] += self_dt

    # -- cooperative preemption ---------------------------------------------

    def maybe_yield(self, *, limit: int | None = None) -> int:
        """Chunk-granular preemption checkpoint for PERIODIC encode jobs.

        Called between chunks by the encode loops: if this thread is a
        worker running a PERIODIC job and higher-priority work is queued,
        pop and run it inline until the queue holds nothing more urgent
        than the caller. No-op (and free) on every other thread/priority —
        URGENT and RESTORE jobs never yield. Returns jobs helped.
        """
        cur = getattr(self._tls, "prio", None)
        if cur is None or cur <= RESTORE or not self._heap:
            return 0                  # racy heap peek: worst case we miss
        ran = 0                       # one yield window, caught next chunk
        while limit is None or ran < limit:
            with self._cond:
                if (self._shutdown or not self._heap
                        or self._heap[0].prio >= cur):
                    break
                job = heapq.heappop(self._heap)
            self._run(job)
            ran += 1
        if ran:
            with self._cond:
                self._yields += ran
        return ran

    # -- observability ------------------------------------------------------

    def snapshot_stats(self) -> dict:
        with self._cond:
            out: dict = {name: dict(st) for name, st in self._stats.items()}
            out["yields"] = self._yields
            out["queued"] = len(self._heap)
            return out

    # -- lifecycle ----------------------------------------------------------

    def shutdown(self, *, wait: bool = True, timeout: float | None = None,
                 cancel_pending: bool = False) -> None:
        with self._cond:
            self._shutdown = True
            pending: list[_Job] = []
            urgent: list[_Job] = []
            if cancel_pending:
                drained, self._heap = self._heap, []
                for job in drained:
                    (urgent if job.prio == URGENT else pending).append(job)
            self._cond.notify_all()
        # never cancel URGENT jobs: they are termination-save encodes, and a
        # save_urgent racing the atexit shutdown must still reach its
        # COMMITTED rename. Drain them inline (lane FIFO order) on this
        # thread; only periodic/restore work is discarded.
        for job in sorted(urgent, key=lambda j: j.seq):
            self._run(job)
        for job in pending:
            job.future.cancel()
        if wait:
            deadline = (None if timeout is None
                        else time.monotonic() + timeout)
            for t in self._threads:
                t.join(timeout=None if deadline is None
                       else max(0.0, deadline - time.monotonic()))


class CodecLane:
    """Executor-shaped view of one scheduler lane: ``submit`` binds the
    lane's priority, so every existing ``executor.submit(...)`` call site
    (and ``concurrent.futures.wait`` on the returned futures) works
    unchanged while the work lands in the right queue."""

    __slots__ = ("scheduler", "priority")

    def __init__(self, scheduler: CodecScheduler, priority: int):
        self.scheduler = scheduler
        self.priority = priority

    def submit(self, fn, /, *args, **kwargs) -> Future:
        return self.scheduler.submit(self.priority, fn, *args, **kwargs)


# ---------------------------------------------------------------------------
# process-wide scheduler
# ---------------------------------------------------------------------------

_sched: CodecScheduler | None = None
_sched_lock = threading.Lock()


def _default_workers() -> int:
    # cores + 2: codec jobs interleave GIL-releasing compute (hash/crc/
    # compress) with file IO, so slight oversubscription hides syscall
    # stalls without thrashing small boxes
    return min(8, (os.cpu_count() or 2) + 2)


def scheduler() -> CodecScheduler:
    """The process-wide codec scheduler, shared by every store. Lazily
    created; an ``atexit`` hook cancels queued work and joins the (daemon)
    workers so a failed run can never hang interpreter exit."""
    global _sched
    if _sched is None:
        with _sched_lock:
            if _sched is None:
                s = CodecScheduler(max_workers=_default_workers())
                atexit.register(s.shutdown, wait=True, timeout=10.0,
                                cancel_pending=True)
                _sched = s
    return _sched


def lane(priority: int) -> CodecLane:
    return CodecLane(scheduler(), priority)


def _reset_for_tests() -> None:
    """Tear down the process-wide scheduler so the next ``scheduler()``
    call builds a fresh one. Test-only: regression tests for the
    shutdown/teardown races need to shut the global instance down and then
    restore a working scheduler for the rest of the suite."""
    global _sched
    with _sched_lock:
        s, _sched = _sched, None
    if s is not None:
        atexit.unregister(s.shutdown)
        s.shutdown(wait=True, timeout=5.0, cancel_pending=True)


def maybe_yield() -> int:
    """Module-level preemption checkpoint: dispatches to whichever scheduler
    is executing a job on this thread (the process-wide one in production;
    a private instance under test). Free no-op everywhere else."""
    s = getattr(_ACTIVE, "sched", None)
    return 0 if s is None else s.maybe_yield()


_ZERO_LANE = {"submitted": 0, "completed": 0, "queue_wait_s": 0.0,
              "exec_s": 0.0}


def snapshot_stats() -> dict:
    """Stats snapshot without forcing the scheduler into existence (readers
    like the coordinator must not spin up worker state just to report 0)."""
    s = _sched
    if s is None:
        out: dict = {name: dict(_ZERO_LANE) for name in LANE_NAMES.values()}
        out["yields"] = 0
        out["queued"] = 0
        return out
    return s.snapshot_stats()
