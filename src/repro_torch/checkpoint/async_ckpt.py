"""Asynchronous checkpointing — overlap checkpoint IO with training compute.

The trainer blocks only on ``extract_snapshot`` (device→host copy at a step
boundary); encoding + file IO run on a daemon writer thread. This is the
distributed-training analogue of CRIU's brief stop-the-world followed by
background page writeout, and it is what makes *frequent* transparent
checkpoints affordable (the paper's 10/15-minute cadence at near-zero overhead,
Table I rows 1–2).

Termination checkpoints (eviction notice received) use ``save_urgent``: the
pending queue is drained/discarded in favour of the newest state and the call
blocks until the checkpoint is durably committed — the best-effort window is
the eviction notice (≥30 s), so latency, not overlap, is the goal there.

With a delta-mode store both paths are incremental: a periodic save writes
only chunks dirtied since the last committed state, and an urgent save reuses
every unchanged chunk of the last snapshot already in the pool — the
notice-window write is the churn since the previous checkpoint, not the full
state. Completed writes are published via ``drain_completed`` so the
coordinator can account *physical* bytes (``CheckpointInfo.new_bytes``)
without blocking on the writer thread.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any, Callable

from . import serialize as ser
from . import sharded
from .store import CheckpointInfo, CheckpointStore


@dataclass
class _Job:
    snapshot: sharded.Snapshot
    kind: str
    extra: dict | None
    done: threading.Event
    result: CheckpointInfo | None = None
    error: BaseException | None = None


class AsyncCheckpointer:
    def __init__(self, store: CheckpointStore, *, max_pending: int = 2):
        self.store = store
        self._queue: queue.Queue[_Job | None] = queue.Queue(maxsize=max_pending)
        self._lock = threading.Lock()
        self._last_error: BaseException | None = None
        self._inflight: _Job | None = None
        self._completed: list[CheckpointInfo] = []
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="spoton-ckpt-writer")
        self._thread.start()

    # -- worker ----------------------------------------------------------------

    def _worker(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                return
            with self._lock:
                self._inflight = job
            try:
                job.result = self.store.save_snapshot(
                    job.snapshot, kind=job.kind, extra=job.extra)
                with self._lock:
                    self._completed.append(job.result)
            except BaseException as e:  # surfaced on next call / wait
                job.error = e
                with self._lock:
                    self._last_error = e
            finally:
                with self._lock:
                    self._inflight = None
                job.done.set()
                self._queue.task_done()

    def _raise_pending_error(self) -> None:
        with self._lock:
            err, self._last_error = self._last_error, None
        if err is None:
            return
        if not isinstance(err, Exception):
            # a process-kill equivalent (torture harness SimulatedCrash,
            # KeyboardInterrupt) observed on the writer thread: re-raise
            # as itself — wrapping it in RuntimeError would downgrade a
            # crash into a recoverable periodic-save failure
            raise err
        raise RuntimeError("async checkpoint write failed") from err

    # -- API -------------------------------------------------------------------

    def save_async(self, step: int, state, *, kind: str = "transparent",
                   mesh_info: dict | None = None, extra: dict | None = None,
                   tracker=None) -> sharded.Snapshot:
        """Snapshot now (blocking, cheap), write in background (backpressured).

        With a ``tracker`` (device-delta, delta-mode stores) the extract leg
        moves only fingerprint-dirty blocks device→host; the tracker's
        commit bookkeeping runs on this writer thread once the store marks
        the checkpoint COMMITTED."""
        self._raise_pending_error()
        snap = sharded.extract_snapshot(
            state, step=step, mesh_info=mesh_info,
            tracker=tracker if self.store.mode == "delta" else None)
        job = _Job(snapshot=snap, kind=kind, extra=extra, done=threading.Event())
        self._queue.put(job)  # blocks if max_pending writes are outstanding
        return snap

    def save_urgent(self, step: int, state, *, kind: str = "termination",
                    mesh_info: dict | None = None, extra: dict | None = None,
                    timeout_s: float | None = None) -> CheckpointInfo:
        """Termination checkpoint: snapshot, drop queued (stale) jobs, write now.

        Blocks until durably committed (or `timeout_s`). Stale queued periodic
        snapshots are discarded — the termination snapshot supersedes them.

        On a quantize-moments store the optimizer moments are absmax-int8
        quantized *on device* before the host copy, so the extract leg of the
        notice window moves them at 1/4 width; the stored bytes are the same
        as a host-side quantize, so the chunks still dedup against periodic
        saves of the same state.

        Urgent saves never use the device-delta fingerprint path: the notice
        window cannot wait for a digest round-trip at a step boundary, and
        the delta-mode chunk pool already makes the *write* leg incremental
        via the raw-digest memo. Their chunks' content addresses are
        computed on the device instead, beside the copies
        (``extract_snapshot``'s ``digest_chunk``), so the host only writes.

        The write runs on a dedicated transient thread, not the periodic
        writer thread: an inflight periodic save must not serialize the
        notice window. The store's commit protocol is multi-writer safe
        (idempotent pool puts, per-save stage dirs, commit lock), and at the
        codec level the urgent save's encode jobs enter the scheduler's
        URGENT lane — queued periodic encodes wait, and running ones yield
        their workers between chunks.
        """
        snap = sharded.extract_snapshot(
            state, step=step, mesh_info=mesh_info,
            on_device_quantize=(ser.is_moment_name
                                if self.store.quantize_moments else None),
            digest_chunk=self.store.urgent_digest_chunk)
        # discard queued-but-unstarted periodic jobs; they are older than `snap`
        try:
            while True:
                stale = self._queue.get_nowait()
                if stale is not None:
                    stale.error = RuntimeError("superseded by termination checkpoint")
                    stale.done.set()
                    self._queue.task_done()
        except queue.Empty:
            pass
        job = _Job(snapshot=snap, kind=kind, extra=extra, done=threading.Event())
        runner = threading.Thread(target=self._run_urgent, args=(job,),
                                  daemon=True, name="spoton-ckpt-urgent")
        runner.start()
        if not job.done.wait(timeout=timeout_s):
            raise TimeoutError(
                f"termination checkpoint at step {step} missed the notice window")
        if job.error is not None:
            if not isinstance(job.error, Exception):
                raise job.error  # process-kill equivalent: never downgrade
            raise RuntimeError("termination checkpoint failed") from job.error
        assert job.result is not None
        return job.result

    def _run_urgent(self, job: _Job) -> None:
        """Body of the transient urgent-save thread — same bookkeeping as
        the periodic worker, minus the queue."""
        try:
            job.result = self.store.save_snapshot(
                job.snapshot, kind=job.kind, extra=job.extra)
            with self._lock:
                self._completed.append(job.result)
        except BaseException as e:
            job.error = e
            with self._lock:
                self._last_error = e
        finally:
            job.done.set()

    def drain_completed(self) -> list[CheckpointInfo]:
        """Pop infos of writes finished since the last drain (all kinds,
        including urgent saves — callers that already accounted an urgent
        save's result should filter on ``kind``)."""
        with self._lock:
            done, self._completed = self._completed, []
        return done

    def wait_until_finished(self) -> None:
        self._queue.join()
        self._raise_pending_error()

    def close(self) -> None:
        try:
            self.wait_until_finished()
        finally:
            # always stop the worker, even when surfacing a pending error
            self._queue.put(None)
            self._thread.join(timeout=10)
