"""CheckpointStore — atomic commit, latest-valid search, retention GC.

The store models the paper's shared NFS volume: every instance (host) mounts
the same ``root``. Its invariants:

* **Atomicity** — a checkpoint is either fully committed (COMMITTED marker
  present, manifest + shards complete) or invisible to readers. Staging dir +
  rename + marker-last ordering guarantees this even if the writer is killed
  mid-eviction (the paper's "opportunistic" termination checkpoint).
* **Latest-valid search** — restore scans committed steps newest-first and
  returns the first that passes validation, exactly the coordinator behaviour
  in the paper ("automatically searches for the most recent valid checkpoint").
* **Retention** — keep the newest K committed checkpoints (bounded NFS bill;
  the cost model charges provisioned bytes).
* **Incremental saves** (``mode="delta"``, the default) — tensor payloads are
  chunked into a content-addressed pool shared by all steps
  (``<root>/chunks/<hh>/<hash>``); a save writes only chunks whose content
  changed since the last committed state, and the manifest (v2) records
  per-tensor chunk references so any retained step reassembles from the pool.
  ``mode="full"`` keeps the original self-contained v1 shard files; both
  formats restore through the same reader.
"""

from __future__ import annotations

import logging
import os
import shutil
import threading
import time
import uuid
from collections import Counter
from concurrent.futures import CancelledError
from dataclasses import dataclass, field
from typing import Any, Callable

from . import backend as backend_mod
from . import chunkstore
from . import manifest as mf
from . import serialize as ser
from . import sharded
from ..faults import inject as faults
from .ioutil import fsync_dir


@dataclass
class CheckpointInfo:
    step: int
    path: str
    kind: str
    nbytes: int          # logical encoded size of the checkpoint
    elapsed_s: float
    new_bytes: int = 0   # bytes physically written (== nbytes for full saves)
    # device→host accounting from the snapshot's extract: bytes that crossed
    # the link vs. bytes the fingerprint path proved unchanged and skipped,
    # and the wall time the trainer was stalled inside extract
    d2h_bytes: int = 0
    d2h_bytes_skipped: int = 0
    save_stall_ms: float = 0.0
    # True when an object-store outage parked this save: the chunks are safe
    # in the local spool and the staged manifest commits in reconcile once
    # every ref is durable — latest_valid() does NOT see it yet
    spooled: bool = False
    # seconds per leg of the save (``chunkstore.SaveLegs.as_dict``): the
    # extract's pinned allocation and copy wait, the chunk encode and
    # write, the directory fsyncs, the manifest and the commit
    legs: dict = field(default_factory=dict)


@dataclass
class _ParkedCommit:
    """A staged save waiting out an object-store outage: every chunk is in
    the local spool, the manifest is written in ``stage``, and the commit
    (rename + marker) runs only after ``upload_now`` confirms all refs
    durable. The stage stays in the in-flight set and the chunk pins stay
    held until then — gc treats a parked save exactly like a live writer."""

    stage: str
    final: str
    kind: str
    step: int
    records: list
    hashes: set
    pinned: list


class CheckpointStore:
    def __init__(
        self,
        root: str,
        *,
        retention: int = 3,
        validate_on_restore: bool = False,
        compress: bool = True,
        quantize_moments: bool = False,
        mode: str = "delta",
        chunk_size: int = chunkstore.DEFAULT_CHUNK_SIZE,
        time_fn: Callable[[], float] = time.time,
        tags: dict | None = None,
        fault_injector: Callable[[str], None] | None = None,
        chunk_sweep_interval_s: float = 60.0,
        backend: backend_mod.ChunkBackend | None = None,
    ):
        if mode not in ("delta", "full"):
            raise ValueError(f"mode must be 'delta' or 'full', got {mode!r}")
        self.root = root
        self.retention = retention
        self.validate_on_restore = validate_on_restore
        self.compress = compress
        self.quantize_moments = quantize_moments
        self.mode = mode
        self.chunk_size = chunk_size
        self.time_fn = time_fn
        # opportunistic (per-save) pool sweeps are rate-limited: nothing the
        # sweep could reclaim is younger than the age gate (hours), but the
        # walk itself — one listdir per fan-out dir plus a manifest parse
        # per retained step — is tens of ms of syscalls on a networked fs,
        # paid inside every save that drops a retained step
        self.chunk_sweep_interval_s = chunk_sweep_interval_s
        self._last_chunk_sweep = -float("inf")
        pool_root = os.path.join(root, chunkstore.CHUNKS_DIRNAME)
        if backend is not None:
            # object-store tier: the local tree becomes a read-through cache
            # and every manifest commit waits on chunk-upload durability
            self.pool: chunkstore.ChunkPool = backend_mod.BackendChunkPool(
                pool_root, backend)
        else:
            self.pool = chunkstore.ChunkPool(pool_root)
        # saves parked by an object-store outage, FIFO by step; committed by
        # reconcile_spooled() once the store is reachable again
        self._spool_lock = threading.Lock()
        self._spooled_commits: list[_ParkedCommit] = []
        self._delta_index = chunkstore.DeltaIndex()
        # chunk hashes referenced by saves in flight (manifest not yet
        # committed) — the pool sweep must never remove these
        self._pin_lock = threading.Lock()
        self._pinned_chunks: Counter[str] = Counter()
        # store-level provenance (e.g. {"provider": "aws", "fleet": "f0"})
        # merged under every manifest's extras; per-save extras win on clash.
        self.tags = dict(tags or {})
        # test hook: called between commit phases; raising simulates a writer
        # killed mid-eviction at that phase. The seedable FaultPlan layer
        # (repro.faults) hits the same phases as "commit.<phase>" ops plus
        # every primitive IO op underneath them.
        self.fault_injector = fault_injector or (lambda phase: None)
        # embedded in this store's staging dir names: gc can reclaim a dead
        # same-token stage immediately (same process, not in the in-flight
        # set => its writer is gone), while foreign debris on the shared
        # volume stays age-gated.
        self._stage_token = uuid.uuid4().hex[:6]
        # staging dirs with a writer currently inside them (fleet: N async
        # writers share one store) — gc must never sweep these
        self._stage_lock = threading.Lock()
        self._inflight_stages: set[str] = set()
        # serializes the replace+mark phase across this store's writers so a
        # same-step commit race can never delete a committed checkpoint
        self._commit_lock = threading.Lock()
        # opportunistic maintenance callbacks run after each successful
        # commit, off the critical path (e.g. compile-cache retention gc) —
        # failures are swallowed, a janitor must never fail a save
        self.post_commit: list[Callable[[], None]] = []
        os.makedirs(root, exist_ok=True)

    # -- write ---------------------------------------------------------------

    def _pin(self, h: str, pinned: list) -> None:
        with self._pin_lock:
            self._pinned_chunks[h] += 1
        pinned.append(h)

    def _unpin_all(self, pinned: list) -> None:
        with self._pin_lock:
            for h in pinned:
                self._pinned_chunks[h] -= 1
                if self._pinned_chunks[h] <= 0:
                    del self._pinned_chunks[h]

    def _phase(self, name: str) -> None:
        """One commit-phase boundary: the legacy per-store injector hook and
        the process-wide FaultPlan layer both see it."""
        self.fault_injector(name)
        faults.fault_point("commit." + name)

    def _finish_commit(self, stage: str, final: str, kind: str) -> bool:
        """The replace+mark commit phase: stage → final rename, root fsync
        overlapped with the COMMITTED marker write. Shared by the normal
        save path and the outage reconcile path (a parked save commits
        through exactly the same protocol once its refs are durable).
        Returns True when this writer committed, False when another fleet
        member already had."""
        # The commit-phase IO below (rmtree/replace/mark_committed/root
        # fsync join) intentionally runs under _commit_lock and is
        # suppressed inline for spotlint SPOT031: the lock exists
        # precisely to serialize the replace+mark phase across this
        # store's writers (a same-step commit race must never delete a
        # committed checkpoint), so the IO *is* the critical section.
        # Everything that can leave it has: shard/chunk writes, manifest
        # encode and fsync all happen before the lock; the root-dir
        # fsync overlaps on an executor lane and only its join remains.
        # The os.replace is likewise suppressed inline for SPOT001:
        # the source-fsync the rule wants happened in the caller —
        # write_snapshot's shard/manifest fsyncs (and, on a backend
        # pool, flush_uploads' durability barrier) all complete before
        # a stage dir is ever handed to this function.
        with self._commit_lock:
            if mf.is_committed(final):
                # another fleet member already committed this step; the
                # committed copy captures the same state — never delete
                # it (our writer may die mid-eviction before re-creating)
                shutil.rmtree(stage, ignore_errors=True)  # spotlint: ignore[SPOT031]
                return False
            if os.path.exists(final):  # uncommitted leftover: replace
                shutil.rmtree(final)  # spotlint: ignore[SPOT031]
            faults.fault_point("store.replace", final)
            os.replace(stage, final)  # spotlint: ignore[SPOT001,SPOT031]
            faults.fault_point("store.replaced", final,
                               rollback=(final, stage))
            # durable, not just atomic: sync the root so a crash
            # right after the rename can't roll the step dir back.
            # The root fsync overlaps the marker write — they are
            # independent (rename rollback removes the whole dir,
            # marker included: invisible, never inconsistent), and
            # fsync latency sits inside the eviction-notice window
            try:
                root_sync = (chunkstore.urgent_executor()
                             if kind == "termination" else
                             chunkstore.codec_executor()).submit(
                    fsync_dir, self.root)
            except RuntimeError:
                # scheduler already shut down (periodic save racing
                # the atexit hook at interpreter exit): durability
                # cannot be skipped, fsync inline instead
                fsync_dir(self.root)  # spotlint: ignore[SPOT031]
                root_sync = None
            self._phase("renamed")
            try:
                mf.mark_committed(final)  # spotlint: ignore[SPOT031]
            finally:
                if root_sync is not None:
                    try:
                        root_sync.result()  # spotlint: ignore[SPOT031]
                    except CancelledError:
                        # queued fsync swept up by a concurrent
                        # shutdown(cancel_pending): fsync inline —
                        # COMMITTED must imply rename durability
                        fsync_dir(self.root)  # spotlint: ignore[SPOT031]
            self._phase("committed")
            return True

    def save_snapshot(self, snapshot: sharded.Snapshot, *, kind: str = "transparent",
                      extra: dict | None = None) -> CheckpointInfo:
        t0 = self.time_fn()
        legs = snapshot.legs
        if self._spooled_commits:
            # outage backlog first: parked steps must commit in order before
            # a newer step lands, and a reachable store drains them cheaply
            self.reconcile_spooled()
        final = os.path.join(self.root, mf.step_dirname(snapshot.step))
        stage = final + f".tmp-{self._stage_token}-{uuid.uuid4().hex[:8]}"
        os.makedirs(stage, exist_ok=True)
        with self._stage_lock:
            self._inflight_stages.add(stage)
        pinned: list[str] = []
        we_committed = False
        parked = False
        try:
            self._phase("staged")
            if self.mode == "delta":
                # dirty chunks land in the shared pool (atomic, idempotent
                # per chunk); the step dir itself holds only the manifest, so
                # the stage->rename->marker protocol is unchanged. Chunks from
                # a writer killed here are orphans, swept by gc once old.
                # Termination saves encode on the scheduler's URGENT lane
                # so the notice window never queues behind periodic save
                # traffic — and periodic encodes yield their workers to it.
                records, new_bytes = sharded.write_snapshot_delta(
                    snapshot, self.pool, compress=self.compress,
                    quantize_moments=self.quantize_moments,
                    chunk_size=self.chunk_size, index=self._delta_index,
                    pin=lambda h: self._pin(h, pinned),
                    executor=(chunkstore.urgent_executor()
                              if kind == "termination" else None),
                    urgent=kind == "termination")
            else:
                records = sharded.write_snapshot(
                    stage, snapshot, compress=self.compress,
                    quantize_moments=self.quantize_moments)
                new_bytes = sum(r["nbytes"] for r in records)
            self._phase("shards_written")
            man = mf.Manifest(
                step=snapshot.step, kind=kind, created_at=self.time_fn(),
                tensors=records, leaf_order=snapshot.leaf_order,
                treedef_repr=snapshot.treedef_repr, mesh=snapshot.mesh,
                extra={**self.tags, **(extra or {})},
                format_version=2 if self.mode == "delta" else 1,
                chunk_size=self.chunk_size if self.mode == "delta" else None)
            w1 = time.perf_counter()
            mf.write_manifest(stage, man)
            w1 = chunkstore.charge_leg(legs, "manifest_s", w1)
            self._phase("manifest_written")
            # Durability barrier before commit: with an object-store backend
            # every pipelined chunk upload must have landed before the
            # manifest may reference it. A non-empty undurable set means the
            # store is out — park the staged commit in the spool instead.
            undurable: set[str] = set()
            flush = getattr(self.pool, "flush_uploads", None)
            if flush is not None:
                undurable = flush(set(pinned))
            self._phase("uploads_flushed")
            if undurable:
                with self._spool_lock:
                    self._spooled_commits.append(_ParkedCommit(
                        stage=stage, final=final, kind=kind,
                        step=snapshot.step, records=records,
                        hashes=set(pinned), pinned=list(pinned)))
                parked = True
                logging.getLogger("spoton").warning(
                    "object store outage: step %d save spooled locally "
                    "(%d chunks awaiting upload); manifest parked until "
                    "reconcile", snapshot.step, len(undurable))
            else:
                we_committed = self._finish_commit(stage, final, kind)
            chunkstore.charge_leg(legs, "commit_s", w1)
        except BaseException:
            # leave staging dir for post-mortem; it is invisible to readers
            raise
        finally:
            # the payload is on disk (or the save failed): the staged pinned
            # buffers go back for the next save
            snapshot.release_staging()
            # a parked save stays a live writer: its stage must survive gc
            # and its chunk pins must hold until reconcile commits it
            if not parked:
                with self._stage_lock:
                    self._inflight_stages.discard(stage)
                self._unpin_all(pinned)
        if (we_committed or parked) and snapshot.on_committed is not None:
            # device-delta bookkeeping: the snapshot's fingerprints + chunk
            # refs become the next save's comparison point only now that the
            # manifest referencing them is durably committed — or parked with
            # its chunks pinned in the spool, which keeps delta continuity for
            # this process (the parked refs are locally present and protected
            # from gc until reconcile commits them). Never fatal — a tracker
            # hiccup costs the next save its delta, not the save.
            try:
                snapshot.on_committed(records)
            except Exception as e:  # pragma: no cover - defensive
                logging.getLogger("spoton").warning(
                    "post-commit delta bookkeeping failed: %s", e)
        nbytes = sum(r["nbytes"] for r in records)
        # sweep_chunks=None: walk the pool only when retention actually
        # dropped a step — a full pool scan on every commit would sit inside
        # the urgent termination path for no reclaimable garbage
        w1 = time.perf_counter()
        self.gc(sweep_chunks=None)
        for cb in self.post_commit:
            try:
                cb()
            except Exception as e:  # pragma: no cover - defensive
                logging.getLogger("spoton").warning(
                    "post-commit hook failed: %s", e)
        chunkstore.charge_leg(legs, "gc_s", w1)
        return CheckpointInfo(step=snapshot.step, path=final, kind=kind,
                              nbytes=nbytes, elapsed_s=self.time_fn() - t0,
                              new_bytes=new_bytes,
                              d2h_bytes=snapshot.d2h_bytes or snapshot.nbytes,
                              d2h_bytes_skipped=snapshot.d2h_skipped,
                              save_stall_ms=snapshot.stall_s * 1e3,
                              spooled=parked, legs=legs.as_dict())

    def urgent_digest_chunk(self, name: str, t) -> int | None:
        """The chunk size at which an urgent save digests leaf ``name`` on
        the device (``t``: the tensor whose bytes are copied — int8 for a
        moment quantized on the device): the pool's, where this store keeps
        the leaf's chunks as those very bytes. None on a full-mode store
        (shard files, no chunks) and where the write quantizes or
        compresses — the policy the write applies (``_piece_codec``)."""
        if self.mode != "delta":
            return None
        codec = ser.codec_for_meta(
            name, ser.dtype_to_name(t.dtype), t.numel() * t.element_size(),
            ndim=t.ndim, compress=self.compress,
            quantize_moments=self.quantize_moments)
        return self.chunk_size if codec == "raw" else None

    def save(self, step: int, state, *, kind: str = "transparent",
             mesh_info: dict | None = None, extra: dict | None = None,
             tracker=None) -> CheckpointInfo:
        """Synchronous convenience: extract + write + commit. ``tracker``
        (a ``DeviceDeltaTracker``, delta mode only) routes eligible leaves
        through the device fingerprint path."""
        snap = sharded.extract_snapshot(
            state, step=step, mesh_info=mesh_info,
            tracker=tracker if self.mode == "delta" else None)
        return self.save_snapshot(snap, kind=kind, extra=extra)

    def spooled_steps(self) -> list[int]:
        """Steps whose saves are parked in the outage spool (oldest first)."""
        with self._spool_lock:
            return [p.step for p in self._spooled_commits]

    def reconcile_spooled(self) -> int:
        """Commit outage-parked saves whose chunks can now be made durable.

        Probes the backend first (a cheap HEAD; also clears outage mode on
        success), then drains the spool FIFO: re-upload each parked save's
        refs synchronously (``upload_now``) and run the normal replace+mark
        commit — manifest commit strictly after every ref is durable. Stops
        at the first save the store still refuses, so a half-recovered
        outage commits a prefix of the backlog in step order. Returns the
        number of checkpoints committed."""
        with self._spool_lock:
            pending = list(self._spooled_commits)
        if not pending:
            return 0
        pool = self.pool
        probe = getattr(pool, "probe", None)
        if probe is not None and not probe():
            return 0
        upload_now = getattr(pool, "upload_now", None)
        committed = 0
        for parked in pending:
            if upload_now is not None and not upload_now(parked.hashes):
                break
            self._finish_commit(parked.stage, parked.final, parked.kind)
            with self._spool_lock:
                try:
                    self._spooled_commits.remove(parked)
                except ValueError:  # pragma: no cover - concurrent reconcile
                    pass
            with self._stage_lock:
                self._inflight_stages.discard(parked.stage)
            self._unpin_all(parked.pinned)
            committed += 1
            logging.getLogger("spoton").info(
                "reconciled spooled step %d: all refs durable, manifest "
                "committed", parked.step)
        if committed:
            self.gc(sweep_chunks=None)
        return committed

    # -- read ----------------------------------------------------------------

    def committed_steps(self) -> list[int]:
        steps = []
        try:
            entries = os.listdir(self.root)
        except FileNotFoundError:
            return []
        for d in entries:
            step = mf.parse_step(d)
            if step is None:
                continue
            if mf.is_committed(os.path.join(self.root, d)):
                steps.append(step)
        return sorted(steps)

    def _try_open(self, step: int, *, validate: bool,
                  chunk_pool: chunkstore.ChunkPool | None = None
                  ) -> tuple[mf.Manifest, sharded.CheckpointReader] | None:
        path = os.path.join(self.root, mf.step_dirname(step))
        try:
            man = mf.read_manifest(path)
            reader = sharded.CheckpointReader(path, man.tensors,
                                              chunk_pool=chunk_pool or self.pool)
            if validate:
                reader.validate()
            return man, reader
        except Exception:
            return None

    def latest_valid(self, *, max_step: int | None = None,
                     chunk_pool: chunkstore.ChunkPool | None = None
                     ) -> tuple[mf.Manifest, sharded.CheckpointReader] | None:
        """Newest committed checkpoint that parses (and validates); else older."""
        for step in reversed(self.committed_steps()):
            if max_step is not None and step > max_step:
                continue
            opened = self._try_open(step, validate=self.validate_on_restore,
                                    chunk_pool=chunk_pool)
            if opened is not None:
                return opened
        return None

    def restore(self, template, *, step: int | None = None,
                streaming: bool = False,
                chunk_pool: chunkstore.ChunkPool | None = None):
        """Restore into `template`'s structure/shardings. Returns (state, manifest).

        ``streaming`` pipelines read→decode→host-to-device copy per tensor (see
        ``sharded.restore_to_template_streaming``) — bit-identical results,
        shorter eviction→first-step-back window when template leaves carry
        device shardings. ``chunk_pool`` overrides where v2 chunk bytes are
        resolved from — a replacement passes its peer read-through pool
        (``peer_exchange.ReadThroughPool``) to warm-restore from surviving
        fleet members before falling back to this store."""
        if step is not None:
            opened = self._try_open(step, validate=self.validate_on_restore,
                                    chunk_pool=chunk_pool)
        else:
            opened = self.latest_valid(chunk_pool=chunk_pool)
        if opened is None:
            raise FileNotFoundError(f"no valid checkpoint under {self.root}")
        man, reader = opened
        if streaming:
            state = sharded.restore_to_template_streaming(reader, template)
        else:
            state = sharded.restore_to_template(reader, template)
        return state, man

    # -- maintenance -----------------------------------------------------------

    def gc(self, *, stale_staging_age_s: float = 3600.0,
           stale_chunk_age_s: float = 3600.0,
           sweep_chunks: bool | None = True) -> list[int]:
        """Keep the newest `retention` committed checkpoints; drop the rest.

        ``sweep_chunks``: True sweeps the chunk pool now; None (the per-save
        default) sweeps only when this call doomed a step — the only event
        that makes pool entries newly unreferenced."""
        steps = self.committed_steps()
        doomed = steps[:-self.retention] if self.retention > 0 else []
        for step in doomed:
            shutil.rmtree(os.path.join(self.root, mf.step_dirname(step)),
                          ignore_errors=True)
        # sweep dead staging dirs — but never one a live writer is inside
        # (this process: tracked set; another host on the shared volume:
        # age-gated by real mtime, an eviction notice is seconds not hours).
        # A stage carrying *this store's* token that is not in the in-flight
        # set is debris from one of our own aborted commits — its writer
        # already unwound through save_snapshot's finally — so it is
        # reclaimed immediately, no age gate: this is how the save after a
        # crash-point abort self-heals the previous attempt's leftovers.
        with self._stage_lock:
            inflight = set(self._inflight_stages)
        own_marker = f".tmp-{self._stage_token}-"
        for d in os.listdir(self.root):
            if ".tmp-" not in d:
                continue
            path = os.path.join(self.root, d)
            if path in inflight:
                continue
            if own_marker not in d:
                try:
                    if (time.time() - os.path.getmtime(path)
                            < stale_staging_age_s):
                        continue
                except OSError:
                    pass  # already gone (or unreadable): try the sweep anyway
            shutil.rmtree(path, ignore_errors=True)
        due = time.time() - self._last_chunk_sweep >= self.chunk_sweep_interval_s
        if sweep_chunks or (sweep_chunks is None and doomed and due):
            self._gc_chunks(stale_chunk_age_s)
            self._last_chunk_sweep = time.time()
        return doomed

    def live_chunk_hashes(self) -> set[str]:
        """Chunks referenced by any committed manifest or an in-flight save."""
        live: set[str] = set()
        for step in self.committed_steps():
            path = os.path.join(self.root, mf.step_dirname(step))
            try:
                live |= mf.read_manifest(path).chunk_hashes()
            except Exception:
                continue  # unreadable manifest: its step is dead anyway
        with self._pin_lock:
            live |= set(self._pinned_chunks)
        return live

    def _gc_chunks(self, stale_chunk_age_s: float) -> None:
        """Refcount-aware pool sweep: a chunk referenced by any committed
        manifest (even one shared across steps) is never removed; unreferenced
        chunks are removed only past the age gate, which protects writers on
        other hosts that are mid-save (pool writes and reuse touches keep
        their chunks' mtimes fresh)."""
        live = self.live_chunk_hashes()
        now = time.time()
        for name, path, is_tmp in self.pool.entries():
            if not is_tmp and name in live:
                continue
            # unreferenced chunk or crashed-writer tmp file: sweep past age
            try:
                if now - os.path.getmtime(path) < stale_chunk_age_s:
                    continue
            except OSError:
                pass
            try:
                os.remove(path)
            except OSError:
                pass

    def total_bytes(self) -> int:
        total = 0
        for dirpath, _, files in os.walk(self.root):
            for f in files:
                try:
                    total += os.path.getsize(os.path.join(dirpath, f))
                except OSError:
                    pass
        return total
