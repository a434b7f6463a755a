"""Checkpoint manifest + atomic commit protocol.

Layout of one committed checkpoint on the shared store::

    <root>/step_00000042/
        manifest.json       # global view: tensors, shard files, tree structure
        shard_p000.spot     # per-writer (per-host) shard container(s)
        shard_p001.spot
        COMMITTED           # written LAST; its presence marks validity

Writers stage everything in ``step_00000042.tmp-<nonce>/`` and atomically
rename to the final name, then create COMMITTED. A reader considers a
checkpoint restorable iff COMMITTED exists *and* the manifest parses *and*
(optionally) every shard's crc validates. Any failure → fall back to the next
older checkpoint: this is the paper's "search for the most recent *valid*
checkpoint" generalized to handle partially-written or corrupted state from a
writer killed mid-eviction.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any

from ..faults import inject as faults
from .ioutil import fsync_dir

MANIFEST_NAME = "manifest.json"
COMMIT_MARKER = "COMMITTED"
STEP_PREFIX = "step_"


def step_dirname(step: int) -> str:
    return f"{STEP_PREFIX}{step:010d}"


def parse_step(dirname: str) -> int | None:
    if not dirname.startswith(STEP_PREFIX):
        return None
    tail = dirname[len(STEP_PREFIX):]
    if not tail.isdigit():
        return None
    return int(tail)


@dataclass
class Manifest:
    """Global description of one checkpoint.

    ``format_version`` 1: tensor records carry a ``file`` key pointing into a
    shard container inside the step dir. Version 2 (incremental/delta):
    records instead carry ``chunks`` — references into the store's shared
    content-addressed pool (``<root>/chunks/``) — plus ``raw_nbytes``;
    ``chunk_size`` records the split used at save time. Readers dispatch per
    record, so v1 checkpoints written before the delta subsystem stay
    restorable through the same code path."""

    step: int
    kind: str                      # "transparent" | "application" | "termination"
    created_at: float
    tensors: list[dict]            # TensorRecord JSONs (+ "file" v1 / "chunks" v2)
    leaf_order: list[str]          # pytree leaf names in treedef order
    treedef_repr: str              # human-readable treedef (debugging aid)
    mesh: dict                     # {"shape": [...], "axes": [...]} at save time
    extra: dict[str, Any] = field(default_factory=dict)  # small JSON state
    format_version: int = 1
    chunk_size: int | None = None  # v2 only

    def to_json(self) -> dict:
        d = {
            "format_version": self.format_version, "step": self.step,
            "kind": self.kind, "created_at": self.created_at,
            "tensors": self.tensors, "leaf_order": self.leaf_order,
            "treedef_repr": self.treedef_repr, "mesh": self.mesh,
            "extra": self.extra,
        }
        if self.chunk_size is not None:
            d["chunk_size"] = self.chunk_size
        return d

    @staticmethod
    def from_json(d: dict) -> "Manifest":
        return Manifest(
            step=d["step"], kind=d["kind"], created_at=d["created_at"],
            tensors=d["tensors"], leaf_order=d["leaf_order"],
            treedef_repr=d.get("treedef_repr", ""), mesh=d.get("mesh", {}),
            extra=d.get("extra", {}),
            format_version=d.get("format_version", 1),
            chunk_size=d.get("chunk_size"),
        )

    def chunk_hashes(self) -> set[str]:
        """All pool chunk hashes this manifest references (empty for v1)."""
        out: set[str] = set()
        for rec in self.tensors:
            for c in rec.get("chunks", ()):
                out.add(c["h"])
        return out


# -- per-leaf shard -> chunk-span map (format_version 2, optional) --------------
#
# A v2 tensor record may carry ``shard_spans``: one ``[row_lo, row_hi)`` pair
# per chunk ref, giving the axis-0 row band of the (stored-dtype) payload that
# chunk covers. A restoring process that only addresses rows ``[a, b)`` of a
# leaf can select exactly the chunks whose bands intersect ``[a, b)`` without
# first materializing prefix sums over every ref — and, more importantly, the
# map makes the save-time chunking *auditable*: the reader can cross-check the
# bands against the refs' ``raw_len`` prefix sums and refuse a manifest whose
# map lies. Absent on records written before this version (readers fall back
# to the prefix sums) and on scalar/0-d payloads (no row axis to band).


def chunk_byte_offsets(rec: dict) -> list[int]:
    """Prefix sums of a v2 record's chunk ``raw_len``s: chunk ``j`` covers
    bytes ``[offs[j], offs[j+1])`` of the flattened raw payload."""
    offs = [0]
    for c in rec.get("chunks", ()):
        offs.append(offs[-1] + int(c["r"]))
    return offs


def shard_span_map(shape, row_bytes: int, chunk_raw_lens) -> list | None:
    """Axis-0 row band per chunk, or None when the payload has no row axis.

    ``row_bytes`` is the stored-dtype byte size of one axis-0 row (trailing
    dims collapsed). Chunks are sequential windows over the flat payload, so
    chunk ``j`` spanning bytes ``[off, off+len)`` touches rows
    ``[off // row_bytes, ceil((off+len) / row_bytes))``.
    """
    if not shape or row_bytes <= 0:
        return None
    spans = []
    off = 0
    for raw_len in chunk_raw_lens:
        end = off + int(raw_len)
        spans.append([off // row_bytes, -(-end // row_bytes)])
        off = end
    return spans


def record_shard_spans(rec: dict) -> list | None:
    """A record's shard->chunk-span map, validated against the chunk refs.

    Returns the map as ``[(row_lo, row_hi), ...]`` or None when the record
    predates the map (or has no row axis). A map inconsistent with the refs
    (wrong length, non-monotonic, or bands that cannot contain the chunk's
    bytes) is treated as absent — the prefix-sum fallback is always correct,
    so a corrupt map must never be able to skip chunks a shard needs.
    """
    spans = rec.get("shard_spans")
    if spans is None:
        return None
    chunks = rec.get("chunks", ())
    if len(spans) != len(chunks):
        return None
    out = []
    prev_hi = 0
    for pair in spans:
        if not isinstance(pair, (list, tuple)) or len(pair) != 2:
            return None
        lo, hi = int(pair[0]), int(pair[1])
        if lo < 0 or hi < lo or lo > prev_hi:
            return None  # gap or inversion: bands must tile monotonically
        prev_hi = max(prev_hi, hi)
        out.append((lo, hi))
    return out


def write_manifest(dirpath: str, manifest: Manifest) -> None:
    path = os.path.join(dirpath, MANIFEST_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        # one-shot dumps (C-accelerated encoder), not json.dump's python
        # chunked iterencode: a delta manifest carries thousands of chunk
        # refs and the encode sits on every save's commit path — measured
        # ~16 ms -> ~2 ms on the 16 MiB / 64 KiB-chunk fixture. Compact
        # separators also shrink the file ~10%.
        faults.write_bytes(
            f, json.dumps(manifest.to_json(), separators=(",", ":")),
            op="manifest.write", path=tmp)
        f.flush()
        os.fsync(f.fileno())
    faults.fault_point("manifest.replace", path)
    os.replace(tmp, path)  # spotlint: ignore[SPOT002]
    faults.fault_point("manifest.replaced", path, rollback=(path, tmp))
    # no directory fsync here: the step dir keeps its inode through the
    # stage->final rename, so the single fsync_dir in mark_committed
    # persists this entry and the COMMITTED entry together — and COMMITTED
    # durable without the manifest entry is impossible (same flush). Every
    # fsync on the commit path is latency inside the eviction-notice window,
    # so each one has to pay for itself.


def read_manifest(dirpath: str) -> Manifest:
    with open(os.path.join(dirpath, MANIFEST_NAME)) as f:
        return Manifest.from_json(json.load(f))


def mark_committed(dirpath: str) -> None:
    path = os.path.join(dirpath, COMMIT_MARKER)
    with open(path, "w") as f:
        faults.write_bytes(f, f"{time.time()}\n", op="marker.write", path=path)
        f.flush()
        os.fsync(f.fileno())
    # one dir fsync persists the COMMITTED entry *and* the manifest entry
    # created before the rename (same dir inode) — a crash after this point
    # cannot lose a checkpoint the writer reported as committed
    fsync_dir(dirpath)


def is_committed(dirpath: str) -> bool:
    return os.path.exists(os.path.join(dirpath, COMMIT_MARKER))
