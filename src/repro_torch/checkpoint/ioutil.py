"""Low-level IO helpers shared by the checkpoint hot path.

Three concerns live here because every layer of the save/restore path needs
them and none owns them:

* **Buffer views** — the save path's one-copy invariant (a tensor is
  materialized on the host at most once; hashing, chunking and compression all
  run on ``memoryview`` windows over that buffer) needs a way to see any
  numpy array, including extended dtypes that reject the buffer
  protocol's format negotiation, as flat bytes without copying.
* **mmap with fallback** — the restore path maps each container/pool file
  once and slices it, but must degrade to plain reads on filesystems or
  platforms where mmap fails (some network mounts reject ``MAP_SHARED``).
* **Directory durability** — an ``os.replace`` is atomic but not durable
  until the parent directory's entry is fsynced; a crash right after rename
  may otherwise roll the name back and lose a "committed" checkpoint.
"""

from __future__ import annotations

import errno
import logging
import mmap
import os
import threading

import numpy as np

from ..faults import inject as faults

log = logging.getLogger(__name__)


def array_bytes_view(arr: np.ndarray) -> memoryview:
    """Flat ``memoryview`` (format 'B') over an array's buffer, zero-copy.

    The view goes through a uint8 reinterpretation so extended dtypes
    (bfloat16, float8) export cleanly. Requires a C-contiguous array; callers
    on the save path guarantee that (``quantize`` returns contiguous).
    """
    return memoryview(arr.reshape(-1).view(np.uint8).data)


def mmap_view(path: str) -> memoryview:
    """Read-only view of a whole file: mmap-backed when possible, else a
    plain read. The returned memoryview keeps its backing object (mmap or
    bytes) alive; pass it to ``release_view`` for deterministic teardown."""
    faults.fault_point("file.mmap", path)
    with open(path, "rb") as f:
        try:
            return memoryview(mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ))
        except (ValueError, OSError):     # empty file / fs without mmap
            return memoryview(f.read())


def release_view(view: memoryview) -> None:
    """Release a view from ``mmap_view`` and close its mapping now rather
    than at GC time (an open mapping pins the file on some filesystems).
    If other exports of the mapping are still alive (zero-copy restore
    payloads slice it), the close is deferred to their GC instead."""
    backing = view.obj
    view.release()
    close = getattr(backing, "close", None)   # mmap has close(); bytes doesn't
    if close is not None:
        try:
            close()
        except BufferError:
            pass  # a live payload view still exports this mapping


# Filesystems that cannot fsync a directory fd report one of these; the
# rename is as durable as that mount can make it, so warn once and move on.
_FSYNC_UNSUPPORTED = frozenset(e for e in (
    errno.EINVAL,
    getattr(errno, "ENOTSUP", None),
    getattr(errno, "EOPNOTSUPP", None),
    errno.ENOSYS,
    errno.EBADF,
) if e is not None)

_fsync_warn_lock = threading.Lock()
_fsync_warned = False


def fsync_dir(path: str) -> None:
    """fsync a directory so renames/creates inside it survive a crash.

    Tolerant of filesystems that cannot fsync a directory fd (EINVAL /
    ENOTSUP / ENOSYS — common on overlayfs and some network mounts): those
    warn once per process and return, since the mount offers no stronger
    durability anyway. A *real* IO failure (EIO and friends) propagates —
    the rename's durability was genuinely lost and the commit must not be
    reported as durable.
    """
    global _fsync_warned
    faults.fault_point("dir.fsync", path)
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # directory vanished (concurrent sweep) or not opendable
    try:
        os.fsync(fd)
    except OSError as exc:
        if exc.errno in _FSYNC_UNSUPPORTED:
            with _fsync_warn_lock:
                if not _fsync_warned:
                    _fsync_warned = True
                    log.warning(
                        "directory fsync unsupported on this filesystem "
                        "(%s for %s); renames are only as durable as the "
                        "mount allows", errno.errorcode.get(exc.errno or 0,
                                                            exc.errno), path)
            return
        raise
    finally:
        os.close(fd)
