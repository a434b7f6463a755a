"""Device→host copies in flight.

A CUDA tensor is copied ``non_blocking`` into **pinned** host memory on the
current stream, and a CUDA event marks the copy's end; ``wait`` blocks on
that event before any host byte is read. The copy rides the stream the
training step uses, so a later step can never overwrite (or the caching
allocator reuse) the source before the copy has read it. A CPU tensor is
cloned at once — the snapshot freeze.

Pinning host memory is slow (seconds for a state of several GB), and an
urgent save cannot afford it inside the eviction notice. So a save's
full-leaf copies draw their pinned buffers from ``STAGING``, a pool of
buffers kept by byte size: the store hands them back once the save has been
written (``release``), and after each periodic save the coordinator
``reserve``s the next urgent save's set — one buffer for each leaf that save
will copy — which is pinned in the background while training goes on. The
pool keeps no more than that one set free.
"""

from __future__ import annotations

import threading
import time
from collections import Counter

import numpy as np
import torch

from . import serialize as ser


class PinnedStaging:
    """Pinned host buffers (``uint8``) reused across saves, by byte size.

    ``reserve(sizes)`` names the set the pool keeps free: one buffer for each
    of ``sizes`` (the next urgent save's leaves); what the free set lacks is
    pinned on a background thread, and free buffers beyond it are let go.
    ``take`` hands out a free buffer of the size asked for, or pins a new
    one; ``give`` keeps a buffer only while the free set lacks its size. So
    the pool holds at most one set free; the buffers of saves in flight are
    the caller's. A buffer let go returns to PyTorch's caching host
    allocator, which keeps it pinned for the next pinned allocation of its
    size class. ``alloc(nbytes)`` makes a buffer (default: a pinned
    ``uint8`` tensor)."""

    def __init__(self, alloc=None):
        self._alloc = alloc or (lambda n: torch.empty(n, dtype=torch.uint8,
                                                      pin_memory=True))
        self._lock = threading.Lock()
        self._free: dict[int, list[torch.Tensor]] = {}
        self._want: Counter[int] = Counter()
        self.stats = {"reused": 0, "allocated": 0, "spares": 0, "let_go": 0}

    def take(self, nbytes: int) -> torch.Tensor:
        with self._lock:
            bufs = self._free.get(nbytes)
            if bufs:
                self.stats["reused"] += 1
                return bufs.pop()
            self.stats["allocated"] += 1
        return self._alloc(nbytes)

    def give(self, buf: torch.Tensor) -> None:
        n = buf.numel()
        with self._lock:
            bufs = self._free.setdefault(n, [])
            if len(bufs) < self._want[n]:
                bufs.append(buf)
                return
            self.stats["let_go"] += 1

    def reserve(self, sizes) -> threading.Thread | None:
        """Make the free set one buffer for each of ``sizes`` (repeats
        count): free buffers beyond it are let go, and the missing ones are
        pinned on a daemon thread (returned; None when none is missing)."""
        want = Counter(sizes)
        with self._lock:
            self._want = want
            for n in list(self._free):
                del self._free[n][want[n]:]
                if not self._free[n]:
                    del self._free[n]
            missing = [n for n, k in want.items()
                       for _ in range(k - len(self._free.get(n, ())))]
        if not missing:
            return None

        def pin() -> None:
            for n in missing:
                buf = self._alloc(n)
                with self._lock:
                    self.stats["spares"] += 1
                self.give(buf)

        t = threading.Thread(target=pin, daemon=True, name="spoton-pin-spares")
        t.start()
        return t

    def held_bytes(self) -> int:
        """Bytes of the free buffers the pool holds."""
        with self._lock:
            return sum(n * len(b) for n, b in self._free.items())


STAGING = PinnedStaging()


class HostCopy:
    """One leaf's copy to the host. ``staged`` copies of CUDA tensors take
    their pinned buffer from ``STAGING``; ``release`` gives it back, after
    which the copy (and every array viewing it) must not be read. Until
    ``wait``, ``device`` is the contiguous CUDA tensor the copy reads (None
    for a CPU tensor), for work queued beside the copy on the same bytes."""

    def __init__(self, t: torch.Tensor, *, staged: bool = False):
        self.src = t                 # the leaf object, for identity checks
        t = t.detach()
        self.event: torch.cuda.Event | None = None
        self.alloc_s = 0.0           # host seconds spent getting the buffer
        self._buf: torch.Tensor | None = None
        self.device: torch.Tensor | None = None
        if t.device.type == "cuda":
            t = self.device = t.contiguous()
            t0 = time.perf_counter()
            nbytes = t.numel() * t.element_size()
            if staged and nbytes:
                self._buf = STAGING.take(nbytes)
                self.host = self._buf.view(t.dtype).view(t.shape)
            else:
                self.host = torch.empty(t.shape, dtype=t.dtype,
                                        pin_memory=True)
            self.alloc_s = time.perf_counter() - t0
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(t.device))
        else:
            self.host = t.contiguous().clone()

    def wait(self) -> torch.Tensor:
        if self.event is not None:
            self.event.synchronize()
            self.event = None
        self.device = None
        return self.host

    def numpy(self) -> np.ndarray:
        """The landed bytes as a host payload array (bfloat16 -> uint16)."""
        # a view of this copy's own buffer (a clone, or a pinned copy of a
        # CUDA tensor), valid until release() as the class says
        return ser.tensor_to_numpy(self.wait())  # spotlint: ignore[SPOT021]

    def release(self) -> bool:
        """Hand a staged buffer back to ``STAGING`` (waiting for the copy
        first, so no copy into it is still in flight); False when the copy
        holds no staged buffer."""
        if self._buf is None:
            return False
        self.wait()
        buf, self._buf = self._buf, None
        self.host = None
        STAGING.give(buf)
        return True
