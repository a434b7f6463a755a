"""Chunk digest wrapper: the CUDA kernel for CUDA tensors, the plain version
(hashlib, zlib) for CPU tensors.

``chunk_digests`` is what an urgent save calls: its leaves in, for each
``chunk_bytes`` window of each leaf's raw bytes the chunk's content address
(SHA-1, hex) and CRC-32 out — the two numbers the chunk pool would compute on
the host from the copied bytes. On the card all the leaves' chunks go through
one launch (a table of chunk addresses and lengths), queued on the current
stream beside the leaves' copies to the host; ``ChunkDigests.result`` waits
for the small outputs. A CUDA tensor launches the kernel or raises; there is
no fallback to the plain version.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import _lib
from .ref import chunk_digests_ref

__all__ = ["ChunkDigests", "chunk_digests", "digestible"]


def digestible(t: torch.Tensor) -> bool:
    """Whether the kernel can read ``t`` in place: a contiguous CUDA tensor
    whose bytes start on a 4-byte boundary."""
    return (t.device.type == "cuda" and t.is_contiguous()
            and t.data_ptr() % 4 == 0)


class ChunkDigests:
    """The digests of one ``chunk_digests`` call, in flight on the device
    (or already computed, for CPU tensors)."""

    def __init__(self, counts: list[int], sha=None, crc=None, event=None,
                 done: list[list[tuple[str, int]]] | None = None):
        self._counts = counts
        self._sha, self._crc, self._event = sha, crc, event
        self._done = done

    def result(self) -> list[list[tuple[str, int]]]:
        """Per tensor, [(sha1 hex, crc32)] per chunk."""
        if self._done is None:
            self._event.synchronize()
            sha = self._sha.numpy().view(np.uint32).astype(">u4")
            crc = self._crc.numpy().view(np.uint32)
            out, c = [], 0
            for n in self._counts:
                out.append([(sha[i].tobytes().hex(), int(crc[i]))
                            for i in range(c, c + n)])
                c += n
            self._done = out
            self._sha = self._crc = self._event = None
        return self._done


def chunk_digests(tensors: Sequence[torch.Tensor], chunk_bytes: int) -> ChunkDigests:
    """Start the digests of every ``chunk_bytes`` window of each tensor's raw
    bytes. All tensors on one device: CPU tensors go through the plain
    version at once; CUDA tensors (``digestible``) through one launch on the
    current stream, whose results copy back to pinned host memory."""
    if chunk_bytes <= 0 or chunk_bytes % 64:
        raise ValueError(f"chunk_bytes must be a positive multiple of 64, "
                         f"got {chunk_bytes}")
    tensors = list(tensors)
    if not tensors or all(t.device.type == "cpu" for t in tensors):
        return ChunkDigests([], done=[chunk_digests_ref(t, chunk_bytes)
                                      for t in tensors])
    dev = tensors[0].device
    desc, counts = [], []
    for t in tensors:
        if not digestible(t) or t.device != dev:
            raise ValueError("chunk_digests: every tensor must be contiguous, "
                             f"4-byte aligned and on {dev}")
        nbytes = t.numel() * t.element_size()
        base = t.data_ptr()
        offs = range(0, nbytes, chunk_bytes)
        desc += [(base + off, min(chunk_bytes, nbytes - off)) for off in offs]
        counts.append(len(offs))
    n = len(desc)
    sha = torch.empty((n, 5), dtype=torch.int32, pin_memory=True)
    crc = torch.empty((n,), dtype=torch.int32, pin_memory=True)
    if n:
        table = torch.tensor(desc, dtype=torch.int64).pin_memory().to(
            dev, non_blocking=True)
        sha_d = _lib.kernel_output((n, 5), torch.int32, dev)
        crc_d = _lib.kernel_output((n,), torch.int32, dev)
        err = _lib.library().spot_chunk_digest(
            table.data_ptr(), n, sha_d.data_ptr(), crc_d.data_ptr(),
            _lib.stream_ptr(dev))
        _lib.check(err, "chunk_digest")
        _lib.LAUNCHES["chunk_digest"] += 1
        sha.copy_(sha_d, non_blocking=True)
        crc.copy_(crc_d, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(dev))
    return ChunkDigests(counts, sha, crc, event)
