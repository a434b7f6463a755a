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

import ctypes
from typing import Sequence

import numpy as np
import torch

from .. import _lib
from .ref import chunk_digests_ref

__all__ = ["ChunkDigests", "chain_clocks", "chunk_digests", "chunk_table",
           "digestible", "launch", "layout"]


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


def chunk_table(tensors: Sequence[torch.Tensor], chunk_bytes: int
                ) -> tuple[list[tuple[int, int]], list[int]]:
    """The kernel's chunk table for ``tensors`` (CUDA, ``digestible``, one
    device): (address, length) of every ``chunk_bytes`` window of each
    tensor's raw bytes, and each tensor's count of windows."""
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
    return desc, counts


def launch(table: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel over a chunk table already on the device
    (int64 (n, 2), ``chunk_table``'s rows), on the current stream: the SHA-1
    words (int32 (n, 5)) and CRC-32s (int32 (n,)) on the device."""
    n, dev = table.shape[0], table.device
    sha = _lib.kernel_output((n, 5), torch.int32, dev)
    crc = _lib.kernel_output((n,), torch.int32, dev)
    err = _lib.library().spot_chunk_digest(
        table.data_ptr(), n, sha.data_ptr(), crc.data_ptr(),
        _lib.stream_ptr(dev))
    _lib.check(err, "chunk_digest")
    _lib.LAUNCHES["chunk_digest"] += 1
    return sha, crc


def layout() -> dict:
    """The kernel's launch layout: chunks a CTA (a lane each), threads a CTA
    (the loads-and-schedule, CRC and rounds warps), 64-byte blocks a staged
    stage, stages in the byte ring, dynamic shared memory bytes a CTA."""
    out = (ctypes.c_int * 5)()
    _lib.check(_lib.library().spot_chunk_digest_layout(out),
               "chunk_digest_layout")
    return dict(zip(("chunks_per_cta", "threads", "blocks_per_stage",
                     "ring_stages", "smem_bytes"), out))


CHAINS = ("rotate_add", "sha1_round")


def chain_clocks(device: torch.device, chain: str = "rotate_add",
                 iters: int = 80 * 1024) -> float:
    """Clocks one step of a dependent chain takes on one thread of the card,
    timed with the SM's clock over ``iters`` steps: ``"rotate_add"`` the
    rounds' own step (a = rol(a, 5) + x, one instruction), ``"sha1_round"``
    a whole SHA-1 round from a schedule held in registers."""
    clocks = torch.zeros((1,), dtype=torch.int64, device=device)
    sink = torch.zeros((1,), dtype=torch.int32, device=device)
    _lib.check(_lib.library().spot_chunk_digest_chain_clocks(
        CHAINS.index(chain), iters, clocks.data_ptr(), sink.data_ptr(),
        _lib.stream_ptr(device)), "chunk_digest_chain_clocks")
    return int(clocks.item()) / iters


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
    desc, counts = chunk_table(tensors, chunk_bytes)
    n = len(desc)
    sha = torch.empty((n, 5), dtype=torch.int32, pin_memory=True)
    crc = torch.empty((n,), dtype=torch.int32, pin_memory=True)
    if n:
        table = torch.tensor(desc, dtype=torch.int64).pin_memory().to(
            dev, non_blocking=True)
        sha_d, crc_d = launch(table)
        sha.copy_(sha_d, non_blocking=True)
        crc.copy_(crc_d, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(dev))
    return ChunkDigests(counts, sha, crc, event)
