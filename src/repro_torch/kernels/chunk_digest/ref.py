"""Plain version of the chunk digest: hashlib's SHA-1 and zlib's CRC-32 of
each ``chunk_bytes`` window of a tensor's raw bytes — what the chunk pool
computes on the host for every chunk it stores."""

from __future__ import annotations

import hashlib
import zlib

import numpy as np
import torch


def raw_bytes(t: torch.Tensor) -> memoryview:
    """A host tensor's raw bytes (bfloat16 as its bits), C order."""
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return memoryview(np.ascontiguousarray(t.numpy()).reshape(-1).view(np.uint8))


def chunk_digests_ref(t: torch.Tensor, chunk_bytes: int) -> list[tuple[str, int]]:
    """[(sha1 hex, crc32)] of each ``chunk_bytes`` window of ``t``'s raw
    bytes (the last window may be short; none for an empty tensor)."""
    mv = raw_bytes(t)
    return [(hashlib.sha1(mv[off:off + chunk_bytes]).hexdigest(),
             zlib.crc32(mv[off:off + chunk_bytes]))
            for off in range(0, len(mv), chunk_bytes)]
