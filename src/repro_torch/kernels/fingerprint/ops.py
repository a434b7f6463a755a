"""Fingerprint wrapper: the CUDA kernel for CUDA tensors, the plain PyTorch
version for CPU tensors.

``fingerprint_blocks`` is what the delta save path calls: tensor in,
``int32[n_blocks]`` digests (uint32 bits) out, one per ``block_bytes`` window
of the tensor's raw bytes, aligned with the chunk boundaries
``chunkstore.iter_chunks`` uses. The result stays on the tensor's device:
the tracker compares it against the previous save's digests in the same
launch (``fingerprint_diff``) and only the small bool vector crosses to the
host. A CUDA tensor always launches the kernel or raises; there is no
fallback to the plain version.
"""

from __future__ import annotations

import torch

from .. import _lib
from .ref import fingerprint_blocks_ref, fingerprint_diff_ref, n_blocks_of

__all__ = ["fingerprint_blocks", "fingerprint_diff", "supported_dtype"]


def supported_dtype(dtype: torch.dtype) -> bool:
    """Dtypes the word stream is defined for (everything the checkpoint
    stores except bool)."""
    return dtype != torch.bool and dtype.itemsize in (1, 2, 4, 8)


def _check(x: torch.Tensor, block_bytes: int) -> None:
    if block_bytes % 4 or block_bytes < 4:
        raise ValueError(f"block_bytes must be a multiple of 4, got {block_bytes}")
    if not supported_dtype(x.dtype):
        raise TypeError(f"fingerprint unsupported for dtype {x.dtype}")


def _launch(x: torch.Tensor, block_bytes: int, old_fp: torch.Tensor | None):
    _lib.require_cuda(x, "fingerprint")
    nbytes = x.numel() * x.element_size()
    n_blocks = n_blocks_of(nbytes, block_bytes)
    out = torch.empty(n_blocks, dtype=torch.int32, device=x.device)
    diff = None
    if old_fp is not None:
        _lib.require_cuda(old_fp, "fingerprint old", (torch.int32,))
        if old_fp.numel() != n_blocks:
            raise ValueError(f"old fingerprints have {old_fp.numel()} blocks, "
                             f"tensor has {n_blocks}")
        diff = torch.empty(n_blocks, dtype=torch.bool, device=x.device)
    lib = _lib.library()
    err = lib.spot_fingerprint(
        x.data_ptr(), nbytes, x.element_size(), block_bytes, n_blocks,
        out.data_ptr(), old_fp.data_ptr() if old_fp is not None else None,
        diff.data_ptr() if diff is not None else None,
        _lib.stream_ptr(x.device))
    _lib.check(err, "fingerprint")
    _lib.LAUNCHES["fingerprint"] += 1
    return out, diff


def fingerprint_blocks(x: torch.Tensor, *, block_bytes: int) -> torch.Tensor:
    """x -> int32[n_blocks] digests, on x's device."""
    _check(x, block_bytes)
    if x.numel() == 0:
        return torch.zeros(0, dtype=torch.int32, device=x.device)
    if x.device.type == "cpu":
        return fingerprint_blocks_ref(x, block_bytes)
    return _launch(x, block_bytes, None)[0]


def fingerprint_diff(x: torch.Tensor, old_fp: torch.Tensor, *,
                     block_bytes: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(new fingerprints, per-block changed mask) in one launch. ``old_fp``
    must have n_blocks entries for ``x`` (the tracker's identity checks
    guarantee it)."""
    _check(x, block_bytes)
    if x.device.type == "cpu":
        return fingerprint_diff_ref(x, old_fp, block_bytes)
    return _launch(x, block_bytes, old_fp)
