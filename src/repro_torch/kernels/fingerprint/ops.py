"""Fingerprint wrapper: the CUDA kernel for CUDA tensors, the plain PyTorch
version for CPU tensors.

``fingerprint_blocks`` is what the delta save path calls: tensor in,
``int32[n_blocks]`` digests (uint32 bits) out, one per ``block_bytes`` window
of the tensor's raw bytes, aligned with the chunk boundaries
``chunkstore.iter_chunks`` uses. The result stays on the tensor's device:
the tracker compares it against the previous save's digests in the same
call (``fingerprint_diff``) and only the small bool vector crosses to the
host. On the card a call is two launches: the slices' sums
(``fingerprint_partials``), then each block's digest and diff
(``fingerprint_final``), each with its plain version beside it in
``ref.py``. A CUDA tensor always launches the kernels or raises; there is
no fallback to the plain version.
"""

from __future__ import annotations

import torch

from .. import _lib
from .ref import (fingerprint_blocks_ref, fingerprint_diff_ref,
                  fingerprint_final_ref, fingerprint_partials_ref, n_blocks_of,
                  slices_per_block)

__all__ = ["SLICE_BYTES", "fingerprint_blocks", "fingerprint_diff",
           "fingerprint_final", "fingerprint_grid", "fingerprint_partials",
           "supported_dtype"]

# bytes of a block one slice of the first launch covers: one trip of a
# 1024-thread CTA's four 16-byte loads
SLICE_BYTES = 64 * 1024


def supported_dtype(dtype: torch.dtype) -> bool:
    """Dtypes the word stream is defined for (everything the checkpoint
    stores except bool)."""
    return dtype != torch.bool and dtype.itemsize in (1, 2, 4, 8)


def _check(x: torch.Tensor, block_bytes: int) -> None:
    if block_bytes % 4 or block_bytes < 4:
        raise ValueError(f"block_bytes must be a multiple of 4, got {block_bytes}")
    if not supported_dtype(x.dtype):
        raise TypeError(f"fingerprint unsupported for dtype {x.dtype}")


def fingerprint_grid() -> int:
    """CTAs of 1024 threads the first launch keeps resident on the card."""
    return _lib.library().spot_fingerprint_grid()


def _partials(x: torch.Tensor, block_bytes: int, partials: torch.Tensor) -> None:
    nbytes = x.numel() * x.element_size()
    err = _lib.library().spot_fingerprint_partials(
        x.data_ptr(), nbytes, x.element_size(), block_bytes, SLICE_BYTES,
        n_blocks_of(nbytes, block_bytes), partials.data_ptr(),
        _lib.stream_ptr(x.device))
    _lib.check(err, "fingerprint")
    _lib.LAUNCHES["fingerprint"] += 1


def _final(partials: torch.Tensor, out: torch.Tensor, old_fp, diff) -> None:
    n_blocks, spb = partials.shape
    err = _lib.library().spot_fingerprint_final(
        partials.data_ptr(), n_blocks, spb, out.data_ptr(),
        old_fp.data_ptr() if old_fp is not None else None,
        diff.data_ptr() if diff is not None else None,
        _lib.stream_ptr(partials.device))
    _lib.check(err, "fingerprint_final")
    _lib.LAUNCHES["fingerprint_final"] += 1


def _check_old(old_fp: torch.Tensor, n_blocks: int) -> None:
    _lib.require_cuda(old_fp, "fingerprint old", (torch.int32,))
    if old_fp.numel() != n_blocks:
        raise ValueError(f"old fingerprints have {old_fp.numel()} blocks, "
                         f"tensor has {n_blocks}")


def _launch(x: torch.Tensor, block_bytes: int, old_fp: torch.Tensor | None):
    _lib.require_cuda(x, "fingerprint")
    n_blocks = n_blocks_of(x.numel() * x.element_size(), block_bytes)
    if old_fp is not None:
        _check_old(old_fp, n_blocks)
    spb = slices_per_block(block_bytes, SLICE_BYTES)
    n_part = n_blocks * spb
    # one allocation before the first launch (a deterministic run fills
    # every new allocation on the device): the digests, the diff's bytes,
    # then the partials, which stay attached to the digests (64 bytes a
    # 1 MiB block)
    n_diff = -(-n_blocks // 4)
    buf = torch.empty(n_blocks + n_diff + n_part, dtype=torch.int32,
                      device=x.device)
    out = buf[:n_blocks]
    diff = (buf[n_blocks:n_blocks + n_diff].view(torch.bool)[:n_blocks]
            if old_fp is not None else None)
    partials = buf[n_blocks + n_diff:].view(n_blocks, spb)
    if n_blocks:
        _partials(x, block_bytes, partials)
        _final(partials, out, old_fp, diff)
    return out, diff


def fingerprint_partials(x: torch.Tensor, *, block_bytes: int) -> torch.Tensor:
    """The first launch alone: int32 (n_blocks, slices_per_block) slice sums
    of x's blocks (``fingerprint_partials_ref`` at ``SLICE_BYTES``); the
    kernel for a CUDA tensor, the plain version for a CPU one."""
    _check(x, block_bytes)
    if x.device.type == "cpu":
        return fingerprint_partials_ref(x, block_bytes, SLICE_BYTES)
    _lib.require_cuda(x, "fingerprint")
    n_blocks = n_blocks_of(x.numel() * x.element_size(), block_bytes)
    partials = torch.empty((n_blocks, slices_per_block(block_bytes, SLICE_BYTES)),
                           dtype=torch.int32, device=x.device)
    if n_blocks:
        _partials(x, block_bytes, partials)
    return partials


def fingerprint_final(partials: torch.Tensor, old_fp: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The second launch alone, on int32 (n_blocks, slices) partials:
    (digests, changed mask against ``old_fp`` or None); the kernel for a
    CUDA tensor, ``fingerprint_final_ref`` for a CPU one."""
    if partials.device.type == "cpu":
        return fingerprint_final_ref(partials, old_fp)
    _lib.require_cuda(partials, "fingerprint partials", (torch.int32,))
    n_blocks = partials.shape[0]
    out = torch.empty(n_blocks, dtype=torch.int32, device=partials.device)
    diff = None
    if old_fp is not None:
        _check_old(old_fp, n_blocks)
        diff = torch.empty(n_blocks, dtype=torch.bool, device=partials.device)
    if n_blocks:
        _final(partials, out, old_fp, diff)
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
    """(new fingerprints, per-block changed mask) in one call. ``old_fp``
    must have n_blocks entries for ``x`` (the tracker's identity checks
    guarantee it)."""
    _check(x, block_bytes)
    if x.device.type == "cpu":
        return fingerprint_diff_ref(x, old_fp, block_bytes)
    return _launch(x, block_bytes, old_fp)
