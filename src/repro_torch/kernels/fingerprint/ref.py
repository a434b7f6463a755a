"""Plain PyTorch version of the per-block fingerprint digest.

One uint32 digest per ``block_bytes`` window of a tensor's raw bytes — the
delta save path's change detector, bit-for-bit the reference's
(``kernels/fingerprint/ref.py`` of the JAX package):

    word_i  = i-th native-width word of the block, zero-extended to uint32
              (8-byte dtypes split into two uint32 words, memory order)
    h_i     = ((word_i ^ (i * C1)) * C2) ; h_i ^= h_i >> 15
    digest  = fmix32( sum_i h_i  mod 2^32 )

torch's int32 ``>>`` is an arithmetic shift and ``torch.uint32`` supports
few ops, so the math runs in int64 masked to 32 bits; every product is split
so that no intermediate leaves the int64 range. Digests come out as
``int32`` holding the uint32 bits — how they live on the device.
"""

from __future__ import annotations

import torch

C1 = 0x9E3779B1       # golden-ratio odd constant (position mix)
C2 = 0x85EBCA6B       # murmur3 fmix multiplier (word mix)
_F1 = 0x85EBCA6B
_F2 = 0xC2B2AE35
_M32 = 0xFFFFFFFF


def word_bytes(itemsize: int) -> int:
    """≤4-byte dtypes hash one word per element; 8-byte dtypes two."""
    return min(int(itemsize), 4)


def words_per_block(block_bytes: int, itemsize: int) -> int:
    return block_bytes // word_bytes(itemsize)


def n_blocks_of(nbytes: int, block_bytes: int) -> int:
    return -(-int(nbytes) // int(block_bytes))


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 ``a`` in [0, 2^32): 16-bit halves keep
    every product below 2^48."""
    lo = (a & 0xFFFF) * c
    hi = (((a >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _M32


def mix_words(w: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    h = _mul32(w ^ _mul32(pos, C1), C2)
    return h ^ (h >> 15)


def fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, _F1)
    h = h ^ (h >> 13)
    h = _mul32(h, _F2)
    return h ^ (h >> 16)


def to_int32_bits(h: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> int32 with the same 32 bits."""
    return torch.where(h >= 1 << 31, h - (1 << 32), h).to(torch.int32)


def words_of(x: torch.Tensor) -> torch.Tensor:
    """Flat int64 word stream (values in [0, 2^32)) of ``x``'s raw bytes."""
    flat = x.detach().contiguous().reshape(-1)
    it = flat.element_size()
    if it == 1:
        return flat.view(torch.uint8).to(torch.int64)
    if it == 2:
        return flat.view(torch.int16).to(torch.int64) & 0xFFFF
    return flat.view(torch.int32).to(torch.int64) & _M32


def fingerprint_blocks_ref(x: torch.Tensor, block_bytes: int) -> torch.Tensor:
    """int32[n_blocks] digests (uint32 bits) of ``x``'s raw bytes."""
    if block_bytes % 4 or block_bytes < 4:
        raise ValueError(f"block_bytes must be a multiple of 4, got {block_bytes}")
    it = x.element_size()
    nbytes = x.numel() * it
    if nbytes == 0:
        return torch.zeros(0, dtype=torch.int32, device=x.device)
    w = words_of(x)
    wpb = words_per_block(block_bytes, it)
    n_blocks = n_blocks_of(nbytes, block_bytes)
    pad = n_blocks * wpb - w.numel()
    if pad:
        w = torch.cat([w, w.new_zeros(pad)])
    w = w.reshape(n_blocks, wpb)
    pos = torch.arange(wpb, dtype=torch.int64, device=x.device)
    h = mix_words(w, pos)
    # wpb <= 2^20 words of < 2^32 each: the int64 sum cannot overflow
    return to_int32_bits(fmix32(h.sum(dim=1) & _M32))


def slices_per_block(block_bytes: int, slice_bytes: int) -> int:
    """Slices a block is cut into by the CUDA kernel's first launch (a block
    smaller than a slice is one slice)."""
    return -(-int(block_bytes) // int(slice_bytes))


def fingerprint_partials_ref(x: torch.Tensor, block_bytes: int,
                             slice_bytes: int) -> torch.Tensor:
    """The first launch's output: int32 (n_blocks, slices_per_block), the
    wrapping uint32 sum of the mixed words of each ``slice_bytes`` slice of
    each block (bytes [s * slice_bytes, min((s + 1) * slice_bytes,
    block_bytes)) of the block), each word at its position in the block, the
    tail block's zero padding included."""
    if block_bytes % 4 or block_bytes < 4 or slice_bytes % 16 or slice_bytes < 16:
        raise ValueError(f"block_bytes {block_bytes} must be a multiple of 4, "
                         f"slice_bytes {slice_bytes} of 16")
    it = x.element_size()
    nbytes = x.numel() * it
    n_blocks = n_blocks_of(nbytes, block_bytes)
    spb = slices_per_block(block_bytes, slice_bytes)
    if nbytes == 0:
        return torch.zeros((0, spb), dtype=torch.int32, device=x.device)
    w = words_of(x)
    wpb = words_per_block(block_bytes, it)
    pad = n_blocks * wpb - w.numel()
    if pad:
        w = torch.cat([w, w.new_zeros(pad)])
    h = mix_words(w.reshape(n_blocks, wpb),
                  torch.arange(wpb, dtype=torch.int64, device=x.device))
    # past the block's last word nothing is added: pad with zeros, unmixed
    wps = slice_bytes // word_bytes(it) if spb > 1 else wpb
    h = torch.cat([h, h.new_zeros((n_blocks, spb * wps - wpb))], dim=1)
    return to_int32_bits(h.reshape(n_blocks, spb, wps).sum(dim=2) & _M32)


def fingerprint_final_ref(partials: torch.Tensor, old_fp: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The second launch's output from int32 (n_blocks, slices) partials:
    (digests fmix32(sum of a block's slices mod 2^32), per-block changed mask
    against ``old_fp``, or None without it)."""
    s = (partials.to(torch.int64) & _M32).sum(dim=1) & _M32
    fp = to_int32_bits(fmix32(s))
    return fp, (fp != old_fp if old_fp is not None else None)


def fingerprint_diff_ref(x: torch.Tensor, old_fp: torch.Tensor,
                         block_bytes: int) -> tuple[torch.Tensor, torch.Tensor]:
    fp = fingerprint_blocks_ref(x, block_bytes)
    return fp, fp != old_fp
