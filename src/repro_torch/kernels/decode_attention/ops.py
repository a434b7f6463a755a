"""Flash decode: the CUDA kernels for CUDA tensors, the plain version for
CPU tensors.

On the card a call is two launches: the split pass (grid (splits, KV, B):
each CTA reduces one contiguous key range for a whole GQA group into
float32 partials) and the merge pass (each (batch, head) combines its
partials in split order). The split count is ``decode_splits(B, KV, hd,
valid_len)``, a function of those four numbers alone, so a decode position
gives the same bits every time it is computed (a restored generation
continues bitwise).

``valid_len`` (the filled depth of the cache) is a runtime argument, so one
build serves every decode position, and the cache may have any depth. A
ring cache of size W whose newest token sits at position ``pos`` is read
with ``valid_len = min(pos + 1, W)``: every filled slot holds a position
inside the window, and softmax does not depend on slot order. Inference
only: an input that requires grad raises. A CUDA tensor always launches
the kernels or raises; there is no fallback. The call is the torch op
``repro_torch::flash_decode`` (``kernels/_ops.py``).
"""

from __future__ import annotations

import math

import torch

from .. import _lib, _local, _ops
from .ref import (LOG2E, decode_attention_ref, decode_merge_ref,
                  decode_partials_ref)

DECODE_CTAS = 2 * 132   # split target: two CTAs on each of an H100's SMs
MAX_SPLITS = 256        # MAX_SPLITS in csrc/decode_attention.cu
MAX_GROUP = 16          # query heads per KV head one CTA serves


def decode_tile(hd: int) -> int:
    """Keys per tile of the split kernel (``Cfg::TK`` in the source)."""
    return 32 if hd > 128 else 64


def decode_splits(B: int, KV: int, hd: int, valid_len: int) -> tuple[int, int]:
    """(splits, keys per split) of a decode call: as many splits as keep
    the B * KV (batch, KV head) pairs' CTAs within ``DECODE_CTAS``, each
    split a whole number of tiles, none empty, together covering
    ``valid_len``."""
    tile = decode_tile(hd)
    tiles = -(-valid_len // tile)
    want = min(MAX_SPLITS, tiles, max(1, DECODE_CTAS // (B * KV)))
    per = -(-tiles // want)                # tiles per split
    return -(-tiles // per), per * tile


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid_len: int) -> torch.Tensor:
    """q: (B,1,H,hd) or (B,H,hd); k,v: (B,S,KV,hd); 1 <= valid_len <= S.
    Returns the same rank as q. On ``DTensor``s the op runs on each rank's
    local shards (``_local.attention``; a sequence-sharded cache is
    gathered first)."""
    _lib.refuse_grad("flash_decode", q, k, v)
    valid_len = int(valid_len)
    if _local.any_dtensor(q, k, v):
        return _local.attention(lambda q_, k_, v_: flash_decode(q_, k_, v_,
                                                                valid_len),
                                q, k, v)
    squeeze = q.ndim == 4
    o = DECODE(q[:, 0] if squeeze else q, k, v, valid_len)
    return o[:, None] if squeeze else o


def _check(q, k, v, valid_len) -> None:
    B, H, hd = q.shape
    _, S, KV, _ = k.shape
    if v.shape != k.shape or k.shape[0] != B or k.shape[3] != hd or H % KV:
        raise ValueError(f"flash_decode: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    if not 1 <= valid_len <= S:
        raise ValueError(f"flash_decode: valid_len {valid_len} outside [1, {S}]")


def _decode(q, k, v, valid_len):
    """The op on either device: q (B,H,hd) -> o (B,H,hd); the split and
    merge kernels for CUDA tensors, the plain version for CPU ones."""
    _check(q, k, v, valid_len)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, valid_len)
    B, H, hd = q.shape
    KV = k.shape[2]
    q, k, v = _operands(q, k, v)
    splits, per = decode_splits(B, KV, hd, valid_len)
    # the partials and the output in one allocation: under
    # deterministic algorithms each allocation is filled first
    n_ws = B * H * splits * (hd + 2)
    buf = torch.empty(n_ws * 4 + B * H * hd * q.element_size(),
                      dtype=torch.uint8, device=q.device)
    ws = buf[:n_ws * 4].view(torch.float32).view(B, H, splits, hd + 2)
    o = buf[n_ws * 4:].view(q.dtype).view(B, H, hd)
    _split(q, k, v, valid_len, per, ws)
    _merge(ws, o)
    return o


def _decode_fake(q, k, v, valid_len):
    _check(q, k, v, valid_len)
    return q.new_empty(q.shape)


def _decode_flops(q_shape, k_shape, v_shape, valid_len, *, out_shape=None,
                  **_kw) -> int:
    """4 FLOPs a head dimension for each (query head, valid key) pair: the
    q.k score and the p.v sum."""
    B, H, hd = q_shape
    return 4 * B * H * hd * int(valid_len)


DECODE = _ops.define(
    "flash_decode", "(Tensor q, Tensor k, Tensor v, int valid_len) -> Tensor",
    impl=_decode, plain=_decode, fake=_decode_fake, flops=_decode_flops)


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """The split kernel copies K and V rows 16 bytes at a time (cp.async)
    and loads q 16 bytes at a time: a view that starts off a 16-byte
    boundary is copied first."""
    return t.clone() if t.data_ptr() % 16 else t


def _operands(q, k, v):
    """q (B,H,hd), k, v (B,S,KV,hd) as the split kernel takes them, or
    raise."""
    q, k, v = (_aligned16(t.contiguous()) for t in (q, k, v))
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _lib.require_cuda(t, f"flash_decode {name}", _lib.SERVING_DTYPES)
    if not (q.dtype == k.dtype == v.dtype and q.device == k.device == v.device):
        raise TypeError("flash_decode: q, k, v must share dtype and device")
    H, hd = q.shape[1:]
    KV = k.shape[2]
    if hd not in _lib.DECODE_HEAD_DIMS:
        raise ValueError(f"flash_decode: head_dim {hd} not in "
                         f"{_lib.DECODE_HEAD_DIMS}")
    if H // KV > MAX_GROUP:
        raise ValueError(f"flash_decode: {H // KV} query heads per KV head, "
                         f"more than {MAX_GROUP}")
    return q, k, v


def _split(q, k, v, valid_len, keys_per_split, ws) -> None:
    B, H, hd = q.shape
    _, S, KV, _ = k.shape
    if ws.numel() == 0:
        return
    err = _lib.library().spot_decode_split(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ws.data_ptr(), B, S, H, KV,
        hd, valid_len, ws.shape[2], keys_per_split, _lib.DTYPE_CODES[q.dtype],
        LOG2E / math.sqrt(hd), _lib.stream_ptr(q.device))
    _lib.check(err, "decode_attention")
    _lib.LAUNCHES["decode_attention"] += 1


def _merge(ws, o) -> None:
    if o.numel() == 0:
        return
    B, H, splits, hd2 = ws.shape
    err = _lib.library().spot_decode_merge(
        ws.data_ptr(), o.data_ptr(), B, H, hd2 - 2, splits,
        _lib.DTYPE_CODES[o.dtype], _lib.stream_ptr(ws.device))
    _lib.check(err, "decode_attention_merge")
    _lib.LAUNCHES["decode_attention_merge"] += 1


def decode_partials(q, k, v, valid_len: int) -> torch.Tensor:
    """The split pass alone on q (B,H,hd), k, v (B,S,KV,hd) with
    ``decode_splits``' split: float32 partials (B, H, splits, hd + 2) as
    ``decode_partials_ref`` lays them out; the kernel for CUDA tensors, that
    plain version for CPU ones. ``flash_decode`` checks the shapes."""
    B, H, hd = q.shape
    KV = k.shape[2]
    splits, per = decode_splits(B, KV, hd, valid_len)
    if q.device.type == "cpu":
        return decode_partials_ref(q, k, v, valid_len, splits, per,
                                   decode_tile(hd))
    q, k, v = _operands(q, k, v)
    ws = torch.empty((B, H, splits, hd + 2), dtype=torch.float32,
                     device=q.device)
    _split(q, k, v, valid_len, per, ws)
    return ws


def decode_merge(ws: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The merge pass alone: float32 partials (B, H, splits, hd + 2) ->
    (B, H, hd) of ``dtype``; the kernel for a CUDA tensor,
    ``decode_merge_ref`` for a CPU one."""
    if ws.device.type == "cpu":
        return decode_merge_ref(ws, dtype)
    _lib.require_cuda(ws, "flash_decode partials", (torch.float32,))
    if dtype not in _lib.SERVING_DTYPES:
        raise TypeError(f"flash_decode: unsupported dtype {dtype}")
    B, H, _, hd2 = ws.shape
    o = torch.empty((B, H, hd2 - 2), dtype=dtype, device=ws.device)
    _merge(ws, o)
    return o
