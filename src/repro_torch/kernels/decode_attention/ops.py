"""Flash decode: the CUDA kernel for CUDA tensors, the plain version for
CPU tensors.

``valid_len`` (the filled depth of the cache) is a runtime argument, so one
build serves every decode position, and the cache may have any depth. A
ring cache of size W whose newest token sits at position ``pos`` is read
with ``valid_len = min(pos + 1, W)``: every filled slot holds a position
inside the window, and softmax does not depend on slot order. Inference
only: an input that requires grad raises. A CUDA tensor always launches
the kernel or raises; there is no fallback.
"""

from __future__ import annotations

import math

import torch

from .. import _lib
from .ref import decode_attention_ref


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid_len: int) -> torch.Tensor:
    """q: (B,1,H,hd) or (B,H,hd); k,v: (B,S,KV,hd); 1 <= valid_len <= S.
    Returns the same rank as q."""
    _lib.refuse_grad("flash_decode", q, k, v)
    squeeze = q.ndim == 4
    if squeeze:
        q = q[:, 0]
    B, H, hd = q.shape
    _, S, KV, _ = k.shape
    if v.shape != k.shape or k.shape[0] != B or k.shape[3] != hd or H % KV:
        raise ValueError(f"flash_decode: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    valid_len = int(valid_len)
    if not 1 <= valid_len <= S:
        raise ValueError(f"flash_decode: valid_len {valid_len} outside [1, {S}]")
    if q.device.type == "cpu":
        o = decode_attention_ref(q, k, v, valid_len)
    else:
        o = _launch(q, k, v, valid_len)
    return o[:, None] if squeeze else o


def _launch(q, k, v, valid_len):
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _lib.require_cuda(t, f"flash_decode {name}", _lib.SERVING_DTYPES)
    B, H, hd = q.shape
    _, S, KV, _ = k.shape
    if not (q.dtype == k.dtype == v.dtype and q.device == k.device == v.device):
        raise TypeError("flash_decode: q, k, v must share dtype and device")
    if hd not in _lib.DECODE_HEAD_DIMS:
        raise ValueError(f"flash_decode: head_dim {hd} not in "
                         f"{_lib.DECODE_HEAD_DIMS}")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    err = _lib.library().spot_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, H, KV,
        hd, valid_len, _lib.DTYPE_CODES[q.dtype], 1.0 / math.sqrt(hd),
        _lib.stream_ptr(q.device))
    _lib.check(err, "decode_attention")
    _lib.LAUNCHES["decode_attention"] += 1
    return o
