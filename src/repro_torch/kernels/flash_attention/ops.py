"""Flash-attention forward: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors.

Sequences are padded to the kernel's 64-row blocks under the reference's
rule (``kernels/flash_attention/ops.py``): padded query rows are sliced
off, and padded key rows are allowed only for causal self-attention, where
no real query row can see them. The padding runs on either device, so the
CPU tests reach it. Forward only: the backward kernels come with the
training slice, and until then an input that requires grad raises. A CUDA
tensor always launches the kernel or raises; there is no fallback.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import _lib
from .ref import attention_ref

BLOCK = 64                       # the kernel's q and k block (csrc/flash_attention.cu)


def _pad_seq(x: torch.Tensor, size: int) -> torch.Tensor:
    pad = size - x.shape[1]
    return x if pad <= 0 else F.pad(x, (0, 0, 0, 0, 0, pad))


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """q: (B,Sq,H,hd); k,v: (B,Skv,KV,hd). Returns (o (B,Sq,H,hd),
    lse (B,H,Sq) float32)."""
    _lib.refuse_grad("flash_attention", q, k, v)
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    if v.shape != k.shape or k.shape[0] != B or k.shape[3] != hd or H % KV:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    Sq_p = -(-Sq // BLOCK) * BLOCK
    Skv_p = -(-Skv // BLOCK) * BLOCK
    if Skv_p != Skv and not (causal and Skv == Sq):
        raise ValueError("flash_attention: key padding needs causal "
                         f"self-attention; align Skv={Skv} to {BLOCK}")
    qp, kp, vp = _pad_seq(q, Sq_p), _pad_seq(k, Skv_p), _pad_seq(v, Skv_p)
    if q.device.type == "cpu":
        o, lse = attention_ref(qp, kp, vp, causal=causal, window=window)
    else:
        o, lse = _launch(qp, kp, vp, causal, window)
    return o[:, :Sq], lse[..., :Sq]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """The output of ``flash_attention_fwd``."""
    return flash_attention_fwd(q, k, v, causal, window)[0]


def _launch(q, k, v, causal, window):
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _lib.require_cuda(t, f"flash_attention {name}", _lib.SERVING_DTYPES)
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    if not (q.dtype == k.dtype == v.dtype and q.device == k.device == v.device):
        raise TypeError("flash_attention: q, k, v must share dtype and device")
    if hd not in _lib.HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {_lib.HEAD_DIMS}")
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    err = _lib.library().spot_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, Sq, Skv, H, KV, hd, _lib.DTYPE_CODES[q.dtype], int(bool(causal)),
        int(window), 1.0 / math.sqrt(hd), _lib.stream_ptr(q.device))
    _lib.check(err, "flash_attention_fwd")
    _lib.LAUNCHES["flash_attention_fwd"] += 1
    return o, lse
