"""Flash attention, forward and backward: the CUDA kernels for CUDA tensors,
the plain versions for CPU tensors.

Sequences are padded to the kernels' 64-row blocks under the reference's
rule (``kernels/flash_attention/ops.py``): padded query rows are sliced
off, and padded key rows are allowed only for causal self-attention, where
no real query row can see them. The backward pads q, o and dO to the block,
k and v to the block and lse with zeros; a padded row's dO is zero, so it
adds exactly nothing to any gradient. The padding runs on either device, so
the CPU tests reach it.

``flash_attention`` is differentiable: an ``autograd.Function`` that keeps
(q, k, v, o, lse), the reference's residency policy, and whose backward is
the dkv and dq kernels. ``flash_attention_fwd`` is the raw forward kernel
and, like a raw ``pallas_call``, refuses inputs that require grad. A CUDA
tensor always launches the kernels or raises; there is no fallback.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import _lib
from .ref import (attention_bwd_ref, attention_dkv_ref, attention_dq_ref,
                  attention_ref)

BLOCK = 64                 # the kernels' padding block (csrc/flash_attention*.cu)


def _pad_seq(x: torch.Tensor, size: int, dim: int = 1) -> torch.Tensor:
    pad = size - x.shape[dim]
    if pad <= 0:
        return x
    widths = [0, 0] * (x.ndim - 1 - dim) + [0, pad]
    return F.pad(x, widths)


def _padded_lengths(Sq: int, Skv: int, causal: bool) -> tuple[int, int]:
    Sq_p = -(-Sq // BLOCK) * BLOCK
    Skv_p = -(-Skv // BLOCK) * BLOCK
    if Skv_p != Skv and not (causal and Skv == Sq):
        raise ValueError("flash_attention: key padding needs causal "
                         f"self-attention; align Skv={Skv} to {BLOCK}")
    return Sq_p, Skv_p


def _check_shapes(q, k, v) -> None:
    B, _, H, hd = q.shape
    KV = k.shape[2]
    if v.shape != k.shape or k.shape[0] != B or k.shape[3] != hd or H % KV:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not fit")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """q: (B,Sq,H,hd); k,v: (B,Skv,KV,hd). Returns (o (B,Sq,H,hd),
    lse (B,H,Sq) float32)."""
    _lib.refuse_grad("flash_attention_fwd", q, k, v)
    _check_shapes(q, k, v)
    Sq, Skv = q.shape[1], k.shape[1]
    Sq_p, Skv_p = _padded_lengths(Sq, Skv, causal)
    qp, kp, vp = _pad_seq(q, Sq_p), _pad_seq(k, Skv_p), _pad_seq(v, Skv_p)
    if q.device.type == "cpu":
        o, lse = attention_ref(qp, kp, vp, causal=causal, window=window)
    else:
        o, lse = _launch_fwd(qp, kp, vp, causal, window)
    return o[:, :Sq], lse[..., :Sq]


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        window: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of ``flash_attention`` from the forward's
    ``o`` and ``lse`` and the output gradient ``do``; dk and dv are summed
    over each KV head's group of query heads, in k's and v's dtypes."""
    _check_shapes(q, k, v)
    Sq, Skv = q.shape[1], k.shape[1]
    Sq_p, Skv_p = _padded_lengths(Sq, Skv, causal)
    qp, op, dop = (_pad_seq(x, Sq_p) for x in (q, o, do))
    kp, vp = _pad_seq(k, Skv_p), _pad_seq(v, Skv_p)
    lsep = _pad_seq(lse, Sq_p, dim=2)
    if q.device.type == "cpu":
        dq, dk, dv = attention_bwd_ref(qp, kp, vp, op, lsep, dop,
                                       causal=causal, window=window)
    else:
        # D = rowsum(dO * O) stays a PyTorch reduction, as the reference
        # computes it outside its kernels
        dsum = torch.sum(dop.to(torch.float32) * op.to(torch.float32), dim=-1)
        dsum = dsum.transpose(1, 2).contiguous()                 # (B,H,Sq)
        dkh, dvh = flash_attention_dkv(qp, kp, vp, dop, lsep, dsum, causal,
                                       window)
        B, _, H, hd = q.shape
        KV = k.shape[2]
        dk = dkh.reshape(B, Skv_p, KV, H // KV, hd).sum(dim=3).to(k.dtype)
        dv = dvh.reshape(B, Skv_p, KV, H // KV, hd).sum(dim=3).to(v.dtype)
        dq = flash_attention_dq(qp, kp, vp, dop, lsep, dsum, causal, window)
    return dq[:, :Sq], dk[:, :Skv], dv[:, :Skv]


class _FlashAttention(torch.autograd.Function):
    """Forward kernel; backward through the dkv and dq kernels. Saves
    (q, k, v, o, lse), as the reference's custom_vjp does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = flash_attention_fwd(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Differentiable flash attention: the output of ``flash_attention_fwd``,
    with gradients through ``flash_attention_bwd``."""
    return _FlashAttention.apply(q, k, v, causal, window)


# ---------------------------------------------------------------------------
# kernel launches (operands padded to the block)
# ---------------------------------------------------------------------------

def _operands(what: str, q, k, v, *more):
    ts = [t.contiguous() for t in (q, k, v, *more)]
    for t, name in zip(ts, ("q", "k", "v", "do")):
        _lib.require_cuda(t, f"{what} {name}", _lib.SERVING_DTYPES)
    if len({t.dtype for t in ts}) != 1 or len({t.device for t in ts}) != 1:
        raise TypeError(f"{what}: operands must share dtype and device")
    hd = ts[0].shape[3]
    if hd not in _lib.HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {hd} not in {_lib.HEAD_DIMS}")
    return ts


def _stats(what: str, lse, dsum, shape):
    out = []
    for t, name in ((lse, "lse"), (dsum, "dsum")):
        t = t.contiguous()
        _lib.require_cuda(t, f"{what} {name}", (torch.float32,))
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} shape {tuple(t.shape)} != {shape}")
        out.append(t)
    return out


def _dims(q, k):
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    if Sq % BLOCK or Skv % BLOCK:
        raise ValueError(f"flash_attention: Sq={Sq} and Skv={Skv} must be "
                         f"multiples of {BLOCK}")
    return B, Sq, Skv, H, KV, hd


def _variant(q) -> str:
    """The kernel a dtype selects, fixed: bfloat16 runs the forward and the
    dkv pass on the tensor cores (wgmma), float32 on the CUDA cores; the
    C entry points dispatch on the same dtype code."""
    return "wgmma" if q.dtype == torch.bfloat16 else "cudacore"


def _launch_fwd(q, k, v, causal, window):
    q, k, v = _operands("flash_attention_fwd", q, k, v)
    B, Sq, Skv, H, KV, hd = _dims(q, k)
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
    _lib.LAUNCHES["flash_attention_fwd_" + _variant(q)] += 1
    return o, lse


def flash_attention_dkv(q, k, v, do, lse, dsum, causal: bool = True,
                        window: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The dkv pass on block-aligned operands: (dk, dv) per *query* head,
    float32 (B,Skv,H,hd). lse, dsum: (B,H,Sq) float32."""
    if q.device.type == "cpu":
        return attention_dkv_ref(q, k, v, do, lse, dsum, causal=causal,
                                 window=window)
    q, k, v, do = _operands("flash_attention_dkv", q, k, v, do)
    B, Sq, Skv, H, KV, hd = _dims(q, k)
    lse, dsum = _stats("flash_attention_dkv", lse, dsum, (B, H, Sq))
    dk = torch.empty((B, Skv, H, hd), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    if dk.numel() == 0:
        return dk, dv
    err = _lib.library().spot_flash_attention_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dsum.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, Sq, Skv, H, KV, hd, _lib.DTYPE_CODES[q.dtype], int(bool(causal)),
        int(window), 1.0 / math.sqrt(hd), _lib.stream_ptr(q.device))
    _lib.check(err, "flash_attention_dkv")
    _lib.LAUNCHES["flash_attention_dkv"] += 1
    _lib.LAUNCHES["flash_attention_dkv_" + _variant(q)] += 1
    return dk, dv


def flash_attention_dq(q, k, v, do, lse, dsum, causal: bool = True,
                       window: int = 0) -> torch.Tensor:
    """The dq pass on block-aligned operands: dq in q's dtype (B,Sq,H,hd)."""
    if q.device.type == "cpu":
        return attention_dq_ref(q, k, v, do, lse, dsum, causal=causal,
                                window=window)
    q, k, v, do = _operands("flash_attention_dq", q, k, v, do)
    B, Sq, Skv, H, KV, hd = _dims(q, k)
    lse, dsum = _stats("flash_attention_dq", lse, dsum, (B, H, Sq))
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    err = _lib.library().spot_flash_attention_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
        B, Sq, Skv, H, KV, hd, _lib.DTYPE_CODES[q.dtype], int(bool(causal)),
        int(window), 1.0 / math.sqrt(hd), _lib.stream_ptr(q.device))
    _lib.check(err, "flash_attention_dq")
    _lib.LAUNCHES["flash_attention_dq"] += 1
    return dq
