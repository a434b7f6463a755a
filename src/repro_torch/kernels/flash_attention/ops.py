"""Flash attention, forward and backward: the CUDA kernels for CUDA tensors,
the plain versions for CPU tensors.

Sequences are padded to the kernels' 64-row blocks under the reference's
rule (``kernels/flash_attention/ops.py``): padded query rows are sliced
off, and padded key rows are allowed only for causal self-attention, where
no real query row can see them. The backward pads q, o and dO to the block,
k and v to the block and lse with zeros; a padded row's dO is zero, so it
adds exactly nothing to any gradient. The padding runs on either device, so
the CPU tests reach it.

The forward and the backward are torch ops (``kernels/_ops.py``):
``repro_torch::flash_attention_fwd``, differentiable through
``repro_torch::flash_attention_bwd``, keeping (q, k, v, o, lse), the
reference's residency policy. ``flash_attention`` is the differentiable
entry point; ``flash_attention_fwd`` is the raw forward and, like a raw
``pallas_call``, refuses inputs that require grad. A CUDA tensor always
launches the kernels or raises; there is no fallback.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import _lib, _local, _ops
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


def _fwd(q, k, v, causal, window):
    """The forward op on either device: the kernel for CUDA tensors, the
    plain version for CPU ones, on operands padded to the block."""
    _check_shapes(q, k, v)
    Sq, Skv = q.shape[1], k.shape[1]
    Sq_p, Skv_p = _padded_lengths(Sq, Skv, causal)
    qp, kp, vp = _pad_seq(q, Sq_p), _pad_seq(k, Skv_p), _pad_seq(v, Skv_p)
    if q.device.type == "cpu":
        o, lse = attention_ref(qp, kp, vp, causal=causal, window=window)
    else:
        o, lse = _launch_fwd(qp, kp, vp, causal, window)
    return o[:, :Sq], lse[..., :Sq]


def _fwd_fake(q, k, v, causal, window):
    _check_shapes(q, k, v)
    _padded_lengths(q.shape[1], k.shape[1], causal)
    B, Sq, H, _hd = q.shape
    return q.new_empty(q.shape), q.new_empty((B, H, Sq), dtype=torch.float32)


def _pair_flops(per_pair: int, q_shape, k_shape, causal, window) -> int:
    """``per_pair`` FLOPs a head dimension for each unmasked (q, k) pair of
    each batch row and query head (the forward 4: q.k and p.v; dkv 8; dq
    6)."""
    B, Sq, H, hd = q_shape
    return per_pair * B * H * hd * _ops.causal_pairs(int(Sq), int(k_shape[1]),
                                                     bool(causal), int(window))


def _fwd_flops(q_shape, k_shape, v_shape, causal, window, *, out_shape=None,
               **_kw) -> int:
    return _pair_flops(4, q_shape, k_shape, causal, window)


def _bwd(q, k, v, o, lse, do, causal, window):
    """The backward op on either device: dkv and dq kernels for CUDA
    tensors, the plain backward for CPU ones."""
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


def _bwd_fake(q, k, v, o, lse, do, causal, window):
    _check_shapes(q, k, v)
    _padded_lengths(q.shape[1], k.shape[1], causal)
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _bwd_flops(q_shape, k_shape, v_shape, o_shape, lse_shape, do_shape,
               causal, window, *, out_shape=None, **_kw) -> int:
    return _pair_flops(8 + 6, q_shape, k_shape, causal, window)


FWD = _ops.define(
    "flash_attention_fwd",
    "(Tensor q, Tensor k, Tensor v, bool causal, int window) -> (Tensor, Tensor)",
    impl=_fwd, plain=_fwd, fake=_fwd_fake, flops=_fwd_flops)
BWD = _ops.define(
    "flash_attention_bwd",
    "(Tensor q, Tensor k, Tensor v, Tensor o, Tensor lse, Tensor do, "
    "bool causal, int window) -> (Tensor, Tensor, Tensor)",
    impl=_bwd, plain=_bwd, fake=_bwd_fake, flops=_bwd_flops)


def _setup(ctx, inputs, output):
    """Keeps (q, k, v, o, lse), as the reference's custom_vjp does."""
    q, k, v, causal, window = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.causal, ctx.window = causal, window
    ctx.mark_non_differentiable(lse)


def _backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = BWD(q, k, v, o, lse, do.contiguous(), ctx.causal, ctx.window)
    return dq, dk, dv, None, None


torch.library.register_autograd(f"{_ops.NAMESPACE}::flash_attention_fwd",
                                _backward, setup_context=_setup, lib=_ops.LIB)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """q: (B,Sq,H,hd); k,v: (B,Skv,KV,hd). Returns (o (B,Sq,H,hd),
    lse (B,H,Sq) float32)."""
    _lib.refuse_grad("flash_attention_fwd", q, k, v)
    return FWD(q, k, v, bool(causal), int(window))


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        window: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of ``flash_attention`` from the forward's
    ``o`` and ``lse`` and the output gradient ``do``; dk and dv are summed
    over each KV head's group of query heads, in k's and v's dtypes."""
    return BWD(q, k, v, o, lse, do, bool(causal), int(window))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Differentiable flash attention: the output of ``flash_attention_fwd``,
    with gradients through ``flash_attention_bwd``. On ``DTensor``s the op
    runs on each rank's local shards (``_local.attention``)."""
    if _local.any_dtensor(q, k, v):
        return _local.attention(
            lambda q_, k_, v_: FWD(q_, k_, v_, bool(causal), int(window))[0],
            q, k, v)
    return FWD(q, k, v, bool(causal), int(window))[0]


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


# The kernel each dtype selects for each pass, fixed, every one on the
# tensor cores: bfloat16 runs the forward, dkv and dq through wgmma; float32
# runs all three in 3xTF32 (mma.sync, each product three TF32 products).
# The C entry points dispatch on the same dtype code.
VARIANTS = {torch.bfloat16: {"fwd": "wgmma", "dkv": "wgmma", "dq": "wgmma"},
            torch.float32: {"fwd": "tf32x3", "dkv": "tf32x3",
                            "dq": "tf32x3"}}


def _count(q, pass_: str) -> None:
    """One launch of ``pass_`` on ``q``'s dtype: counted under the pass and
    under the variant the dtype selects."""
    _lib.LAUNCHES[f"flash_attention_{pass_}"] += 1
    _lib.LAUNCHES[f"flash_attention_{pass_}_{VARIANTS[q.dtype][pass_]}"] += 1


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """The bf16 forward reads q, k and v through TMA tensor maps, and the
    float32 forward and the backward passes copy their tiles 16 bytes at a
    time (cp.async): a base address must be 16-byte aligned, so a view that
    starts elsewhere is copied."""
    return t.clone() if t.data_ptr() % 16 else t


def _launch_fwd(q, k, v, causal, window):
    q, k, v = map(_aligned16, _operands("flash_attention_fwd", q, k, v))
    B, Sq, Skv, H, KV, hd = _dims(q, k)
    # both kernels write every row of o and lse (each CTA its q tile,
    # whether or not it sees a key), so neither is filled first
    o = _lib.kernel_output(q.shape, q.dtype, q.device)
    lse = _lib.kernel_output((B, H, Sq), torch.float32, q.device)
    if o.numel() == 0:
        return o, lse
    err = _lib.library().spot_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, Sq, Skv, H, KV, hd, _lib.DTYPE_CODES[q.dtype], int(bool(causal)),
        int(window), 1.0 / math.sqrt(hd), _lib.stream_ptr(q.device))
    _lib.check(err, "flash_attention_fwd")
    _count(q, "fwd")
    return o, lse


def flash_attention_dkv(q, k, v, do, lse, dsum, causal: bool = True,
                        window: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The dkv pass on block-aligned operands: (dk, dv) per *query* head,
    float32 (B,Skv,H,hd). lse, dsum: (B,H,Sq) float32."""
    if q.device.type == "cpu":
        return attention_dkv_ref(q, k, v, do, lse, dsum, causal=causal,
                                 window=window)
    q, k, v, do = map(_aligned16, _operands("flash_attention_dkv", q, k, v,
                                           do))
    B, Sq, Skv, H, KV, hd = _dims(q, k)
    lse, dsum = map(_aligned16, _stats("flash_attention_dkv", lse, dsum,
                                       (B, H, Sq)))
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
    _count(q, "dkv")
    return dk, dv


def flash_attention_dq(q, k, v, do, lse, dsum, causal: bool = True,
                       window: int = 0) -> torch.Tensor:
    """The dq pass on block-aligned operands: dq in q's dtype (B,Sq,H,hd)."""
    if q.device.type == "cpu":
        return attention_dq_ref(q, k, v, do, lse, dsum, causal=causal,
                                window=window)
    q, k, v, do = map(_aligned16, _operands("flash_attention_dq", q, k, v,
                                           do))
    B, Sq, Skv, H, KV, hd = _dims(q, k)
    lse, dsum = map(_aligned16, _stats("flash_attention_dq", lse, dsum,
                                       (B, H, Sq)))
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    err = _lib.library().spot_flash_attention_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
        B, Sq, Skv, H, KV, hd, _lib.DTYPE_CODES[q.dtype], int(bool(causal)),
        int(window), 1.0 / math.sqrt(hd), _lib.stream_ptr(q.device))
    _lib.check(err, "flash_attention_dq")
    _count(q, "dq")
    return dq
