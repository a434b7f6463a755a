"""RG-LRU scan: the CUDA kernel for CUDA tensors, the plain version for CPU
tensors.

``rglru_scan`` is the raw kernel (h and the last state) and refuses inputs
that require grad. ``lru_scan`` is differentiable: an ``autograd.Function``
whose forward is ``rglru_scan`` and whose backward differentiates the plain
version, as the reference's ``custom_vjp`` does (``kernels/rglru_scan/
ops.py``). A CUDA tensor always launches the kernel or raises; there is no
fallback."""

from __future__ import annotations

import ctypes

import torch

from .. import _lib
from .ref import rglru_scan_ref


def rglru_scan(a: torch.Tensor, b: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """a, b: (B,S,W), same dtype -> (h (B,S,W) in a's dtype,
    h_last (B,W) float32)."""
    _lib.refuse_grad("rglru_scan", a, b)
    if a.ndim != 3 or a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError(f"rglru_scan: a {tuple(a.shape)} {a.dtype} and "
                         f"b {tuple(b.shape)} {b.dtype} must match, 3-d")
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b)
    a, b = a.contiguous(), b.contiguous()
    _lib.require_cuda(a, "rglru_scan a", _lib.SERVING_DTYPES)
    _lib.require_cuda(b, "rglru_scan b", _lib.SERVING_DTYPES)
    Bb, S, W = a.shape
    h = _lib.kernel_output(a.shape, a.dtype, a.device)
    h_last = torch.zeros((Bb, W), dtype=torch.float32, device=a.device)
    if h.numel() == 0:
        return h, h_last
    err = _lib.library().spot_rglru_scan(
        a.data_ptr(), b.data_ptr(), h.data_ptr(), h_last.data_ptr(), Bb, S, W,
        _lib.DTYPE_CODES[a.dtype], _lib.stream_ptr(a.device))
    _lib.check(err, "rglru_scan")
    _lib.LAUNCHES["rglru_scan"] += 1
    return h, h_last


def scan_layout(B: int, W: int, dtype: torch.dtype) -> dict:
    """The kernel's launch layout at (B, ., W): channels a CTA (one thread
    each), steps a staged chunk, ring slots, CTAs, dynamic shared memory
    bytes a CTA, CTAs resident on an SM."""
    out = (ctypes.c_int * 6)()
    _lib.check(_lib.library().spot_rglru_scan_layout(
        B, W, _lib.DTYPE_CODES[dtype], out), "rglru_scan_layout")
    return dict(zip(("channels_per_cta", "steps_per_chunk", "stages", "ctas",
                     "smem_bytes", "ctas_per_sm"), out))


class _LruScan(torch.autograd.Function):
    """Forward through ``rglru_scan``; backward through autograd of the plain
    version on the saved inputs."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return rglru_scan(a, b)[0]

    @staticmethod
    def backward(ctx, dh):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            h = rglru_scan_ref(*inputs)[0]
        grads = torch.autograd.grad(h, inputs, dh)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def lru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Differentiable RG-LRU scan: h (B,S,W) in a's dtype."""
    return _LruScan.apply(a, b)
