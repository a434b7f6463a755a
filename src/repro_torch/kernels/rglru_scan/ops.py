"""RG-LRU scan: the CUDA kernel for CUDA tensors, the plain version for CPU
tensors.

The scan is the torch op ``repro_torch::rglru_scan`` (``kernels/_ops.py``).
``rglru_scan`` is the raw entry point (h and the last state) and refuses
inputs that require grad. ``lru_scan`` is differentiable: the op's backward
is the op ``repro_torch::rglru_scan_bwd``, which differentiates the plain
version, as the reference's ``custom_vjp`` does
(``kernels/rglru_scan/ops.py``). The backward has no kernel, on the card as
on the CPU (the reference has none either): it is an op so that a traced
step sees one backward op a layer, with its fake implementation and FLOP
formula, instead of the plain version's ops a step at a time. A CUDA tensor
always launches the forward kernel or raises; there is no fallback."""

from __future__ import annotations

import ctypes

import torch

from .. import _lib, _local, _ops
from .ref import rglru_scan_ref


def _check(a, b) -> None:
    if a.ndim != 3 or a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError(f"rglru_scan: a {tuple(a.shape)} {a.dtype} and "
                         f"b {tuple(b.shape)} {b.dtype} must match, 3-d")


def _scan(a, b):
    """The op on either device: the kernel for CUDA tensors, the plain
    version for CPU ones."""
    _check(a, b)
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


def _scan_fake(a, b):
    _check(a, b)
    return (a.new_empty(a.shape),
            a.new_empty((a.shape[0], a.shape[2]), dtype=torch.float32))


def _scan_flops(a_shape, b_shape, *, out_shape=None, **_kw) -> int:
    """2 FLOPs (a multiply and an add) for each step and channel of each
    batch row."""
    Bb, S, W = a_shape
    return 2 * Bb * S * W


SCAN = _ops.define("rglru_scan", "(Tensor a, Tensor b) -> (Tensor, Tensor)",
                   impl=_scan, plain=_scan, fake=_scan_fake,
                   flops=_scan_flops)


def rglru_scan(a: torch.Tensor, b: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """a, b: (B,S,W), same dtype -> (h (B,S,W) in a's dtype,
    h_last (B,W) float32)."""
    _lib.refuse_grad("rglru_scan", a, b)
    if _local.any_dtensor(a, b):
        return _local.lru_scan(SCAN, a, b)
    return SCAN(a, b)


def scan_layout(B: int, W: int, dtype: torch.dtype) -> dict:
    """The kernel's launch layout at (B, ., W): channels a CTA (one thread
    each), steps a staged chunk, ring slots, CTAs, dynamic shared memory
    bytes a CTA, CTAs resident on an SM."""
    out = (ctypes.c_int * 6)()
    _lib.check(_lib.library().spot_rglru_scan_layout(
        B, W, _lib.DTYPE_CODES[dtype], out), "rglru_scan_layout")
    return dict(zip(("channels_per_cta", "steps_per_chunk", "stages", "ctas",
                     "smem_bytes", "ctas_per_sm"), out))


def _scan_bwd(a, b, dh):
    """The gradients of h with respect to (a, b): autograd of the plain
    version on those inputs, on either device (no kernel)."""
    with _ops.autograd_inside():
        inputs = [t.detach().requires_grad_(True) for t in (a, b)]
        h = rglru_scan_ref(*inputs)[0]
        return tuple(torch.autograd.grad(h, inputs, dh))


def _scan_bwd_fake(a, b, dh):
    _check(a, b)
    return a.new_empty(a.shape), b.new_empty(b.shape)


def _scan_bwd_flops(a_shape, b_shape, dh_shape, *, out_shape=None,
                    **_kw) -> int:
    """What the plain autograd computes, counted as the forward's formula
    is: 5 FLOPs for each step and channel of each batch row (the forward
    recomputed, a multiply and an add; the gradient carried back through
    a, a's own product with the previous state, and the add that joins the
    two gradients of each h), 2 fewer at the first step, whose previous
    state is zero. Autograd's adds of each step's gradient slice into a
    zero tensor the size of the whole input (quadratic in S, an artefact
    of differentiating a Python loop that the reference's scan does not
    have) are not counted."""
    Bb, S, W = a_shape
    return Bb * W * (5 * S - 2)


BWD = _ops.define("rglru_scan_bwd",
                  "(Tensor a, Tensor b, Tensor dh) -> (Tensor, Tensor)",
                  impl=_scan_bwd, plain=_scan_bwd, fake=_scan_bwd_fake,
                  flops=_scan_bwd_flops)


def _setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, dh, _dh_last):
    grads = BWD(*ctx.saved_tensors, dh)
    return tuple(g if need else None
                 for g, need in zip(grads, ctx.needs_input_grad))


torch.library.register_autograd(f"{_ops.NAMESPACE}::rglru_scan", _backward,
                                setup_context=_setup, lib=_ops.LIB)


def lru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Differentiable RG-LRU scan: h (B,S,W) in a's dtype; forward through
    ``rglru_scan``'s op, backward through ``rglru_scan_bwd`` (autograd of
    the plain version) on the saved inputs."""
    if _local.any_dtensor(a, b):
        return _local.lru_scan(SCAN, a, b)[0]
    return SCAN(a, b)[0]
