"""Selective scan: the CUDA kernel for CUDA tensors, the plain version for
CPU tensors.

The scan is the torch op ``repro_torch::ssm_scan`` (``kernels/_ops.py``).
``ssm_scan`` is the raw entry point (y and the last state) and refuses
inputs that require grad. ``selective_scan`` is differentiable: the op's
backward is the op ``repro_torch::ssm_scan_bwd``, which differentiates the
plain version, as the reference's ``custom_vjp`` does
(``kernels/ssm_scan/ops.py``). The backward has no kernel, on the card as
on the CPU (the reference has none either): it is an op so that a traced
step sees one backward op a layer, with its fake implementation and FLOP
formula, instead of the plain version's ops a step at a time. A CUDA
tensor always launches the forward kernel or raises; there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _lib, _local, _ops
from .ref import ssm_scan_ref


def _check(u, delta, A, B, C, D) -> None:
    Bb, S, DI = u.shape
    N = A.shape[1]
    if (delta.shape != u.shape or delta.dtype != u.dtype
            or tuple(A.shape) != (DI, N) or tuple(D.shape) != (DI,)
            or tuple(B.shape) != (Bb, S, N) or B.shape != C.shape):
        raise ValueError(
            f"ssm_scan: shapes u {tuple(u.shape)} {u.dtype}, delta "
            f"{tuple(delta.shape)} {delta.dtype}, A {tuple(A.shape)}, B "
            f"{tuple(B.shape)}, C {tuple(C.shape)}, D {tuple(D.shape)} do "
            "not fit")


def _scan(u, delta, A, B, C, D):
    """The op on either device: the kernel for CUDA tensors, the plain
    version for CPU ones."""
    _check(u, delta, A, B, C, D)
    if u.device.type == "cpu":
        return ssm_scan_ref(u, delta, A, B, C, D)
    return _launch(u, delta, A, B, C, D)


def _scan_fake(u, delta, A, B, C, D):
    _check(u, delta, A, B, C, D)
    return (u.new_empty(u.shape),
            u.new_empty((u.shape[0], u.shape[2], A.shape[1]),
                        dtype=torch.float32))


def _scan_flops(u_shape, delta_shape, A_shape, B_shape, C_shape, D_shape, *,
                out_shape=None, **_kw) -> int:
    """7 FLOPs for each (step, channel, state) of each batch row: the
    exponential and its argument's product, the state's product and fused
    multiply-add, and y's fused multiply-add."""
    Bb, S, DI = u_shape
    return 7 * Bb * S * DI * A_shape[1]


SCAN = _ops.define(
    "ssm_scan",
    "(Tensor u, Tensor delta, Tensor A, Tensor B, Tensor C, Tensor D) "
    "-> (Tensor, Tensor)",
    impl=_scan, plain=_scan, fake=_scan_fake, flops=_scan_flops)


def ssm_scan(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """u, delta: (B,S,DI) in one dtype; A: (DI,N), D: (DI,) float32; B, C:
    (B,S,N) of any float dtype (the kernel reads float32 or u's dtype as
    they are, views into a projection's output included, and widens any
    other to float32 first). Returns (y (B,S,DI) in u's dtype, h_last
    (B,DI,N) float32)."""
    _lib.refuse_grad("ssm_scan", u, delta, A, B, C, D)
    if _local.any_dtensor(u, delta, A, B, C, D):
        return _local.selective_scan(SCAN, u, delta, A, B, C, D)
    return SCAN(u, delta, A, B, C, D)


def _row_stride(t: torch.Tensor) -> int | None:
    """Values between consecutive steps of a (B,S,N) operand whose (b, t)
    rows lie one stride apart with unit-stride states (a view into the
    projection's output is one), else None."""
    Bb, S, N = t.shape
    if N > 1 and t.stride(2) != 1:
        return None
    ld = t.stride(1) if S > 1 else (t.stride(0) if Bb > 1 else N)
    if Bb > 1 and t.stride(0) != S * ld:
        return None
    return ld if ld >= N else None


def _launch(u, delta, A, B, C, D):
    u, delta = u.contiguous(), delta.contiguous()
    _lib.require_cuda(u, "ssm_scan u", _lib.SERVING_DTYPES)
    _lib.require_cuda(delta, "ssm_scan delta", _lib.SERVING_DTYPES)
    A, D = A.contiguous(), D.contiguous()
    for t, name in ((A, "A"), (D, "D")):
        _lib.require_cuda(t, f"ssm_scan {name}", (torch.float32,))
    Bb, S, DI = u.shape
    N = A.shape[1]
    if N != _lib.SSM_STATES:
        raise ValueError(f"ssm_scan: d_state {N} is not the built "
                         f"{_lib.SSM_STATES}")
    # B_t and C_t are read in their own dtype (float32 or u's) and in place
    # where their steps lie one stride apart; otherwise one copy each
    if B.dtype != C.dtype or B.dtype not in (torch.float32, u.dtype):
        B, C = B.to(torch.float32), C.to(torch.float32)
    ld = _row_stride(B)
    if ld is None or ld != _row_stride(C):
        B, C = B.contiguous(), C.contiguous()
        ld = N
    for t, name in ((B, "B"), (C, "C")):
        if t.device.type != "cuda":
            raise ValueError(f"ssm_scan {name}: expected a CUDA tensor, got "
                             f"{t.device}")
    y = torch.empty_like(u)
    h_last = torch.zeros((Bb, DI, N), dtype=torch.float32, device=u.device)
    if y.numel() == 0:
        return y, h_last
    err = _lib.library().spot_ssm_scan(
        u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), D.data_ptr(), y.data_ptr(), h_last.data_ptr(), Bb, S,
        DI, N, ld, _lib.DTYPE_CODES[u.dtype], _lib.DTYPE_CODES[B.dtype],
        _lib.stream_ptr(u.device))
    _lib.check(err, "ssm_scan")
    _lib.LAUNCHES["ssm_scan"] += 1
    _lib.LAUNCHES[f"ssm_scan_{_lib.DTYPE_NAMES[u.dtype]}"] += 1
    return y, h_last


def scan_layout(DI: int, dtype: torch.dtype) -> dict:
    """The kernel's launch layout at DI channels: CTAs a batch row, threads
    a CTA, lanes a channel, steps a staged chunk, CTAs resident on an SM."""
    out = (ctypes.c_int * 5)()
    _lib.check(_lib.library().spot_ssm_scan_layout(
        DI, _lib.DTYPE_CODES[dtype], out), "ssm_scan_layout")
    return dict(zip(("ctas_per_row", "threads", "lanes_per_channel",
                     "steps_per_chunk", "ctas_per_sm"), out))


def _scan_bwd(u, delta, A, B, C, D, dy):
    """The gradients of y with respect to (u, delta, A, B, C, D): autograd of
    the plain version on those inputs, on either device (no kernel)."""
    with _ops.autograd_inside():
        inputs = [t.detach().requires_grad_(True)
                  for t in (u, delta, A, B, C, D)]
        y = ssm_scan_ref(*inputs)[0]
        return tuple(torch.autograd.grad(y, inputs, dy))


def _scan_bwd_fake(u, delta, A, B, C, D, dy):
    _check(u, delta, A, B, C, D)
    return tuple(t.new_empty(t.shape) for t in (u, delta, A, B, C, D))


def _scan_bwd_flops(u_shape, delta_shape, A_shape, B_shape, C_shape, D_shape,
                    dy_shape, *, out_shape=None, **_kw) -> int:
    """What the plain autograd computes, counted as the forward's formula
    is (each multiply, add and exponential an element; a reduction its
    input): the forward recomputed (6 an element of the state, 3 of y) and
    its backward, 22 for each (step, channel, state) of each batch row and
    8 for each (step, channel); the first step, whose previous state is
    zero, has 2 fewer for each (channel, state) of each row, and A's
    gradient is summed over the S steps. Exact where every dimension is
    above 1 (one of 1 drops a broadcast's reduction). Not counted:
    autograd's adds of each step's gradient slice into a zero tensor the
    size of the whole input, a cost quadratic in S that differentiating a
    Python loop brings and the reference's scan does not."""
    Bb, S, DI = u_shape
    N = A_shape[1]
    return 22 * Bb * S * DI * N + 8 * Bb * S * DI + (S - 1 - 2 * Bb) * DI * N


BWD = _ops.define(
    "ssm_scan_bwd",
    "(Tensor u, Tensor delta, Tensor A, Tensor B, Tensor C, Tensor D, "
    "Tensor dy) -> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)",
    impl=_scan_bwd, plain=_scan_bwd, fake=_scan_bwd_fake,
    flops=_scan_bwd_flops)


def _setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, dy, _dh_last):
    grads = BWD(*ctx.saved_tensors, dy)
    return tuple(g if need else None
                 for g, need in zip(grads, ctx.needs_input_grad))


torch.library.register_autograd(f"{_ops.NAMESPACE}::ssm_scan", _backward,
                                setup_context=_setup, lib=_ops.LIB)


def selective_scan(u, delta, A, B, C, D) -> torch.Tensor:
    """Differentiable selective scan: y (B,S,DI) in u's dtype; forward
    through ``ssm_scan``'s op, backward through ``ssm_scan_bwd`` (autograd
    of the plain version) on the saved inputs."""
    if _local.any_dtensor(u, delta, A, B, C, D):
        return _local.selective_scan(SCAN, u, delta, A, B, C, D)[0]
    return SCAN(u, delta, A, B, C, D)[0]
