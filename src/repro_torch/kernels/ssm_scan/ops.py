"""Selective scan: the CUDA kernel for CUDA tensors, the plain version for
CPU tensors.

``ssm_scan`` is the raw kernel (y and the last state) and refuses inputs
that require grad. ``selective_scan`` is differentiable: an
``autograd.Function`` whose forward is ``ssm_scan`` and whose backward
differentiates the plain version, as the reference's ``custom_vjp`` does
(``kernels/ssm_scan/ops.py``). A CUDA tensor always launches the kernel or
raises; there is no fallback.
"""

from __future__ import annotations

import torch

from .. import _lib
from .ref import ssm_scan_ref


def ssm_scan(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """u, delta: (B,S,DI) in one dtype; A: (DI,N), D: (DI,) float32; B, C:
    (B,S,N). Returns (y (B,S,DI) in u's dtype, h_last (B,DI,N) float32)."""
    _lib.refuse_grad("ssm_scan", u, delta, A, B, C, D)
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
    if u.device.type == "cpu":
        return ssm_scan_ref(u, delta, A, B, C, D)
    return _launch(u, delta, A, B, C, D)


def _launch(u, delta, A, B, C, D):
    u, delta = u.contiguous(), delta.contiguous()
    _lib.require_cuda(u, "ssm_scan u", _lib.SERVING_DTYPES)
    _lib.require_cuda(delta, "ssm_scan delta", _lib.SERVING_DTYPES)
    # B_t and C_t are read by every channel: widened once here (B*S*N
    # values, a small fraction of u's)
    B, C = B.to(torch.float32).contiguous(), C.to(torch.float32).contiguous()
    for t, name in ((A, "A"), (B, "B"), (C, "C"), (D, "D")):
        _lib.require_cuda(t, f"ssm_scan {name}", (torch.float32,))
    A, D = A.contiguous(), D.contiguous()
    Bb, S, DI = u.shape
    N = A.shape[1]
    if N != _lib.SSM_STATES:
        raise ValueError(f"ssm_scan: d_state {N} is not the built "
                         f"{_lib.SSM_STATES}")
    y = torch.empty_like(u)
    h_last = torch.zeros((Bb, DI, N), dtype=torch.float32, device=u.device)
    if y.numel() == 0:
        return y, h_last
    err = _lib.library().spot_ssm_scan(
        u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), D.data_ptr(), y.data_ptr(), h_last.data_ptr(), Bb, S,
        DI, N, _lib.DTYPE_CODES[u.dtype], _lib.stream_ptr(u.device))
    _lib.check(err, "ssm_scan")
    _lib.LAUNCHES["ssm_scan"] += 1
    return y, h_last


class _SelectiveScan(torch.autograd.Function):
    """Forward through ``ssm_scan``; backward through autograd of the plain
    version on the saved inputs."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D):
        ctx.save_for_backward(u, delta, A, B, C, D)
        return ssm_scan(u, delta, A, B, C, D)[0]

    @staticmethod
    def backward(ctx, dy):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = ssm_scan_ref(*inputs)[0]
        grads = torch.autograd.grad(y, inputs, dy)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def selective_scan(u, delta, A, B, C, D) -> torch.Tensor:
    """Differentiable selective scan: y (B,S,DI) in u's dtype."""
    return _SelectiveScan.apply(u, delta, A, B, C, D)
