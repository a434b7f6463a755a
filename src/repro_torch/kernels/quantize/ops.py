"""Quantize wrappers: the CUDA kernels for CUDA tensors, the plain PyTorch
versions for CPU tensors.

``quantize_int8`` is what the urgent save's extract calls; ``dequantize_int8``
/ ``dequantize_int8_many`` are the streaming restore's mirror. Only the
absmax *scalar* crosses to the host, where ``serialize.int8_scale_inv``
computes the scale and its inverse in numpy float32 — the same step every
quantize path takes, so device- and host-quantized payloads are identical.
A CUDA tensor always launches the kernels or raises; there is no fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...checkpoint.serialize import int8_scale_inv
from .. import _lib
from .ref import absmax_ref, dequantize_int8_ref, quantize_with_inv_ref

FLOAT_DTYPES = _lib.FLOAT_DTYPES
_MAX_PARTIALS = 1024                 # MAX_PARTIALS in csrc/quantize.cu
ABSMAX_THREADS, ABSMAX_LOADS = 1024, 4  # the same names there


def absmax_grid(dtype: torch.dtype) -> tuple[int, int]:
    """(CTAs, elements per trip) of absmax's first pass on a large tensor
    of ``dtype`` on this card: the resident grid (SMs times the kernel's
    occupancy, at most 1024) of 1024-thread CTAs, each thread reading
    four 16-byte loads a trip."""
    grid = _lib.library().spot_absmax_grid(_lib.DTYPE_CODES[dtype])
    itemsize = torch.finfo(dtype).bits // 8
    return grid, grid * ABSMAX_THREADS * ABSMAX_LOADS * 16 // itemsize


def dequantize_layout(dtype: torch.dtype) -> dict:
    """dequantize's launch layout for a ``dtype`` output on this card: the
    resident grid (SMs times the kernel's occupancy), threads a CTA, loads
    a thread and trip, int8 values a load (each widened into one 16-byte
    store), and the values a trip of the whole grid covers."""
    out = (ctypes.c_int * 4)()
    _lib.check(_lib.library().spot_dequantize_layout(_lib.DTYPE_CODES[dtype], out),
               "dequantize_layout")
    lay = dict(zip(("ctas", "threads", "loads_per_trip", "values_per_load"), out))
    lay["values_per_trip"] = (lay["ctas"] * lay["threads"] * lay["loads_per_trip"]
                              * lay["values_per_load"])
    return lay


def absmax(x: torch.Tensor) -> torch.Tensor:
    """max|x| as a float32 tensor of shape (1,) on x's device (NaN if any
    element is NaN)."""
    if x.device.type == "cpu":
        return absmax_ref(x).reshape(1)
    _lib.require_cuda(x, "absmax", FLOAT_DTYPES)
    # the result and the per-CTA partials in one allocation (under
    # deterministic algorithms every allocation is filled: one fill, not two)
    buf = torch.empty(1 + _MAX_PARTIALS, dtype=torch.int32, device=x.device)
    out = buf[:1].view(torch.float32)
    if x.numel() == 0:
        return out.zero_()
    err = _lib.library().spot_absmax(
        x.data_ptr(), x.numel(), _lib.DTYPE_CODES[x.dtype], buf[1:].data_ptr(),
        _MAX_PARTIALS, out.data_ptr(), _lib.stream_ptr(x.device))
    _lib.check(err, "absmax")
    _lib.LAUNCHES["absmax"] += 1
    return out


def quantize_with_inv(x: torch.Tensor, inv) -> torch.Tensor:
    """Elementwise int8(clip(rint(x * inv), ±127)) with float32 ``inv``."""
    if x.device.type == "cpu":
        return quantize_with_inv_ref(x, inv)
    _lib.require_cuda(x, "quantize", FLOAT_DTYPES)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if x.numel() == 0:
        return q
    err = _lib.library().spot_quantize(
        x.data_ptr(), x.numel(), _lib.DTYPE_CODES[x.dtype],
        float(np.float32(inv)), q.data_ptr(), _lib.stream_ptr(x.device))
    _lib.check(err, "quantize")
    _lib.LAUNCHES["quantize"] += 1
    return q


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, float]:
    """x -> (q int8 of x.shape on x's device, float32 scale as a float).

    The payload stays on the device — it crosses the device→host link at 1/4
    width during urgent checkpoint extraction. Only the absmax scalar syncs.
    """
    if x.numel() == 0:
        return torch.zeros(x.shape, dtype=torch.int8, device=x.device), 1.0
    if x.device.type != "cpu":
        x = x.contiguous()
    scale, inv = int8_scale_inv(absmax(x).cpu().numpy()[0])
    return quantize_with_inv(x, inv), float(scale)


def dequantize_int8(q: torch.Tensor, scale, *, dtype: torch.dtype
                    ) -> torch.Tensor:
    """(q int8, absmax scale) -> tensor of ``dtype`` on q's device —
    bit-identical to the host ``serialize.finish_payload``."""
    if q.device.type == "cpu":
        return dequantize_int8_ref(q, scale, dtype=dtype)
    _lib.require_cuda(q, "dequantize", (torch.int8,))
    if dtype not in FLOAT_DTYPES:
        raise TypeError(f"dequantize: unsupported target dtype {dtype}")
    out = _lib.kernel_output(q.shape, dtype, q.device)
    if q.numel() == 0:
        return out
    err = _lib.library().spot_dequantize(
        q.data_ptr(), q.numel(), float(np.float32(scale)),
        _lib.DTYPE_CODES[dtype], out.data_ptr(), _lib.stream_ptr(q.device))
    _lib.check(err, "dequantize")
    _lib.LAUNCHES["dequantize"] += 1
    return out


def dequantize_int8_many(qs, scales, dtypes) -> list[torch.Tensor]:
    """Widen a restore's int8 payloads: one launch per tensor."""
    return [dequantize_int8(q, s, dtype=d) for q, s, d in zip(qs, scales, dtypes)]
