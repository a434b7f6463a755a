#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU.

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, holds
each against its plain PyTorch version at the main path's shapes (the
checkpoint kernels and the RG-LRU scan bit for bit, the attention kernels
and the selective scan in float32 and bfloat16 within stated tolerances)
and times both, then drives the Spot-on loop through the entry points a
user calls, at phi3-mini's published width cut to a few layers and at
gemma3-1b's cut to one period, trains gemma3-1b at its full published
config, and serves gemma3-1b, recurrentgemma-2b and falcon-mamba-7b at
their full published configs, all with seeded weights:

  kernels         fingerprint / absmax / quantize / dequantize vs plain;
                  flash-attention forward, flash decode, the selective scan
                  and the RG-LRU scan vs plain at the serving shapes; the
                  flash-attention backward (dkv, dq) at the training shapes.
                  The forward and the dkv pass have two variants, chosen by
                  dtype: bfloat16 on the tensor cores (wgmma), float32 on
                  the CUDA cores; each is held, timed (with its TFLOP/s)
                  and listed as a row of its own
  delta           delta saves of the full-width state at 1% and 5% block
                  churn: exact d2h accounting, bit-identical restore
  spot_loop       transparent policy, one eviction: bitwise-equal final loss
                  against an uninterrupted run
  spot_loop_int8  the same on a quantize_moments store: the urgent save
                  quantizes the moments on the device, the restore widens
                  them there, bit-identical to the host dequantize
  train_gemma3    8 make_train_step steps of gemma3-1b (26 layers, bf16,
                  batch 2 x 2048), every attention layer through the flash
                  forward, dkv and dq kernels: step time, tokens/s, peak
                  memory, a profiled step; a float32 one-period copy's
                  gradients on the card against the same step on the host
  spot_loop_gemma3  the spot_loop contract at gemma3-1b's full width cut
                  to one period (6 layers), sequences of 1024
  serve_gemma3,   batch 4, a 1984-token prompt, 64 greedy tokens through
  serve_recurrentgemma,  serve.make_prefill / make_decode_step (and
  serve_falcon_mamba  serve.generate): prefill and decode tokens/s; a
                  float32 copy's decode logits against its teacher-forced
                  logits; a mid-generation save and restore that must
                  continue to bitwise the same tokens

Launch counts are reset just before each main-path run and read just after
it; every kernel must have launched on the main path. Every bf16 run's
flash forward and dkv launches must have gone through the tensor-core
variants, and the float32 runs (the one-period gradient check, the float32
decode against teacher forcing) through the CUDA-core ones. Prints the card's name and power
limit, one ``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``. Exits non-zero, without that line, if any
phase fails or no GPU is present.

    python3 chip_smoke.py
"""

from __future__ import annotations

import os

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import functools
import itertools
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
OPS32_PER_S = 67e12            # H100 SXM 32-bit rate outside the tensor cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core rate
                               # (NVIDIA H100 data sheet, no sparsity)
L2_BYTES = 50 * 2 ** 20        # H100 SXM L2 cache
CHUNK = 1 << 20
LAYERS = 2                     # phi3-mini at full width, cut in depth
STEPS = 8                      # train steps of each spot loop
SERVE_B, PROMPT, NEW, CACHE_LEN = 4, 1984, 64, 2048   # serving phases
SAVE_AT = 32                   # new tokens before the mid-generation save
LOGIT_TOL = 2e-3               # float32 decode vs teacher-forced logits
TRAIN_B, TRAIN_S = 2, 2048     # gemma3-1b training batch
PHI3_S = 2048                  # the kernels' phi3-mini case (32 heads of 96)
TRAIN_STEPS = 8
LOOP_LAYERS, LOOP_S = 6, 1024  # spot_loop_gemma3: one period, its sequences
GRAD_TOL = 2e-4                # backward kernels vs plain in float32, of
                               # max(1, max|plain|): the reference's
                               # gradient tolerance, 10 x 2e-5
MODEL_GRAD_TOL = 1e-4          # card vs host gradients, of each leaf's max
MODEL_LOSS_TOL = 1e-5          # card vs host loss, relative
SCAN_TOL = 1e-4                # selective scan vs plain: the reference's
SFU_PER_SM_CLOCK = 16          # exponentials per SM per clock (H100)
H100_SMS = 132
ATT_TOL = 2e-5                 # attention kernels vs plain in float32, abs;
                               # their float32 log-sum-exp, abs and rel
BF16_RTOL = 2 ** -7            # in bfloat16 each output within one bf16 ulp
                               # (+ ATT_TOL): both sides round nearly equal
                               # float32 values, so they differ by <= 1 ulp


class PhaseError(RuntimeError):
    pass


def need(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseError(what)


def nvidia_smi() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return res.stdout.strip().splitlines()[0] if res.stdout.strip() \
            else f"nvidia-smi: {res.stderr.strip()}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def time_ms(fn, reps: int = 20, runs: int = 5, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: CUDA events around ``reps``
    back-to-back calls, divided by ``reps``; the median of ``runs`` such
    windows. The checkpoint and scan operands exceed the L2, and the
    decode cases rotate cache copies that together exceed it, so those
    calls read from device memory; the flash forward is bound by
    operations."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / reps)
    return statistics.median(times)


def bound(nbytes: int, ops: int, ops_per_s: float = OPS32_PER_S
          ) -> tuple[float, str]:
    """Least time the card could take (ms): the larger of the bytes moved
    over the memory rate and the operations over the rate for their type
    (by default the 32-bit non-tensor-core rate), and which of the two it
    is."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = ops / ops_per_s * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def same_bits(a, b) -> bool:
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return torch.equal(a.reshape(-1).view(view[a.element_size()]),
                       b.reshape(-1).view(view[b.element_size()]))


def max_abs_err(a, b) -> float:
    import torch
    d = (a.to(torch.float64) - b.to(torch.float64)).abs()
    d = torch.nan_to_num(d, nan=0.0)
    return float(d.max()) if d.numel() else 0.0


# ---------------------------------------------------------------------------
# phase: kernels
# ---------------------------------------------------------------------------

def phase_kernels(cfg, dev) -> dict:
    """Each kernel against its plain version, bit-for-bit, at the main
    path's shapes; device times of kernel, plain version and library call."""
    import numpy as np
    import torch
    from repro_torch.checkpoint import serialize as ser
    from repro_torch.kernels.fingerprint import (fingerprint_blocks,
                                                 fingerprint_blocks_ref,
                                                 fingerprint_diff,
                                                 fingerprint_diff_ref)
    from repro_torch.kernels.quantize import (absmax, absmax_ref,
                                              dequantize_int8,
                                              dequantize_int8_ref,
                                              quantize_int8, quantize_with_inv,
                                              quantize_with_inv_ref)

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    embed = torch.randn((cfg.vocab_size, cfg.d_model), generator=g,
                        device=dev).to(torch.bfloat16)          # params/embed
    moment = torch.randn((2, cfg.d_model, cfg.d_ff), generator=g,
                         device=dev) * 1e-3                     # opt/mu of mlp/up
    out: dict = {}

    # fingerprint: dtypes of the state, 1 MiB blocks, ragged tails
    cases = [embed, moment,
             torch.randint(-128, 127, (3 * CHUNK + 12345,), dtype=torch.int8,
                           generator=g, device=dev),
             torch.randn((1_000_003,), generator=g, device=dev).to(torch.bfloat16),
             torch.randint(0, 1 << 40, (300_001,), generator=g, device=dev),
             torch.randint(0, 1 << 30, (5,), dtype=torch.int32, generator=g,
                           device=dev)]
    for x in cases:
        fp = fingerprint_blocks(x, block_bytes=CHUNK)
        need(same_bits(fp, fingerprint_blocks_ref(x, CHUNK)),
             f"fingerprint mismatch {tuple(x.shape)} {x.dtype}")
        old = fp.clone()
        old[::3] ^= 1
        fp2, diff = fingerprint_diff(x, old, block_bytes=CHUNK)
        fpr, diffr = fingerprint_diff_ref(x, old, CHUNK)
        need(same_bits(fp2, fpr) and torch.equal(diff, diffr),
             f"fingerprint_diff mismatch {tuple(x.shape)} {x.dtype}")
    old = fingerprint_blocks(embed, block_bytes=CHUNK)
    nb = old.numel()
    out["fingerprint"] = dict(
        ms=time_ms(lambda: fingerprint_diff(embed, old, block_bytes=CHUNK)),
        plain_ms=time_ms(lambda: fingerprint_diff_ref(embed, old, CHUNK), reps=5),
        library_ms=None, max_abs_err=max_abs_err(
            fingerprint_blocks(embed, block_bytes=CHUNK).to(torch.int64),
            fingerprint_blocks_ref(embed, CHUNK).to(torch.int64)),
        # bytes: the tensor once, old digests in, digests + diff out;
        # operations: 6 integer ops per word (one word per bf16 element):
        # pos*C1, xor, *C2, >>15, xor, add
        bound=bound(embed.numel() * 2 + nb * 9, embed.numel() * 6),
        shape=list(embed.shape), dtype="bfloat16")

    # absmax: moment (f32), embed (bf16), ragged, NaN
    for x in (moment, embed, cases[3], torch.randn(7, device=dev)):
        need(same_bits(absmax(x)[0], absmax_ref(x)), f"absmax mismatch {x.dtype}")
    xn = moment.clone()
    xn.view(-1)[12345] = float("nan")
    need(bool(torch.isnan(absmax(xn)[0])), "absmax dropped a NaN")
    out["absmax"] = dict(
        ms=time_ms(lambda: absmax(moment)),
        plain_ms=time_ms(lambda: absmax_ref(moment)),
        library_ms=time_ms(lambda: torch.linalg.vector_norm(moment, ord=math.inf)),
        max_abs_err=max_abs_err(absmax(moment)[0], absmax_ref(moment)),
        bound=bound(moment.numel() * 4 + 4, moment.numel() * 2),
        shape=list(moment.shape), dtype="float32")

    # quantize: kernel vs plain vs the host serialize.quantize
    for x in (moment, embed, cases[3]):
        q, scale = quantize_int8(x)
        inv = np.float32(1.0) / np.float32(scale)   # int8_scale_inv's inverse
        need(same_bits(q, quantize_with_inv_ref(x, inv)),
             f"quantize mismatch {x.dtype}")
    q, scale = quantize_int8(moment)
    hq, hscale = ser.quantize(moment.cpu().numpy(), "int8", "float32")
    need(hscale == scale and np.array_equal(hq, q.cpu().numpy()),
         "device quantize disagrees with the host serialize.quantize")
    inv = np.float32(1.0) / np.float32(scale)   # int8_scale_inv's inverse
    out["quantize"] = dict(
        ms=time_ms(lambda: quantize_with_inv(moment, inv)),
        plain_ms=time_ms(lambda: quantize_with_inv_ref(moment, inv)),
        library_ms=None, max_abs_err=max_abs_err(
            quantize_with_inv(moment, inv), quantize_with_inv_ref(moment, inv)),
        # multiply, round, 2 clamps, convert
        bound=bound(moment.numel() * 5, moment.numel() * 5),
        shape=list(moment.shape), dtype="float32")

    # dequantize: to f32 and bf16, vs plain and the host finish_payload
    for dt, name in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        for qq in (q, q.reshape(-1)[:1_000_003]):
            d = dequantize_int8(qq, scale, dtype=dt)
            need(same_bits(d, dequantize_int8_ref(qq, scale, dtype=dt)),
                 f"dequantize mismatch -> {name}")
        host = ser.finish_payload(q.cpu().numpy(), dtype_name=name,
                                  quant="int8", scale=scale)
        dev_out = ser.tensor_to_numpy(dequantize_int8(q, scale, dtype=dt).cpu())
        need(np.array_equal(host, dev_out),
             f"device dequantize disagrees with the host finish_payload ({name})")
    # library yardstick: int8 tensor times a 0-d f32 tensor promotes to
    # f32(q) * f32(scale) in one fused elementwise call, the same bits
    s_dev = torch.tensor(np.float32(scale), device=dev)
    need(same_bits(torch.mul(q, s_dev),
                   dequantize_int8(q, scale, dtype=torch.float32)),
         "dequantize disagrees with torch.mul(q, scale)")
    out["dequantize"] = dict(
        ms=time_ms(lambda: dequantize_int8(q, scale, dtype=torch.float32)),
        plain_ms=time_ms(lambda: dequantize_int8_ref(q, scale, dtype=torch.float32)),
        library_ms=time_ms(lambda: torch.mul(q, s_dev)), max_abs_err=max_abs_err(
            dequantize_int8(q, scale, dtype=torch.float32),
            dequantize_int8_ref(q, scale, dtype=torch.float32)),
        # convert, multiply
        bound=bound(q.numel() * 5, q.numel() * 2),
        shape=list(q.shape), dtype="int8->float32")
    del embed, moment, cases, xn
    torch.cuda.empty_cache()
    out.update(serving_kernels(dev))
    out.update(training_kernels(dev))
    out.update(scan_kernel(dev))
    return out


def _sdpa(q, k, v, **kw):
    """One scaled_dot_product_attention call on (B,H,S,hd) operands, KV
    heads shared through enable_gqa: the library yardstick."""
    import torch.nn.functional as F
    return functools.partial(F.scaled_dot_product_attention, q, k, v,
                             enable_gqa=True, **kw)


def _fwd_times(q, k, v, window, rate) -> dict:
    """Device times of the flash forward on causal (optionally windowed)
    self-attention operands, its plain version and SDPA (causal flag, or a
    band mask for a window), with the bound and the achieved rate. Each
    bound counts the work this data needs: the unmasked (q, k) pairs at 4
    FLOPs per pair and head dimension (QK^T and PV) over ``rate``, or the
    bytes of q, k, v read and o, lse written."""
    import torch
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_fwd)
    B, S, H, hd = q.shape
    flops = B * H * _pairs(S, window) * hd * 4
    nbytes = (q.numel() + k.numel() * 2 + q.numel()) * q.element_size() \
        + B * H * S * 4
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if window:
        pos = torch.arange(S, device=q.device)
        band = ((pos[None, :] <= pos[:, None])
                & (pos[None, :] > pos[:, None] - window))
        lib = _sdpa(qt, kt, vt, attn_mask=band)
    else:
        lib = _sdpa(qt, kt, vt, is_causal=True)
    ms = time_ms(lambda: flash_attention_fwd(q, k, v, True, window))
    return dict(ms=ms,
                plain_ms=time_ms(lambda: attention_ref(q, k, v, causal=True,
                                                       window=window), reps=5),
                library_ms=time_ms(lib), bound=bound(nbytes, flops, rate),
                tflops=flops / ms / 1e9)


def _att_check(what, got, want, lse=None, want_lse=None) -> float:
    """Hold an attention output against its plain version: float32 within
    ATT_TOL, bfloat16 within one ulp of each element (+ ATT_TOL); the
    log-sum-exp within ATT_TOL abs and rel. Returns max|got - want|."""
    import torch
    rtol = BF16_RTOL if got.dtype == torch.bfloat16 else 0.0
    err = max_abs_err(got, want)
    need(torch.allclose(got.float(), want.float(), atol=ATT_TOL, rtol=rtol),
         f"{what}: output differs from the plain version (max err {err}, "
         f"atol {ATT_TOL}, rtol {rtol})")
    if lse is not None:
        need(torch.allclose(lse, want_lse, atol=ATT_TOL, rtol=ATT_TOL),
             f"{what}: lse differs (max err {max_abs_err(lse, want_lse)})")
    return err


def serving_kernels(dev) -> dict:
    """The serving path's kernels against their plain versions at the
    shapes gemma3-1b and recurrentgemma-2b give them, with device times.
    The attention kernels are held in bfloat16 (the serving dtype, timed)
    and in float32 on the same values widened, where a fault in a partial
    chunk or the PV sum cannot hide under a bf16 rounding. Each bound counts
    the work this data needs: the unmasked (q, k) pairs of a causal or
    windowed row, the valid rows of a cache."""
    import torch
    from repro_torch.kernels.decode_attention import (decode_attention_ref,
                                                      flash_decode)
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_fwd)
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_ref

    g = torch.Generator(device=dev)
    g.manual_seed(1)
    bf, f32 = torch.bfloat16, torch.float32
    B, S, H, KV, hd = SERVE_B, PROMPT, 4, 1, 256     # gemma3-1b prefill
    q = torch.randn((B, S, H, hd), generator=g, device=dev).to(bf)
    k = torch.randn((B, S, KV, hd), generator=g, device=dev).to(bf)
    v = torch.randn((B, S, KV, hd), generator=g, device=dev).to(bf)
    out: dict = {}
    flash, flash32 = {}, {}
    for window in (512, 0):
        name = f"window_{window}" if window else "global"
        what = f"flash_attention window={window}"
        o, lse = flash_attention_fwd(q, k, v, True, window)
        want, want_lse = attention_ref(q, k, v, causal=True, window=window)
        err = _att_check(what, o, want, lse, want_lse)
        del want
        flash[name] = dict(
            _fwd_times(q, k, v, window, BF16_FLOPS_PER_S), max_abs_err=err,
            lse_max_abs_err=max_abs_err(lse, want_lse), tol=ATT_TOL,
            bf16_rtol=BF16_RTOL, shape=[B, S, H, KV, hd], window=window,
            dtype="bfloat16", kernel="wgmma (tensor cores)")
        # the CUDA-core float32 kernel on the same values widened: held
        # (no bf16 rounding to hide a fault in) and timed
        a32 = tuple(t.to(f32) for t in (q, k, v))
        o32, lse32 = flash_attention_fwd(*a32, True, window)
        want32, wl32 = attention_ref(*a32, causal=True, window=window)
        err32 = _att_check(what + " float32", o32, want32, lse32, wl32)
        del o32, lse32, want32, wl32
        flash32[name] = dict(
            _fwd_times(*a32, window, OPS32_PER_S), max_abs_err=err32,
            tol=ATT_TOL, shape=[B, S, H, KV, hd], window=window,
            dtype="float32", kernel="CUDA cores")
        del a32, o, lse
    # phi3-mini's heads (32 of 96) at a PHI3_S-token causal prefill
    qp, kp, vp = (torch.randn((1, PHI3_S, 32, 96), generator=g,
                              device=dev).to(bf) for _ in range(3))
    o, lse = flash_attention_fwd(qp, kp, vp, True, 0)
    want, want_lse = attention_ref(qp, kp, vp, causal=True)
    flash["phi3_hd96"] = dict(
        _fwd_times(qp, kp, vp, 0, BF16_FLOPS_PER_S),
        max_abs_err=_att_check("flash_attention phi3 hd 96", o, want, lse,
                               want_lse),
        tol=ATT_TOL, bf16_rtol=BF16_RTOL, shape=[1, PHI3_S, 32, 32, 96],
        window=0, dtype="bfloat16", kernel="wgmma (tensor cores)")
    del qp, kp, vp, o, lse, want
    # the rows: the global layer's case; the others beside it
    out["flash_attention_fwd_wgmma"] = dict(flash["global"], cases=flash)
    out["flash_attention_fwd_cudacore"] = dict(flash32["global"], cases=flash32)
    del q, k, v
    torch.cuda.empty_cache()

    # decode: gemma3's full cache at valid_len 2000 (not a multiple of the
    # kernel's 32-key chunk) and its filled 512-slot ring, and
    # recurrentgemma's 2048-slot ring at its first decode step (10 heads,
    # 1985 filled). Cache copies holding twice the L2 between them rotate
    # through the timed calls, so each call reads its cache from device
    # memory as a decode step does.
    dec = {}
    for name, Hd, Sc, vl in (("full", H, CACHE_LEN, PROMPT + 16),
                             ("ring", H, 512, 512),
                             ("ring_partial", 10, CACHE_LEN, PROMPT + 1)):
        qd = torch.randn((B, 1, Hd, hd), generator=g, device=dev).to(bf)
        n_copies = max(8, -(-2 * L2_BYTES // (B * Sc * KV * hd * 2 * 2)))
        ks = [torch.randn((B, Sc, KV, hd), generator=g, device=dev).to(bf)
              for _ in range(n_copies)]
        vs = [torch.randn((B, Sc, KV, hd), generator=g, device=dev).to(bf)
              for _ in range(n_copies)]
        o = flash_decode(qd, ks[0], vs[0], vl)
        want = decode_attention_ref(qd[:, 0], ks[0], vs[0], vl)[:, None]
        err = _att_check(f"flash_decode {name}", o, want)
        q32, k32, v32 = qd.to(f32), ks[0].to(f32), vs[0].to(f32)
        err32 = _att_check(f"flash_decode {name} float32",
                           flash_decode(q32, k32, v32, vl),
                           decode_attention_ref(q32[:, 0], k32, v32, vl)[:, None])
        del q32, k32, v32
        kernels = itertools.cycle([functools.partial(flash_decode, qd, kc, vc, vl)
                                   for kc, vc in zip(ks, vs)])
        qt = qd.transpose(1, 2).contiguous()               # (B,H,1,hd)
        mask = (torch.arange(Sc, device=dev) < vl)[None, None, None, :]
        libs = itertools.cycle([
            _sdpa(qt, kc.transpose(1, 2).contiguous(),
                  vc.transpose(1, 2).contiguous(), attn_mask=mask)
            for kc, vc in zip(ks, vs)])
        ops = B * Hd * vl * hd * 4
        nbytes = B * vl * KV * hd * 2 * 2 + qd.numel() * 2 * 2
        dec[name] = dict(
            ms=time_ms(lambda: next(kernels)()),
            plain_ms=time_ms(lambda: decode_attention_ref(qd[:, 0], ks[0],
                                                          vs[0], vl)),
            library_ms=time_ms(lambda: next(libs)()), max_abs_err=err,
            f32_max_abs_err=err32,
            bound=bound(nbytes, ops, BF16_FLOPS_PER_S), tol=ATT_TOL,
            bf16_rtol=BF16_RTOL, shape=[B, Sc, Hd, KV, hd], valid_len=vl,
            cache_copies=n_copies, dtype="bfloat16")
        del ks, vs, kernels, libs
    out["decode_attention"] = dict(dec["full"], cases=dec)

    # RG-LRU scan: recurrentgemma-2b's prefill, float32 gates
    W = 2560
    a = torch.sigmoid(torch.randn((B, S, W), generator=g, device=dev))
    b = torch.randn((B, S, W), generator=g, device=dev)
    h, h_last = rglru_scan(a, b)
    hr, lr = rglru_scan_ref(a, b)
    need(same_bits(h, hr) and same_bits(h_last, lr),
         "rglru_scan differs from the plain sequential scan")
    out["rglru_scan"] = dict(
        ms=time_ms(lambda: rglru_scan(a, b)),
        plain_ms=time_ms(lambda: rglru_scan_ref(a, b), reps=2, runs=3,
                         warmup=1),
        library_ms=None, max_abs_err=max_abs_err(h, hr),
        # a, b read, h written (float32), h_last written; a multiply and an
        # add per element
        bound=bound(a.numel() * 12 + h_last.numel() * 4, a.numel() * 2),
        tol=0.0, shape=[B, S, W], dtype="float32")
    del a, b, h, hr
    torch.cuda.empty_cache()
    return out


def _grad_check(what, got, want) -> float:
    """Hold a backward kernel's output against its plain version: float32
    max|err| <= GRAD_TOL * max(1, max|want|); bfloat16 within two bf16 ulps
    of each element (2 * 2**-7 relative) plus that limit. Returns
    max|got - want|."""
    import torch
    need(got.shape == want.shape and got.dtype == want.dtype,
         f"{what}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} "
         f"{want.dtype}")
    g, w = got.double(), want.double()
    floor = GRAD_TOL * max(1.0, float(w.abs().max()))
    err = (g - w).abs()
    lim = floor + (2 * BF16_RTOL * w.abs() if got.dtype == torch.bfloat16 else 0)
    worst = float(err.max()) if err.numel() else 0.0
    need(bool((err <= lim).all()),
         f"{what}: differs from the plain version (max err {worst}, limit "
         f"{GRAD_TOL} of max(1, max|plain|) = {floor}"
         + (", + 2 bf16 ulps)" if got.dtype == torch.bfloat16 else ")"))
    return worst


def _pairs(S: int, window: int) -> int:
    """Unmasked (q, k) pairs of a causal, optionally windowed S x S block."""
    return sum(min(i + 1, window) if window else i + 1 for i in range(S))


def _sdpa_bwd_ms(q, k, v, do, window) -> float:
    """Device time of SDPA's backward alone (both passes) on (B,S,H,hd)
    operands: the library yardstick of the flash backward."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    if window:
        pos = torch.arange(q.shape[1], device=q.device)
        band = ((pos[None, :] <= pos[:, None])
                & (pos[None, :] > pos[:, None] - window))
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band,
                                             enable_gqa=True)
    else:
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
    return time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                               retain_graph=True))


def training_kernels(dev) -> dict:
    """The flash-attention backward kernels against their plain versions at
    gemma3-1b's training shapes (bf16, and float32 on the same values
    widened), plus correctness cases: phi3-mini's head dim 96, a padded
    sequence and GQA through the full ``flash_attention_bwd``. Times of
    each pass, its plain version and SDPA's backward."""
    import torch
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     attention_dkv_ref,
                                                     attention_dq_ref,
                                                     attention_ref,
                                                     flash_attention_bwd,
                                                     flash_attention_dkv,
                                                     flash_attention_dq,
                                                     flash_attention_fwd)

    g = torch.Generator(device=dev)
    g.manual_seed(4)
    bf, f32 = torch.bfloat16, torch.float32
    B, S, H, KV, hd = TRAIN_B, TRAIN_S, 4, 1, 256        # gemma3-1b train
    q, do = (torch.randn((B, S, H, hd), generator=g, device=dev).to(bf)
             for _ in range(2))
    k, v = (torch.randn((B, S, KV, hd), generator=g, device=dev).to(bf)
            for _ in range(2))
    dkv_cases, dkv32_cases, dq_cases = {}, {}, {}
    for window in (512, 0):
        name = f"window_{window}" if window else "global"
        o, lse = flash_attention_fwd(q, k, v, True, window)
        dsum = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, lse, dsum)
        dk, dv = flash_attention_dkv(*args, True, window)
        wk, wv = attention_dkv_ref(*args, causal=True, window=window)
        err_dkv = max(_grad_check(f"dkv {name} dk", dk, wk),
                      _grad_check(f"dkv {name} dv", dv, wv))
        del dk, dv, wk, wv
        dq = flash_attention_dq(*args, True, window)
        err_dq = _grad_check(f"dq {name}", dq,
                             attention_dq_ref(*args, causal=True, window=window))
        del dq
        # float32 on the same values widened: no bf16 rounding to hide in;
        # the CUDA-core dkv kernel, timed
        a32 = tuple(t.to(f32) for t in (q, k, v, do))
        o32, lse32 = flash_attention_fwd(*a32[:3], True, window)
        ds32 = (a32[3] * o32).sum(-1).transpose(1, 2).contiguous()
        args32 = (*a32, lse32, ds32)
        f32_err_dkv = max(
            _grad_check(f"dkv {name} float32 {n}", x, y)
            for n, x, y in zip(("dk", "dv"),
                               flash_attention_dkv(*args32, True, window),
                               attention_dkv_ref(*args32, causal=True,
                                                 window=window)))
        f32_err_dq = _grad_check(
            f"dq {name} float32", flash_attention_dq(*args32, True, window),
            attention_dq_ref(*args32, causal=True, window=window))
        pairs = B * H * _pairs(S, window)
        in_bytes = (q.numel() * 2 * 2 + k.numel() * 2 * 2
                    + lse.numel() * 4 * 2)                # q, do, k, v, lse, D
        out_bytes = B * S * H * hd * 4 * 2     # dk, dv per query head, float32
        ms32 = time_ms(lambda: flash_attention_dkv(*args32, True, window))
        dkv32_cases[name] = dict(
            ms=ms32, plain_ms=time_ms(lambda: attention_dkv_ref(
                *args32, causal=True, window=window), reps=3),
            library_ms=_sdpa_bwd_ms(*a32, window), max_abs_err=f32_err_dkv,
            bound=bound((q.numel() * 2 + k.numel() * 2) * 4
                        + lse.numel() * 4 * 2 + out_bytes, pairs * hd * 8),
            tflops=pairs * hd * 8 / ms32 / 1e9, tol=GRAD_TOL,
            shape=[B, S, H, KV, hd], window=window, dtype="float32",
            kernel="CUDA cores", library="SDPA backward (both passes)")
        del a32, o32, lse32, ds32, args32
        common = dict(library_ms=_sdpa_bwd_ms(q, k, v, do, window),
                      shape=[B, S, H, KV, hd], window=window,
                      dtype="bfloat16", tol=GRAD_TOL, bf16_ulps=2,
                      library="SDPA backward (both passes)")
        ms = time_ms(lambda: flash_attention_dkv(*args, True, window))
        dkv_cases[name] = dict(
            ms=ms, plain_ms=time_ms(lambda: attention_dkv_ref(
                *args, causal=True, window=window), reps=3),
            max_abs_err=err_dkv, f32_max_abs_err=f32_err_dkv,
            # S, dP, dV, dK: four products, 8 FLOPs per pair and head dim;
            # dk, dv written per query head in float32
            bound=bound(in_bytes + out_bytes, pairs * hd * 8,
                        BF16_FLOPS_PER_S),
            tflops=pairs * hd * 8 / ms / 1e9, kernel="wgmma (tensor cores)",
            **common)
        dq_cases[name] = dict(
            ms=time_ms(lambda: flash_attention_dq(*args, True, window)),
            plain_ms=time_ms(lambda: attention_dq_ref(
                *args, causal=True, window=window), reps=3),
            max_abs_err=err_dq, f32_max_abs_err=f32_err_dq,
            # S, dP, dQ: three products, 6 FLOPs per pair and head dim
            bound=bound(in_bytes + q.numel() * 2, pairs * hd * 6,
                        BF16_FLOPS_PER_S), **common)
        del o, lse, dsum, args
    del q, k, v, do
    torch.cuda.empty_cache()

    # the tensor-core dkv pass at phi3-mini's heads (32 of 96), PHI3_S tokens
    qp, dop, kp, vp = (torch.randn((1, PHI3_S, 32, 96), generator=g,
                                   device=dev).to(bf) for _ in range(4))
    o, lse = flash_attention_fwd(qp, kp, vp, True, 0)
    dsum = (dop.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (qp, kp, vp, dop, lse, dsum)
    err = max(_grad_check(f"dkv phi3_hd96 {n}", x, y)
              for n, x, y in zip(("dk", "dv"),
                                 flash_attention_dkv(*args, True, 0),
                                 attention_dkv_ref(*args, causal=True)))
    pairs = 32 * _pairs(PHI3_S, 0)
    ms = time_ms(lambda: flash_attention_dkv(*args, True, 0))
    dkv_cases["phi3_hd96"] = dict(
        ms=ms, plain_ms=time_ms(lambda: attention_dkv_ref(*args, causal=True),
                                reps=3),
        library_ms=_sdpa_bwd_ms(qp, kp, vp, dop, 0), max_abs_err=err,
        bound=bound(qp.numel() * 8 + lse.numel() * 8 + qp.numel() * 8,
                    pairs * 96 * 8, BF16_FLOPS_PER_S),
        tflops=pairs * 96 * 8 / ms / 1e9, kernel="wgmma (tensor cores)",
        shape=[1, PHI3_S, 32, 32, 96], window=0, dtype="bfloat16", tol=GRAD_TOL,
        library="SDPA backward (both passes)")
    del qp, kp, vp, dop, o, lse, dsum, args
    torch.cuda.empty_cache()

    # the whole backward (padding, both passes, the group sums) on more
    # shapes: phi3-mini's head dim 96, a padded sequence, GQA and a window
    extra = {}
    for name, (Bx, Sx, Hx, KVx, hdx, win, dt) in {
            "phi3_hd96": (2, 256, 32, 32, 96, 0, bf),
            "phi3_hd96_f32": (1, 128, 32, 32, 96, 0, f32),
            "padded": (1, 200, 4, 1, 256, 0, bf),
            "gqa_window": (2, 320, 8, 2, 128, 100, f32)}.items():
        qx, dox = (torch.randn((Bx, Sx, Hx, hdx), generator=g, device=dev).to(dt)
                   for _ in range(2))
        kx, vx = (torch.randn((Bx, Sx, KVx, hdx), generator=g, device=dev).to(dt)
                  for _ in range(2))
        ox, lsex = flash_attention_fwd(qx, kx, vx, True, win)
        _att_check(f"flash forward {name}", ox,
                   attention_ref(qx, kx, vx, causal=True, window=win)[0])
        got = flash_attention_bwd(qx, kx, vx, ox, lsex, dox, True, win)
        want = attention_bwd_ref(qx, kx, vx, ox, lsex, dox, causal=True,
                                 window=win)
        extra[name] = max(_grad_check(f"backward {name} {n}", a, b)
                          for n, a, b in zip(("dq", "dk", "dv"), got, want))
    return {"flash_attention_dkv_wgmma": dict(
                dkv_cases["global"], cases=dkv_cases, checks=extra),
            "flash_attention_dkv_cudacore": dict(
                dkv32_cases["global"], cases=dkv32_cases, checks=extra),
            "flash_attention_dq": dict(dq_cases["global"], cases=dq_cases,
                                       checks=extra)}


def sm_clock_mhz() -> float:
    """The card's maximum SM clock, as nvidia-smi reports it."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=30)
    try:
        return float(res.stdout.strip().splitlines()[0])
    except (IndexError, ValueError):
        raise PhaseError(f"nvidia-smi gave no SM clock: {res.stdout!r} "
                         f"{res.stderr!r}") from None


def scan_kernel(dev) -> dict:
    """The selective scan against its plain version at falcon-mamba-7b's
    prefill shape (bf16, and float32 on the same values widened)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_ref

    g = torch.Generator(device=dev)
    g.manual_seed(5)
    B, S, DI, N = SERVE_B, PROMPT, 8192, 16
    u = torch.randn((B, S, DI), generator=g, device=dev).to(torch.bfloat16)
    dt = F.softplus(torch.randn((B, S, DI), generator=g, device=dev) - 2.0
                    ).to(torch.bfloat16)
    # the model's A = -exp(A_log) = -(1..N) and D = 1; B, C in the model dtype
    A = -torch.arange(1, N + 1, dtype=torch.float32, device=dev).expand(DI, N)
    A = A.contiguous()
    D = torch.ones(DI, device=dev)
    Bm, Cm = (torch.randn((B, S, N), generator=g, device=dev).to(torch.bfloat16)
              for _ in range(2))
    args = (u, dt, A, Bm, Cm, D)
    y, h = ssm_scan(*args)
    yr, hr = ssm_scan_ref(*args)
    err = max_abs_err(y, yr)
    need(torch.allclose(y.float(), yr.float(), atol=SCAN_TOL, rtol=BF16_RTOL),
         f"ssm_scan bf16 y: max err {err} (one ulp + {SCAN_TOL})")
    h_err = max_abs_err(h, hr)
    need(h_err <= SCAN_TOL * max(1.0, float(hr.abs().max())),
         f"ssm_scan h_last: max err {h_err}")
    a32 = tuple(t.float() for t in args)
    y32, h32 = ssm_scan(*a32)
    yr32, hr32 = ssm_scan_ref(*a32)
    f32_err = max(max_abs_err(y32, yr32), max_abs_err(h32, hr32))
    need(f32_err <= SCAN_TOL, f"ssm_scan float32: max err {f32_err}")
    del a32, y32, h32, yr32, hr32, yr, hr
    clock = sm_clock_mhz()
    exps = B * S * DI * N
    nbytes = (u.numel() * 2 * 3 + (Bm.numel() + Cm.numel()) * 4
              + (A.numel() + D.numel() + h.numel()) * 4)  # u, dt, y; B, C f32
    out = {"ssm_scan": dict(
        ms=time_ms(lambda: ssm_scan(*args)),
        plain_ms=time_ms(lambda: ssm_scan_ref(*args), reps=2, runs=3,
                         warmup=1),
        library_ms=None, max_abs_err=err, h_last_max_abs_err=h_err,
        f32_max_abs_err=f32_err,
        # exponentials over the special-function units at the card's clock
        bound=bound(nbytes, exps, H100_SMS * SFU_PER_SM_CLOCK * clock * 1e6),
        sm_clock_mhz=clock, tol=SCAN_TOL, bf16_rtol=BF16_RTOL,
        shape=[B, S, DI, N], dtype="bfloat16")}
    del u, dt, Bm, Cm, y, h, args
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase: delta
# ---------------------------------------------------------------------------

def _perturb(state, tracker, frac, rng):
    """Flip one bit in a random ``frac`` of the fingerprint-tracked blocks;
    returns {leaf name: sorted block ids}."""
    import torch
    from repro_torch.checkpoint import serialize as ser
    from repro_torch.kernels.fingerprint import n_blocks_of
    named = ser.flatten_state(state)
    blocks = []
    for n, t in named.items():
        if tracker._codec_for(n, t) is not None:
            blocks += [(n, b) for b in range(
                n_blocks_of(t.numel() * t.element_size(), CHUNK))]
    k = max(1, round(frac * len(blocks)))
    chosen: dict[str, list[int]] = {}
    for i in rng.choice(len(blocks), k, replace=False):
        n, b = blocks[int(i)]
        chosen.setdefault(n, []).append(b)
    view = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    for n, bs in chosen.items():
        t = named[n]
        iv = t.view(-1).view(view[t.element_size()])
        idx = torch.tensor([b * (CHUNK // t.element_size()) for b in bs],
                           device=t.device)
        iv[idx] = iv[idx] ^ 1
        bs.sort()
    return chosen, len(blocks)


def _expected_d2h(state, tracker, chosen) -> int:
    from repro_torch.checkpoint import serialize as ser
    from repro_torch.kernels.fingerprint import n_blocks_of
    total = 0
    for n, t in ser.flatten_state(state).items():
        nbytes = t.numel() * t.element_size()
        if tracker._codec_for(n, t) is None:
            total += nbytes
            continue
        nb = n_blocks_of(nbytes, CHUNK)
        k = len(chosen.get(n, ()))
        k_pad = min(1 << (k - 1).bit_length() if k > 1 else 1, nb) if k else 0
        total += nb + k_pad * CHUNK
    return total


def phase_delta(cfg, dev, workdir) -> dict:
    import numpy as np
    import torch
    from repro_torch.checkpoint import (CheckpointStore, DeviceDeltaTracker,
                                        extract_snapshot, prestage)
    from repro_torch.checkpoint import serialize as ser
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_train_state, state_template_on_device

    state = init_train_state(cfg, AdamWConfig(), seed=0, device=dev)
    state_bytes = sum(t.numel() * t.element_size()
                      for t in ser.flatten_state(state).values())
    store = CheckpointStore(str(workdir / "delta"), retention=2)
    tracker = DeviceDeltaTracker(store.pool, chunk_size=store.chunk_size,
                                 compress=store.compress)
    rng = np.random.default_rng(0)
    # the first save is a full one: every byte crosses to the host, is
    # hashed and written; timed in its two halves
    t0 = time.perf_counter()
    snap = extract_snapshot(prestage(state, tracker), step=0, tracker=tracker)
    t1 = time.perf_counter()
    info = store.save_snapshot(snap)
    res = {"state_bytes": state_bytes, "first_save_d2h": snap.d2h_bytes,
           "first_save_extract_s": t1 - t0,
           "first_save_write_s": time.perf_counter() - t1,
           "first_save_new_bytes": info.new_bytes}
    for step, frac in ((1, 0.01), (2, 0.05)):
        chosen, n_tracked = _perturb(state, tracker, frac, rng)
        t0 = time.perf_counter()
        snap = extract_snapshot(prestage(state, tracker), step=step,
                                tracker=tracker)
        stall = time.perf_counter() - t0
        from repro_torch.checkpoint.device_delta import DeltaBlocks
        seen = {n: list(lp.pieces[0][1].dirty_ids)
                for n, lp in snap.leaves.items()
                if isinstance(lp.pieces[0][1], DeltaBlocks)
                and lp.pieces[0][1].dirty_ids}
        need(seen == chosen, f"{frac:.0%} churn: dirty blocks differ from "
                             "the perturbed ones")
        want = _expected_d2h(state, tracker, chosen)
        need(snap.d2h_bytes == want,
             f"{frac:.0%} churn: d2h_bytes {snap.d2h_bytes} != expected {want}")
        t1 = time.perf_counter()
        info = store.save_snapshot(snap)
        res[f"churn_{frac:.2f}"] = {
            "dirty_blocks": sum(map(len, chosen.values())),
            "tracked_blocks": n_tracked, "d2h_bytes": snap.d2h_bytes,
            "d2h_frac": snap.d2h_bytes / state_bytes,
            "extract_stall_s": stall, "write_s": time.perf_counter() - t1,
            "new_bytes": info.new_bytes}
    need(res["churn_0.05"]["d2h_frac"] <= 0.35,
         f"5% churn moved {res['churn_0.05']['d2h_frac']:.1%} of the state")
    t0 = time.perf_counter()
    restored, man = store.restore(state_template_on_device(state, dev),
                                  streaming=True)
    res["restore_s"] = time.perf_counter() - t0
    need(man.step == 2, "restore did not pick the newest step")
    for n, t in ser.flatten_state(state).items():
        need(same_bits(t, ser.flatten_state(restored)[n]),
             f"delta restore differs at {n}")
    del state, restored
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase: spot loops
# ---------------------------------------------------------------------------

def run_loop(cfg, dev, root, *, mode, evict_s, steps, quantize_moments=False,
             seq_len=64):
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.core import (AZURE_D8S_V3, CheckpointPolicy,
                                  CostAccountant, NoEviction, PeriodicEviction,
                                  ScaleSet, SpotOnCoordinator, TimeModel,
                                  VirtualClock)
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import SpotTrainer, TrainJob

    class RecordingCoordinator(SpotOnCoordinator):
        """Keeps the state handed to each urgent save and the last restore
        (the step is functional, so a held state stays unchanged)."""
        urgent_state = None
        restored = None

        def _save_termination(self, step, state, deadline):
            self.urgent_state = state
            return super()._save_termination(step, state, deadline)

        def restore_latest(self, template, **kw):
            self.restored = super().restore_latest(template, **kw)
            return self.restored

    clock = VirtualClock()
    sched = PeriodicEviction(evict_s) if evict_s else NoEviction()
    pool = ScaleSet(clock=clock, schedule=sched,
                    accountant=CostAccountant(AZURE_D8S_V3),
                    provisioning_delay_s=10.0, notice_s=30.0)
    store = CheckpointStore(str(root), time_fn=clock.now, retention=2,
                            quantize_moments=quantize_moments)
    policy = (CheckpointPolicy.transparent(30.0) if mode == "transparent"
              else CheckpointPolicy.off())
    coord = RecordingCoordinator(store, policy, clock, time_model=TimeModel())
    job = TrainJob(cfg=cfg, opt=AdamWConfig(total_steps=steps, warmup_steps=2),
                   total_steps=steps, n_stages=2, batch=2, seq_len=seq_len)
    trainer = SpotTrainer(job, coord, pool, clock, step_time_s=10.0,
                          max_sessions=10, device=dev)
    t0 = time.perf_counter()
    rep = trainer.run()
    coord.close()
    return rep, coord, time.perf_counter() - t0


def _loop_summary(rep, wall_s) -> dict:
    c = rep.coordinator
    return {"completed": rep.completed, "final_loss": rep.final_loss,
            "evictions_seen": rep.evictions_seen, "restores": rep.restores,
            "lost_steps": rep.lost_steps, "steps_executed": rep.steps_executed,
            "periodic_ckpts": c["periodic_ckpts"],
            "termination_ckpts": c["termination_ckpts"],
            "d2h_bytes": c["d2h_bytes"], "save_stall_s": c["save_stall_s"],
            "mttr_mean_s": c["mttr_mean_s"], "wall_s": wall_s}


def _need_variant(counted: dict, what: str, variant: str) -> None:
    """Every flash forward and dkv launch of a run went through ``variant``:
    "wgmma" (bfloat16, the tensor cores) or "cudacore" (float32)."""
    for p in ("fwd", "dkv"):
        k = f"flash_attention_{p}"
        need(counted[f"{k}_{variant}"] == counted[k],
             f"{what}: {counted[f'{k}_{variant}']} of {counted[k]} {k} "
             f"launches went through the {variant} kernel")


def phase_spot_loop(cfg, dev, workdir, steps, launches, *, name="spot_loop",
                    seq_len=64) -> dict:
    import torch
    from repro_torch.kernels import _lib
    base, _c, base_wall = run_loop(cfg, dev, workdir / "base", mode="off",
                                   evict_s=None, steps=steps, seq_len=seq_len)
    shutil.rmtree(workdir / "base", ignore_errors=True)
    _lib.reset_launches()
    ev, _c, ev_wall = run_loop(cfg, dev, workdir / "ev", mode="transparent",
                               evict_s=55.0, steps=steps, seq_len=seq_len)
    launches[name] = dict(_lib.LAUNCHES)
    shutil.rmtree(workdir / "ev", ignore_errors=True)
    res = {"uninterrupted": _loop_summary(base, base_wall),
           "evicted": _loop_summary(ev, ev_wall)}
    need(base.completed and ev.completed, "a spot loop did not complete")
    need(ev.evictions_seen >= 1 and ev.restores >= 1,
         "the evicted run saw no eviction or no restore")
    need(ev.lost_steps == 0, f"the evicted run lost {ev.lost_steps} steps")
    need(math.isfinite(base.final_loss), "non-finite loss")
    need(ev.final_loss == base.final_loss,
         f"final loss {ev.final_loss!r} != uninterrupted {base.final_loss!r}")
    need(launches[name]["fingerprint"] > 0,
         "periodic delta saves launched no fingerprint kernel")
    for k in ("flash_attention_fwd", "flash_attention_dkv",
              "flash_attention_dq"):
        need(launches[name][k] > 0, f"the train steps launched no {k} kernel")
    _need_variant(launches[name], name, "wgmma")
    res["config"] = {"name": cfg.name, "n_layers": cfg.n_layers,
                     "d_model": cfg.d_model, "head_dim": cfg.head_dim,
                     "batch": 2, "seq_len": seq_len}
    res["launches"] = launches[name]
    torch.cuda.empty_cache()
    return res


def phase_spot_loop_int8(cfg, dev, workdir, steps, launches) -> dict:
    import numpy as np
    import torch
    from repro_torch.checkpoint import serialize as ser
    from repro_torch.kernels import _lib
    _lib.reset_launches()
    rep, coord, wall = run_loop(cfg, dev, workdir / "q", mode="transparent",
                                evict_s=55.0, steps=steps,
                                quantize_moments=True)
    launches["spot_loop_int8"] = dict(_lib.LAUNCHES)
    shutil.rmtree(workdir / "q", ignore_errors=True)
    res = _loop_summary(rep, wall)
    need(rep.completed and rep.evictions_seen >= 1 and rep.restores >= 1,
         "the int8 loop did not complete through an eviction and a restore")
    need(rep.lost_steps == 0, f"the int8 loop lost {rep.lost_steps} steps")
    need(math.isfinite(rep.final_loss), "non-finite loss in the int8 loop")
    for k in ("absmax", "quantize", "dequantize", "fingerprint"):
        need(launches["spot_loop_int8"][k] > 0,
             f"the int8 loop launched no {k} kernel")
    # the replacement restored the termination checkpoint: its moments must
    # equal the host dequantize of the host quantize of the saved moments
    need(coord.urgent_state is not None and coord.restored is not None,
         "no urgent save or no restore recorded")
    state, man = coord.restored
    need(man.kind == "termination", f"restored a {man.kind} checkpoint")
    saved = ser.flatten_state(coord.urgent_state)
    got = ser.flatten_state(state)
    n_mom = 0
    for n, t in saved.items():
        if not ser.is_moment_name(n) or t.ndim < 1:
            continue
        q, scale = ser.quantize(ser.to_host(t), "int8", ser.dtype_to_name(t.dtype))
        want = ser.finish_payload(q, dtype_name=ser.dtype_to_name(t.dtype),
                                  quant="int8", scale=scale)
        need(np.array_equal(want.view(np.uint8),
                            ser.to_host(got[n]).view(np.uint8)),
             f"restored moment {n} differs from the host dequantize")
        n_mom += 1
    need(n_mom > 0, "no moments compared")
    res["moments_compared"] = n_mom
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase: training gemma3-1b
# ---------------------------------------------------------------------------

def phase_train_gemma3(dev, card, launches) -> dict:
    """make_train_step on gemma3-1b at its full published config; then one
    float32 one-period copy's loss and gradients on the card against the
    same step on the host (the port's plain versions)."""
    import torch
    from repro_torch.checkpoint import serialize as ser
    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (init_train_state, loss_and_grads,
                                   make_train_step)

    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("gemma3_1b")
    n_attn = sum(k in ("global", "local") for k in cfg.layer_kinds())
    opt = AdamWConfig(total_steps=TRAIN_STEPS, warmup_steps=2)
    state = init_train_state(cfg, opt, seed=0, device=dev)
    step = make_train_step(cfg, opt)
    g = torch.Generator(device=dev)
    g.manual_seed(3)

    def batch():
        tok = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1),
                            generator=g, device=dev, dtype=torch.int32)
        return {"inputs": tok[:, :-1], "labels": tok[:, 1:]}
    step(state, batch())        # warm-up (cuBLAS handles), outside the count
    torch.cuda.synchronize()

    # the main path: counts reset just before, read just after
    _lib.reset_launches()
    step_s, losses = [], []
    for _ in range(TRAIN_STEPS):
        b = batch()
        t0 = time.perf_counter()
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))          # synchronises
        step_s.append(time.perf_counter() - t0)
    launches["train_gemma3"] = counted = dict(_lib.LAUNCHES)
    for k in ("flash_attention_fwd", "flash_attention_dkv",
              "flash_attention_dq"):
        need(counted[k] == n_attn * TRAIN_STEPS,
             f"train_gemma3: {counted[k]} {k} launches, expected "
             f"{n_attn} per step")
    _need_variant(counted, "train_gemma3", "wgmma")
    need(all(math.isfinite(x) for x in losses), "train_gemma3: non-finite loss")
    med = statistics.median(step_s)
    res = {"card": card,
           "config": {"name": cfg.name, "n_layers": cfg.n_layers,
                      "d_model": cfg.d_model, "vocab_size": cfg.vocab_size,
                      "window": cfg.window, "dtype": cfg.dtype,
                      "params": cfg.param_count()},
           "batch": TRAIN_B, "seq_len": TRAIN_S, "steps": TRAIN_STEPS,
           "step_s": step_s, "median_step_s": med,
           "tokens_per_s": TRAIN_B * TRAIN_S / med, "losses": losses,
           "launches": counted,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    b = batch()
    res["step_profile"] = _profile(lambda: step(state, b), 1)
    del state, b
    torch.cuda.empty_cache()

    # model-level check: the same float32 step on the card and on the host
    cfg32 = cfg.scaled(n_layers=len(cfg.block_pattern), dtype="float32")
    params = init_params(cfg32, seed=1, device=dev)
    tok = torch.randint(0, cfg.vocab_size, (1, LOOP_S + 1), generator=g,
                        device=dev, dtype=torch.int32)
    # the float32 path: its own counts, through the CUDA-core kernels
    _lib.reset_launches()
    t0 = time.perf_counter()
    loss_d, _, grads_d = loss_and_grads(cfg32, params, tok[:, :-1], tok[:, 1:])
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches["train_gemma3_f32"] = c32 = dict(_lib.LAUNCHES)
    n_attn32 = sum(k in ("global", "local") for k in cfg32.layer_kinds())
    for k in ("flash_attention_fwd_cudacore", "flash_attention_dkv_cudacore"):
        need(c32[k] == n_attn32, f"train_gemma3 float32: {c32[k]} {k} "
                                 f"launches, expected {n_attn32}")
    _need_variant(c32, "train_gemma3 float32", "cudacore")
    params_h = ser.unflatten_like(params, {
        n: t.cpu() for n, t in ser.flatten_state(params).items()})
    del params
    torch.cuda.empty_cache()
    tok_h = tok.cpu()
    t0 = time.perf_counter()
    loss_h, _, grads_h = loss_and_grads(cfg32, params_h, tok_h[:, :-1],
                                        tok_h[:, 1:])
    host_s = time.perf_counter() - t0
    loss_rel = abs(float(loss_d) - float(loss_h)) / abs(float(loss_h))
    need(loss_rel <= MODEL_LOSS_TOL,
         f"train_gemma3: card loss {float(loss_d)} vs host {float(loss_h)}")
    worst, worst_leaf = 0.0, None
    gh = ser.flatten_state(grads_h)
    for n, gd in ser.flatten_state(grads_d).items():
        scale = max(float(gh[n].abs().max()), 1e-30)
        rel = float((gd.cpu() - gh[n]).abs().max()) / scale
        if rel > worst:
            worst, worst_leaf = rel, n
    need(worst <= MODEL_GRAD_TOL,
         f"train_gemma3: gradient {worst_leaf} differs card vs host by "
         f"{worst} of its largest element")
    res["model_check"] = {
        "config": {"n_layers": cfg32.n_layers, "dtype": "float32",
                   "batch": 1, "seq_len": LOOP_S},
        "loss_card": float(loss_d), "loss_host": float(loss_h),
        "loss_rel_err": loss_rel, "loss_tol": MODEL_LOSS_TOL,
        "max_leaf_rel_err": worst, "worst_leaf": worst_leaf,
        "leaf_tol": MODEL_GRAD_TOL, "leaves": len(gh),
        "card_s": card_s, "host_s": host_s}
    del grads_d, grads_h, params_h
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase: serving
# ---------------------------------------------------------------------------

def _decode_run(params, cfg, prefill_fn, step_fn, prompt, *, keep_at=None,
                keep_logits=False):
    """Prefill, then NEW - 1 greedy decode steps, each synchronised and
    timed. Returns (tokens (B, NEW), prefill s, decode s, the serving state
    after ``keep_at`` new tokens, every step's logits)."""
    import torch
    t0 = time.perf_counter()
    tok, caches, pos = prefill_fn(params, prompt)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    out, logits_all, kept, decode_s = [tok], [], None, 0.0
    for i in range(NEW - 1):
        if keep_at is not None and len(out) == keep_at:
            kept = {"caches": caches, "cursor": pos + i,
                    "generated": torch.stack(out, dim=1)}
        t0 = time.perf_counter()
        tok, logits, caches = step_fn(params, out[-1][:, None], caches, pos + i)
        torch.cuda.synchronize()
        decode_s += time.perf_counter() - t0
        out.append(tok)
        if keep_logits:
            logits_all.append(logits)
    return torch.stack(out, dim=1), prefill_s, decode_s, kept, logits_all


def _profile(fn, n: int) -> dict:
    """``n`` synchronised calls of ``fn`` under torch.profiler: wall time,
    device busy time (the sum of kernel self times) and the kernels and
    host operations that take the most, per call, in ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    # kernels, copies and fills run on the device; host operations carry
    # their kernels' time too, so only device events are summed
    on_dev = [e for e in ev if e.device_type == DeviceType.CUDA]
    busy = sum(dev_us(e) for e in on_dev) / 1e3 / n
    top_dev = sorted(on_dev, key=dev_us, reverse=True)[:8]
    top_host = sorted((e for e in ev if e.device_type == DeviceType.CPU),
                      key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    return {"calls": n, "wall_ms": wall * 1e3 / n,
            "device_busy_ms": busy if busy > 0 else "not measured",
            "device_busy_share": busy / (wall * 1e3 / n) if busy > 0 else None,
            "top_device_ms": [[e.key[:80], dev_us(e) / 1e3 / n] for e in top_dev],
            "top_host_ms": [[e.key[:80], e.self_cpu_time_total / 1e3 / n]
                            for e in top_host]}


def phase_serve(arch, dev, workdir, card, launches) -> dict:
    import torch
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.checkpoint import serialize as ser
    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.models import forward, init_params
    from repro_torch.models.transformer import unembed_weights
    from repro_torch.serve import generate, make_decode_step, make_prefill
    from repro_torch.train import state_template_on_device

    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch)
    kinds = cfg.layer_kinds()
    n_attn = sum(k in ("global", "local") for k in kinds)
    n_rec = sum(k == "rglru" for k in kinds)
    n_mamba = sum(k == "mamba" for k in kinds)
    params = init_params(cfg, seed=0, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (SERVE_B, PROMPT), generator=g,
                           device=dev, dtype=torch.int32)
    prefill_fn = make_prefill(cfg, cache_len=CACHE_LEN, device=dev)
    step_fn = make_decode_step(cfg, device=dev)
    # warm-up (cuBLAS handles and heuristics), outside the counted run
    tok, caches, pos = prefill_fn(params, prompt[:, :64])
    step_fn(params, tok[:, None], caches, pos)
    torch.cuda.synchronize()
    del caches

    # the main path: counts reset just before, read just after
    _lib.reset_launches()
    tokens, prefill_s, decode_s, mid, _ = _decode_run(
        params, cfg, prefill_fn, step_fn, prompt, keep_at=SAVE_AT)
    launches[f"serve_{arch}"] = counted = dict(_lib.LAUNCHES)
    res = {"card": card, "config": {"name": cfg.name, "n_layers": cfg.n_layers,
                                    "d_model": cfg.d_model,
                                    "vocab_size": cfg.vocab_size,
                                    "window": cfg.window, "dtype": cfg.dtype},
           "batch": SERVE_B, "prompt": PROMPT, "new_tokens": NEW,
           "cache_len": CACHE_LEN, "prefill_s": prefill_s,
           "prefill_tokens_per_s": SERVE_B * PROMPT / prefill_s,
           "decode_s": decode_s,
           "decode_tokens_per_s": SERVE_B * (NEW - 1) / decode_s,
           "launches": counted,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    want = {"flash_attention_fwd": n_attn, "rglru_scan": n_rec,
            "ssm_scan": n_mamba, "decode_attention": n_attn * (NEW - 1)}
    for name, n in want.items():
        need(counted[name] == n,
             f"{arch}: {counted[name]} {name} launches, expected {n}")
    _need_variant(counted, arch, "wgmma")
    need(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
         f"{arch}: tokens out of range")
    gen = generate(params, cfg, prompt, NEW, cache_len=CACHE_LEN, device=dev)
    need(torch.equal(gen, tokens), f"{arch}: serve.generate disagrees with "
                                   "make_prefill / make_decode_step")
    # where the time goes: one prefill, and four decode steps from the
    # mid-generation state
    res["prefill_profile"] = _profile(lambda: prefill_fn(params, prompt), 1)
    res["decode_profile"] = _profile(
        lambda: step_fn(params, mid["generated"][:, -1:], mid["caches"],
                        mid["cursor"]), 4)

    # mid-generation checkpoint: save the serving state at token SAVE_AT,
    # restore it onto the card into a fresh template, decode to the end
    store = CheckpointStore(str(workdir / f"serve_{arch}"))
    t0 = time.perf_counter()
    info = store.save(SAVE_AT, mid, kind="transparent")
    res["save_s"] = time.perf_counter() - t0
    res["save_bytes"] = sum(t.numel() * t.element_size()
                            for t in ser.flatten_state(mid).values()
                            if isinstance(t, torch.Tensor))
    res["cache_bytes"] = sum(t.numel() * t.element_size()
                             for t in ser.flatten_state(mid["caches"]).values())
    res["save_new_bytes"] = info.new_bytes
    template = state_template_on_device(mid, dev)
    del mid
    t0 = time.perf_counter()
    state, man = store.restore(template, streaming=True)
    torch.cuda.synchronize()
    res["restore_s"] = time.perf_counter() - t0
    need(man.step == SAVE_AT, "restored the wrong step")
    out = list(state["generated"].unbind(1))
    caches, cursor = state["caches"], state["cursor"]
    for i in range(NEW - len(out)):
        tok, _, caches = step_fn(params, out[-1][:, None], caches, cursor + i)
        out.append(tok)
    resumed = torch.stack(out, dim=1)
    need(torch.equal(resumed, tokens),
         f"{arch}: tokens after the mid-generation restore differ "
         f"({int((resumed != tokens).sum())} of {tokens.numel()})")
    res["resumed_tokens_identical"] = True
    del state, caches, gen

    # decode against teacher forcing, on a float32 copy at the same shapes:
    # the bf16 weights leave the card before their float32 copy lands
    cfg32 = cfg.scaled(dtype="float32")
    host = {n: t.cpu() for n, t in ser.flatten_state(params).items()}
    template = state_template_on_device(params, dev)
    del params
    torch.cuda.empty_cache()
    params32 = ser.unflatten_like(template, {
        n: t.to(dev).to(torch.float32) for n, t in host.items()})
    del host, template
    # the float32 serving path: its own counts, through the CUDA-core forward
    _lib.reset_launches()
    tok32, _, _, _, logits32 = _decode_run(
        params32, cfg32, make_prefill(cfg32, cache_len=CACHE_LEN, device=dev),
        make_decode_step(cfg32, device=dev), prompt, keep_logits=True)
    launches[f"serve_{arch}_f32"] = c32 = dict(_lib.LAUNCHES)
    need(c32["flash_attention_fwd_cudacore"] == n_attn,
         f"{arch} float32: {c32['flash_attention_fwd_cudacore']} CUDA-core "
         f"forward launches, expected {n_attn}")
    _need_variant(c32, f"{arch} float32", "cudacore")
    with torch.no_grad():
        seq = torch.cat([prompt, tok32[:, :-1]], dim=1)     # (B, PROMPT+NEW-1)
        hidden, _ = forward(params32, cfg32, seq, return_hidden=True)
        tf = hidden[:, PROMPT - 1:] @ unembed_weights(params32, cfg32)
    errs = [max_abs_err(lg, tf[:, i + 1]) for i, lg in enumerate(logits32)]
    tf_tokens = torch.argmax(tf, dim=-1).to(torch.int32)
    top2 = torch.topk(tf, 2, dim=-1).values
    res["teacher_forcing"] = {
        "max_abs_err": max(errs), "tol": LOGIT_TOL,
        "tokens_identical": bool(torch.equal(tf_tokens, tok32)),
        "min_top2_gap": float((top2[..., 0] - top2[..., 1]).min())}
    need(max(errs) <= LOGIT_TOL,
         f"{arch}: float32 decode logits differ from teacher forcing by "
         f"{max(errs)}")
    need(res["teacher_forcing"]["tokens_identical"],
         f"{arch}: float32 greedy tokens differ from teacher forcing")
    del params32, hidden, tf, logits32
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------

def ptxas_summary(report: dict) -> dict:
    """``ptxas -v``'s registers and spill bytes per kernel instance, under
    short names: kernel<dtype,template ints>."""
    out = {}
    for mangled, info in report.items():
        # the kernel's name follows its length (the tail of a digit run),
        # and its template arguments open with "I"; the shortest such name
        names = []
        for m in re.finditer(r"\d+(?=[A-Za-z_])", mangled):
            for i in range(len(m.group())):
                n = int(m.group()[i:])
                name = mangled[m.end():m.end() + n]
                if name.endswith("_kernel") and \
                        mangled[m.end() + n:m.end() + n + 1] == "I":
                    names.append(name)
        if not names:
            continue
        names.sort(key=len)
        dtype = "bf16" if "__nv_bfloat16" in mangled or "wgmma" in names[0] \
            else "f16" if "6__half" in mangled else "f32"
        ints = re.findall(r"Li(\d+)E", mangled)
        out[f"{names[0]}<{','.join([dtype, *ints])}>"] = info
    return out


KERNELS = {
    "fingerprint": ("src/repro_torch/kernels/csrc/fingerprint.cu",
                    "src/repro/kernels/fingerprint/fingerprint.py:30"),
    "absmax": ("src/repro_torch/kernels/csrc/quantize.cu",
               "src/repro/kernels/quantize/quantize.py:38"),
    "quantize": ("src/repro_torch/kernels/csrc/quantize.cu",
                 "src/repro/kernels/quantize/quantize.py:53"),
    "dequantize": ("src/repro_torch/kernels/csrc/quantize.cu",
                   "src/repro/kernels/quantize/quantize.py:62"),
    # rows 5 and 6 have two variants, chosen by dtype: bfloat16 on the
    # tensor cores (wgmma), float32 on the CUDA cores
    "flash_attention_fwd_wgmma": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:65"),
    "flash_attention_fwd_cudacore": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:65"),
    "flash_attention_dkv_wgmma": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:156"),
    "flash_attention_dkv_cudacore": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:156"),
    "flash_attention_dq": ("src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                           "src/repro/kernels/flash_attention/flash_attention.py:201"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention/decode_attention.py:30"),
    "ssm_scan": ("src/repro_torch/kernels/csrc/ssm_scan.cu",
                 "src/repro/kernels/ssm_scan/ssm_scan.py:36"),
    "rglru_scan": ("src/repro_torch/kernels/csrc/rglru_scan.cu",
                   "src/repro/kernels/rglru_scan/rglru_scan.py:31"),
}


def main() -> int:

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 2
    try:
        from repro_torch.configs import get_config
        from repro_torch.device import set_deterministic
        from repro_torch.kernels import _lib
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing: {e}",
              file=sys.stderr)
        return 2
    set_deterministic()
    dev = torch.device("cuda", 0)
    card = nvidia_smi()
    print(card, flush=True)          # name, power limit: nvidia-smi's own line
    _lib.library()
    print(f"kernel build+load: {_lib.build_seconds():.1f} s", flush=True)
    ptxas = ptxas_summary(_lib.ptxas_report())
    lib = _lib.library()
    # the tensor-core kernels' dynamic shared memory, beside ptxas's counts
    wgmma_smem = {f"{p}_hd{hd}": getattr(lib, f"spot_flash_attention_{p}_wgmma_smem")(hd)
                  for p in ("fwd", "dkv") for hd in _lib.HEAD_DIMS}
    print(json.dumps({"ptxas": ptxas, "wgmma_dynamic_smem": wgmma_smem}),
          flush=True)
    cfg = get_config("phi3_mini_3p8b").scaled(n_layers=LAYERS)
    launches: dict[str, dict] = {}
    results: dict = {"card": card, "build_s": _lib.build_seconds(),
                     "ptxas": ptxas, "wgmma_dynamic_smem": wgmma_smem,
                     "config": {"name": cfg.name, "n_layers": cfg.n_layers,
                                "d_model": cfg.d_model}}
    (ROOT / "build").mkdir(exist_ok=True)
    failed = []
    with tempfile.TemporaryDirectory(dir=ROOT / "build",
                                     prefix="chip_smoke_") as tmp:
        workdir = Path(tmp)
        phases = {
            "kernels": lambda: phase_kernels(cfg, dev),
            "delta": lambda: phase_delta(cfg, dev, workdir),
            "spot_loop": lambda: phase_spot_loop(cfg, dev, workdir, STEPS,
                                                 launches),
            "spot_loop_int8": lambda: phase_spot_loop_int8(
                cfg, dev, workdir, STEPS, launches),
            "train_gemma3": lambda: phase_train_gemma3(dev, card, launches),
            "spot_loop_gemma3": lambda: phase_spot_loop(
                get_config("gemma3_1b").scaled(n_layers=LOOP_LAYERS), dev,
                workdir / "gemma3", STEPS, launches, name="spot_loop_gemma3",
                seq_len=LOOP_S),
            "serve_gemma3": lambda: phase_serve("gemma3_1b", dev, workdir,
                                                card, launches),
            "serve_recurrentgemma": lambda: phase_serve(
                "recurrentgemma_2b", dev, workdir, card, launches),
            "serve_falcon_mamba": lambda: phase_serve(
                "falcon_mamba_7b", dev, workdir, card, launches),
        }
        for phase, run in phases.items():
            t0 = time.perf_counter()
            try:
                results[phase] = run()
                torch.cuda.synchronize()
                status = "ok"
            except Exception as e:          # report every phase, then fail
                import traceback
                traceback.print_exc()
                failed.append(phase)
                status = f"FAILED: {e}"
            print(f"phase {phase}: {status} ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
            if phase in results:
                print(json.dumps({"phase": phase, "results": results[phase],
                                  "card": card}, default=float), flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(
        json.dumps({"results": results, "launches": launches,
                    "failed": failed}, indent=1, default=float))
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    rows = []
    for name, (src, replaces) in KERNELS.items():
        k = results["kernels"][name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": sum(v[name] for v in launches.values()),
                     "launches_by_phase": {p: v[name]
                                           for p, v in launches.items()},
                     "max_abs_err": k["max_abs_err"],
                     "tol": k.get("tol", 0.0),     # 0: held bit for bit
                     # "ms" is the chip-check line's key, "kernel_ms" the
                     # name the port's notes use; one measurement
                     "ms": k["ms"], "kernel_ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound"][0],
                     "bound_by": k["bound"][1], "library_ms": k["library_ms"],
                     "shape": k["shape"], "dtype": k["dtype"],
                     "tflops": k.get("tflops"), "kernel": k.get("kernel"),
                     "cases": k.get("cases"), "card": card})
        if rows[-1]["launches"] <= 0:
            print(f"chip_smoke: {name} never launched on the main path",
                  file=sys.stderr)
            return 1
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
