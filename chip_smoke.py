#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU.

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, holds
each against its plain PyTorch version at the main path's shapes (the
checkpoint kernels and the RG-LRU scan bit for bit, the attention kernels
and the selective scan in float32 and bfloat16 within stated tolerances)
and times both, then drives the Spot-on loop through the entry points a
user calls, at phi3-mini's published width cut to a few layers and at
gemma3-1b's cut to one period, trains gemma3-1b at its full published
config, serves gemma3-1b, recurrentgemma-2b, phi3-mini, falcon-mamba-7b,
deepseek-moe-16b, minitron-8b and musicgen-medium at their full published
configs, and runs the spot loops on deepseek-moe-16b's width, all with
seeded weights:

  kernels         the chunk digest (an urgent save's SHA-1 addresses and
                  CRC-32s) vs hashlib and zlib; fingerprint (both
                  launches) / absmax / quantize /
                  dequantize vs plain; flash-attention forward, flash
                  decode, the selective scan (bf16 and float32, a row
                  each) and the RG-LRU scan vs plain at the serving shapes;
                  the flash-attention backward (dkv, dq) at the training
                  shapes.
                  The forward, the dkv and the dq pass have two variants,
                  chosen by dtype, both on the tensor cores: bfloat16
                  through wgmma, float32 in 3xTF32 (mma.sync); each is
                  held, timed (with its TFLOP/s) and listed as a row of its
                  own
  delta           delta saves of the full-width state at 1% and 5% block
                  churn: exact d2h accounting, bit-identical restore; one
                  save's fingerprint launches under the profiler
  spot_loop       transparent policy, one eviction: bitwise-equal final loss
                  against an uninterrupted run; each urgent save's wall
                  time and legs against its notice budget
  spot_loop_int8  the same on a quantize_moments store: the urgent save
                  quantizes the moments on the device, the restore widens
                  them there, bit-identical to the host dequantize
  fleet_peer      phi3-mini's cut trained on a delta-mode store to three
                  periodic saves; the warm fingerprint tracker rescaled
                  2 -> 3 -> 2 members, then a delta save copying under half
                  the state; at an eviction notice, an urgent save and a
                  three-member peer exchange seeded under its 256 MiB
                  budget; the replacement restores onto the card through
                  its peers, bitwise equal to a restore from the store,
                  the peer hits equal to the chunks seeded, and again with
                  a peer's server closed
  train_gemma3    8 make_train_step steps of gemma3-1b (26 layers, bf16,
                  batch 2 x 2048), every attention layer through the flash
                  forward, dkv and dq kernels: step time, tokens/s, peak
                  memory, a profiled step; a float32 one-period copy's
                  gradients on the card against the same step on the host
  spot_loop_gemma3  the spot_loop contract at gemma3-1b's full width cut
                  to one period (6 layers), sequences of 1024
  serve_gemma3,   batch 4, a 1984-token prompt, 64 greedy tokens through
  serve_recurrentgemma,  serve.make_prefill / make_decode_step (and
  serve_phi3,     serve.generate): prefill and decode tokens/s; a
  serve_falcon_mamba
                  float32 copy's decode logits against its teacher-forced
                  logits; a mid-generation save and restore that must
                  continue to bitwise the same tokens
  serve_deepseek_moe, serve_minitron
                  the same for the full MoE (16.4 B, routed prefill,
                  dropless decode; its float32 copy cut to the prelude and
                  two MoE layers, batch 1, 512 + 16 tokens, at a capacity
                  no pair overflows, each cut printed under "reduced") and
                  for minitron-8b (GQA 4, ungated squared ReLU)
  spot_loop_moe   the spot_loop contract at deepseek-moe-16b's width cut
                  to its prelude and one MoE layer, the factored second
                  moment, sequences of 1024; the aux loss finite, nonzero
                  and equal in both runs
  embeds_musicgen musicgen-medium from seeded frame embeddings: prefill,
                  15 decode steps fed the next frames, float32 decode
                  logits against teacher forcing

Launch counts are reset just before each main-path run and read just after
it; every kernel must have launched on the main path. Every bf16 run's
flash forward, dkv and dq launches must have gone through the wgmma
variants, and the float32 runs (the one-period gradient check, the float32
decode against teacher forcing) through the float32 ones: the 3xTF32
forward, dkv and dq. Prints the
card's name and power limit, ``ptxas``'s registers, spills and warnings,
one ``{"kernels": [...]}`` line, and as its last line
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
TF32_FLOPS_PER_S = 495e12      # H100 SXM dense TF32 tensor-core rate
TF32X3 = "3xTF32 (mma.sync, tensor cores)"   # the float32 kernels' route
L2_BYTES = 50 * 2 ** 20        # H100 SXM L2 cache
CHUNK = 1 << 20
LAYERS = 2                     # phi3-mini at full width, cut in depth
STEPS = 8                      # train steps of each spot loop
SERVE_B, PROMPT, NEW, CACHE_LEN = 4, 1984, 64, 2048   # serving phases
SAVE_AT = 32                   # new tokens before the mid-generation save
LOGIT_TOL = 2e-3               # float32 decode vs teacher-forced logits
TRAIN_B, TRAIN_S = 2, 2048     # gemma3-1b training batch
PHI3_S = 2048                  # the kernels phase's 2048-token prefill cases
TRAIN_STEPS = 8
LOOP_LAYERS, LOOP_S = 6, 1024  # spot_loop_gemma3: one period, its sequences
MOE_LOOP_LAYERS = 2            # spot_loop_moe: deepseek's prelude + 1 MoE layer
EMB_PROMPT, EMB_NEW = 512, 16  # embeds phase: prompt frames, new tokens
MOE_TF_CUT = {"n_layers": 3, "batch": 1, "prompt": 512, "new_tokens": 16,
              "dropless": True}   # deepseek's float32 teacher-forcing copy
GRAD_TOL = 2e-4                # backward kernels vs plain in float32, of
                               # max(1, max|plain|): the reference's
                               # gradient tolerance, 10 x 2e-5
MODEL_GRAD_TOL = 1e-4          # card vs host gradients, of each leaf's max
MODEL_LOSS_TOL = 1e-5          # card vs host loss, relative
SCAN_TOL = 1e-4                # selective scan vs plain: the reference's
SFU_PER_SM_CLOCK = 16          # exponentials per SM per clock (H100)
FP32_PER_SM_CLOCK = 128        # float32 instructions per SM per clock
INT32_OPS_PER_SM_CLOCK = 64    # 32-bit integer multiply, shift and logic
                               # per SM per clock (H100)
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
    windows. The checkpoint and scan operands exceed the L2, so those
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


_graph_stream = None   # one side stream for every capture: cuBLAS keeps a
                       # workspace for each stream it has run on


def graph_ms(fns, replays: int = 10, runs: int = 5) -> float:
    """Device time of one call where the host's launch path would hide
    it: one call of each of ``fns`` (one per rotated operand copy)
    captured into a CUDA graph after a warm-up on the capture stream, the
    graph replayed ``replays`` times between CUDA events, divided by the
    calls; the median of ``runs`` such windows."""
    import torch
    global _graph_stream
    if _graph_stream is None:
        _graph_stream = torch.cuda.Stream()
    side = _graph_stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for fn in fns:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(replays):
            graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / (replays * len(fns)))
    del graph
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


def fingerprint_kernels(embed, cases) -> dict:
    """The fingerprint's two launches against their plain versions, bit for
    bit, on ``cases`` at 1 MiB blocks; the whole call (both launches) and
    the final launch alone timed on phi3-mini's embed, in device time from
    a CUDA graph (in turns, three each, the median kept) and eagerly."""
    import torch
    from repro_torch.kernels.fingerprint import (SLICE_BYTES,
                                                 fingerprint_blocks,
                                                 fingerprint_blocks_ref,
                                                 fingerprint_diff,
                                                 fingerprint_diff_ref,
                                                 fingerprint_final,
                                                 fingerprint_final_ref,
                                                 fingerprint_grid,
                                                 fingerprint_partials,
                                                 fingerprint_partials_ref)
    for x in cases:
        what = f"{tuple(x.shape)} {x.dtype}"
        parts = fingerprint_partials(x, block_bytes=CHUNK)
        need(same_bits(parts, fingerprint_partials_ref(x, CHUNK, SLICE_BYTES)),
             f"fingerprint partials mismatch {what}")
        fp = fingerprint_blocks(x, block_bytes=CHUNK)
        need(same_bits(fp, fingerprint_blocks_ref(x, CHUNK)),
             f"fingerprint mismatch {what}")
        old = fp.clone()
        old[::3] ^= 1
        fp2, diff = fingerprint_diff(x, old, block_bytes=CHUNK)
        fpr, diffr = fingerprint_diff_ref(x, old, CHUNK)
        need(same_bits(fp2, fpr) and torch.equal(diff, diffr),
             f"fingerprint_diff mismatch {what}")
        fp3, diff3 = fingerprint_final(parts, old)
        need(same_bits(fp3, fpr) and torch.equal(diff3, diffr),
             f"fingerprint final mismatch {what}")
    old = fingerprint_blocks(embed, block_bytes=CHUNK)
    old[::2] ^= 1
    nb = old.numel()
    parts = fingerprint_partials(embed, block_bytes=CHUNK)
    grid = fingerprint_grid()
    print(json.dumps({"fingerprint_grid": {
        "ctas": grid, "threads": 1024, "slice_bytes": SLICE_BYTES,
        "blocks": nb, "slices": parts.numel(),
        "slices_per_cta": parts.numel() / grid,
        "most_slices_of_a_cta": -(-parts.numel() // grid)}}), flush=True)
    call = functools.partial(fingerprint_diff, embed, old, block_bytes=CHUNK)
    final = functools.partial(fingerprint_final, parts, old)
    turns = [(graph_ms([call], replays=20), graph_ms([final], replays=20))
             for _ in range(3)]
    fpr, diffr = fingerprint_diff_ref(embed, old, CHUNK)
    fp, diff = call()
    ff, fdiff = final()
    need(same_bits(ff, fpr) and torch.equal(fdiff, diffr),
         "fingerprint final mismatch on the embed")
    # the integer operations over the card's 32-bit integer rate at its clock
    clock = sm_clock_mhz()
    int_rate = H100_SMS * INT32_OPS_PER_SM_CLOCK * clock * 1e6
    return {
        "fingerprint": dict(
            ms=statistics.median(t[0] for t in turns), eager_ms=time_ms(call),
            plain_ms=time_ms(lambda: fingerprint_diff_ref(embed, old, CHUNK),
                             reps=5),
            library_ms=None, max_abs_err=max(
                max_abs_err(fp.to(torch.int64), fpr.to(torch.int64)),
                float((diff != diffr).sum())),
            # bytes: the tensor once, old digests in, digests + diff out;
            # operations: 6 integer ops per word (one word per bf16 element):
            # pos*C1, xor, *C2, >>15, xor, add
            bound=bound(embed.numel() * 2 + nb * 9, embed.numel() * 6, int_rate),
            grid=grid, slice_bytes=SLICE_BYTES, sm_clock_mhz=clock,
            shape=list(embed.shape), dtype="bfloat16"),
        "fingerprint_final": dict(
            ms=statistics.median(t[1] for t in turns), eager_ms=time_ms(final),
            plain_ms=time_ms(lambda: fingerprint_final_ref(parts, old)),
            library_ms=None, max_abs_err=max(
                max_abs_err(ff.to(torch.int64), fpr.to(torch.int64)),
                float((fdiff != diffr).sum())),
            # bytes: the partials and old digests in, digests + diff out;
            # operations: one add per partial, fmix32's 7 and the compare
            bound=bound(parts.numel() * 4 + nb * 9, parts.numel() + nb * 8,
                        int_rate),
            shape=list(parts.shape), dtype="int32")}


def chunk_digest_kernel(dev, leaves) -> dict:
    """The chunk digest against its plain version (hashlib's SHA-1 and
    zlib's CRC-32), every chunk, on ragged, mixed-dtype cases in one call
    and at 1 MiB, 4 KiB and 64-byte chunks; then checked and timed on
    ``leaves``, the leaves a spot loop's urgent save digested (one launch
    over all their 1 MiB chunks, as in the save). Its plain version runs on
    the host, timed on the host's clock."""
    import torch
    from repro_torch.kernels.chunk_digest import (chunk_digests,
                                                  chunk_digests_ref)
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    cases = [torch.randn((3 * CHUNK // 4 + 5,), generator=g, device=dev),
             torch.randn((CHUNK // 2 + 7,), generator=g,
                         device=dev).to(torch.bfloat16),
             torch.randint(-128, 127, (CHUNK + 12345,), dtype=torch.int8,
                           generator=g, device=dev),
             torch.zeros((0,), device=dev),
             torch.randint(0, 1 << 30, (5,), dtype=torch.int32, generator=g,
                           device=dev)]
    for cb in (CHUNK, 4096, 64):
        got = chunk_digests(cases, cb).result()
        need(got == [chunk_digests_ref(t.cpu(), cb) for t in cases],
             f"chunk digests differ from hashlib/zlib at {cb}-byte chunks")
    host = [t.cpu() for t in leaves]
    t0 = time.perf_counter()
    want = [chunk_digests_ref(t, CHUNK) for t in host]
    plain_ms = (time.perf_counter() - t0) * 1e3
    got = chunk_digests(leaves, CHUNK).result()
    mismatched = sum(a != b for g_, w in zip(got, want) for a, b in zip(g_, w))
    need(mismatched == 0, f"{mismatched} chunk digests differ on the leaves")
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    n_chunks = sum(map(len, got))
    clock = sm_clock_mhz()
    int_rate = H100_SMS * INT32_OPS_PER_SM_CLOCK * clock * 1e6
    return {"chunk_digest": dict(
        ms=time_ms(lambda: chunk_digests(leaves, CHUNK), reps=5, runs=3),
        plain_ms=plain_ms, plain_on="host", library_ms=None,
        max_abs_err=float(mismatched), chunks=n_chunks,
        # bytes: each leaf once, 24 bytes out a chunk; operations: SHA-1's
        # ~1,016 integer operations a 64-byte block (80 rounds and the
        # schedule) and CRC-32's ~15 a word by slicing-by-4, 20 a byte
        bound=bound(nbytes + n_chunks * 24, nbytes * 20, int_rate),
        sm_clock_mhz=clock, shape=[list(t.shape) for t in leaves],
        dtype=[str(t.dtype).replace("torch.", "") for t in leaves])}


# ---------------------------------------------------------------------------
# phase: kernels
# ---------------------------------------------------------------------------

def phase_kernels(cfg, dev) -> dict:
    """Each kernel against its plain version, bit-for-bit, at the main
    path's shapes; device times of kernel, plain version and library call."""
    import numpy as np
    import torch
    from repro_torch.checkpoint import serialize as ser
    from repro_torch.kernels.quantize import (absmax, absmax_grid, absmax_ref,
                                              dequantize_int8,
                                              dequantize_int8_ref,
                                              dequantize_layout,
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
    out.update(fingerprint_kernels(embed, cases))
    # the chunk digest's row is made by the spot_loop phase, on its urgent
    # save's leaves (``KERNEL_ROW_PHASE``)

    # absmax: moment (f32), embed (bf16), ragged, a whole trip of the
    # resident grid and one element either side, a misaligned view, NaN
    grid, trip = absmax_grid(torch.float32)
    flat = moment.reshape(-1)
    for x in (moment, embed, cases[3], torch.randn(7, device=dev),
              flat[:trip - 1], flat[:trip], flat[:trip + 1], flat[1:]):
        need(same_bits(absmax(x)[0], absmax_ref(x)),
             f"absmax mismatch {x.dtype} n={x.numel()}")
    xn = moment.clone()
    xn.view(-1)[12345] = float("nan")
    need(bool(torch.isnan(absmax(xn)[0])), "absmax dropped a NaN")
    print(json.dumps({"absmax_grid": {"ctas": grid, "threads": 1024,
                                      "elements_per_trip": trip,
                                      "trips_of_the_moment":
                                          moment.numel() / trip}}), flush=True)
    # device time from a CUDA graph for the kernels and their library call
    # (an eager call's host path, an allocation and two launches, can take
    # as long as its kernels), measured in turns, three each, the median
    # kept; the eager times beside them
    norm = functools.partial(torch.linalg.vector_norm, moment, ord=math.inf)
    turns = [(graph_ms([lambda: absmax(moment)], replays=20),
              graph_ms([norm], replays=20)) for _ in range(3)]
    out["absmax"] = dict(
        grid=grid, ms=statistics.median(t[0] for t in turns),
        library_ms=statistics.median(t[1] for t in turns),
        eager_ms=time_ms(lambda: absmax(moment)), library_eager_ms=time_ms(norm),
        plain_ms=time_ms(lambda: absmax_ref(moment)),
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
    for dt in (torch.float32, torch.bfloat16):
        need(same_bits(torch.mul(q, s_dev).to(dt), dequantize_int8(q, scale, dtype=dt)),
             f"dequantize disagrees with torch.mul(q, scale) ({dt})")
    lay = dequantize_layout(torch.float32)
    print(json.dumps({"dequantize_grid": dict(
        lay, store="default (write-back)", trips_of_the_moment=q.numel()
        / lay["values_per_trip"])}), flush=True)
    # device time from a CUDA graph, kernel and library call in turns, three
    # each, the median kept; the eager times beside them. Under the
    # deterministic settings every torch.empty is filled first: the
    # wrapper's output is not (kernel_output), and fill_ms is what such a
    # fill of the output costs
    deq = {dt: functools.partial(dequantize_int8, q, scale, dtype=dt)
           for dt in (torch.float32, torch.bfloat16)}
    mul = functools.partial(torch.mul, q, s_dev)
    turns = [(graph_ms([deq[torch.float32]], replays=20), graph_ms([mul], replays=20),
              graph_ms([deq[torch.bfloat16]], replays=20)) for _ in range(3)]
    out["dequantize"] = dict(
        ms=statistics.median(t[0] for t in turns),
        library_ms=statistics.median(t[1] for t in turns),
        bf16_ms=statistics.median(t[2] for t in turns),
        eager_ms=time_ms(deq[torch.float32]), library_eager_ms=time_ms(mul),
        bf16_eager_ms=time_ms(deq[torch.bfloat16]),
        fill_ms=graph_ms([functools.partial(torch.empty, q.shape, device=dev)],
                         replays=20),
        plain_ms=time_ms(lambda: dequantize_int8_ref(q, scale, dtype=torch.float32)),
        max_abs_err=max_abs_err(
            dequantize_int8(q, scale, dtype=torch.float32),
            dequantize_int8_ref(q, scale, dtype=torch.float32)),
        # convert, multiply; bf16: 1 + 2 bytes an element
        bound=bound(q.numel() * 5, q.numel() * 2),
        bf16_bound=bound(q.numel() * 3, q.numel() * 2), layout=lay,
        shape=list(q.shape), dtype="int8->float32")
    del embed, moment, flat, norm, cases, xn
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


def _fwd_times(q, k, v, window, rate, products: int = 1) -> dict:
    """Device times of the flash forward on causal (optionally windowed)
    self-attention operands, its plain version and SDPA (causal flag, or a
    band mask for a window), with the bound and the achieved rate. Each
    bound counts the work this data needs: the unmasked (q, k) pairs at 4
    FLOPs per pair and head dimension (QK^T and PV), ``products`` tensor
    products each (3 in 3xTF32), over ``rate``, or the bytes of q, k, v
    read and o, lse written. The rate reported counts each product once."""
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
                library_ms=time_ms(lib),
                bound=bound(nbytes, products * flops, rate),
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
                                                      decode_merge,
                                                      decode_merge_ref,
                                                      decode_partials,
                                                      decode_splits,
                                                      flash_decode)
    from repro_torch.kernels import _lib
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_fwd)
    from repro_torch.kernels.rglru_scan import (rglru_scan, rglru_scan_ref,
                                                scan_layout)

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
        # the 3xTF32 float32 kernel on the same values widened: held (no
        # bf16 rounding to hide a fault in) and timed
        a32 = tuple(t.to(f32) for t in (q, k, v))
        o32, lse32 = flash_attention_fwd(*a32, True, window)
        want32, wl32 = attention_ref(*a32, causal=True, window=window)
        err32 = _att_check(what + " float32", o32, want32, lse32, wl32)
        del o32, lse32, want32, wl32
        flash32[name] = dict(
            _fwd_times(*a32, window, TF32_FLOPS_PER_S, 3), max_abs_err=err32,
            tol=ATT_TOL, shape=[B, S, H, KV, hd], window=window,
            dtype="float32", kernel=TF32X3)
        del a32, o, lse
    # the other served models' heads at a causal prefill: phi3-mini's (32
    # of 96), deepseek-moe's (16 of 128, MHA) and minitron's (32 of 128, 8
    # KV) over PHI3_S tokens, musicgen's (24 of 64, MHA) at its 4 x 512
    # frames; each in bf16 and widened to float32, as their teacher-forced
    # copies run it
    for name, Bf, Sf, Hf, KVf, hdf in (
            ("phi3_hd96", 1, PHI3_S, 32, 32, 96),
            ("deepseek_hd128", 1, PHI3_S, 16, 16, 128),
            ("minitron_gqa4", 1, PHI3_S, 32, 8, 128),
            ("musicgen_hd64", SERVE_B, EMB_PROMPT, 24, 24, 64)):
        qp = torch.randn((Bf, Sf, Hf, hdf), generator=g, device=dev).to(bf)
        kp, vp = (torch.randn((Bf, Sf, KVf, hdf), generator=g,
                              device=dev).to(bf) for _ in range(2))
        o, lse = flash_attention_fwd(qp, kp, vp, True, 0)
        want, want_lse = attention_ref(qp, kp, vp, causal=True)
        flash[name] = dict(
            _fwd_times(qp, kp, vp, 0, BF16_FLOPS_PER_S),
            max_abs_err=_att_check(f"flash_attention {name}", o, want, lse,
                                   want_lse),
            tol=ATT_TOL, bf16_rtol=BF16_RTOL, shape=[Bf, Sf, Hf, KVf, hdf],
            window=0, dtype="bfloat16", kernel="wgmma (tensor cores)")
        a32 = tuple(t.to(f32) for t in (qp, kp, vp))
        o32, lse32 = flash_attention_fwd(*a32, True, 0)
        want32, wl32 = attention_ref(*a32, causal=True)
        flash32[name] = dict(
            _fwd_times(*a32, 0, TF32_FLOPS_PER_S, 3),
            max_abs_err=_att_check(f"flash_attention {name} float32", o32,
                                   want32, lse32, wl32),
            tol=ATT_TOL, shape=[Bf, Sf, Hf, KVf, hdf], window=0,
            dtype="float32", kernel=TF32X3)
        del qp, kp, vp, o, lse, want, a32, o32, lse32, want32, wl32
    # the rows: the global layer's case; the others beside it
    out["flash_attention_fwd_wgmma"] = dict(flash["global"], cases=flash)
    out["flash_attention_fwd_tf32x3"] = dict(flash32["global"], cases=flash32)
    del q, k, v
    torch.cuda.empty_cache()

    # decode: gemma3's full cache at valid_len 2000 (not a multiple of the
    # kernel's 32-key tile) and its filled 512-slot ring, recurrentgemma's
    # 2048-slot ring at its first decode step (10 heads, 1985 filled),
    # phi3-mini's full cache (32 heads of 96, MHA, all 2048 rows),
    # deepseek-moe's (16 of 128, MHA) and minitron's (32 of 128, 8 KV)
    # full caches, and musicgen's (24 of 64, MHA) at its last frame. Cache
    # copies holding twice the L2 between them rotate through the timed
    # calls, so each call reads its cache from device memory as a decode
    # step does; kernel, plain version and SDPA are each timed from a CUDA
    # graph of one call per copy (their host launch paths would hide a
    # few-microsecond kernel). The row's time is the whole call: the split
    # pass and the merge.
    dec, merge = {}, {}
    for name, Hd, KVd, hdd, Sc, vl in (
            ("full", H, KV, hd, CACHE_LEN, PROMPT + 16),
            ("ring", H, KV, hd, 512, 512),
            ("ring_partial", 10, KV, hd, CACHE_LEN, PROMPT + 1),
            ("phi3_hd96", 32, 32, 96, CACHE_LEN, CACHE_LEN),
            ("deepseek_hd128", 16, 16, 128, CACHE_LEN, CACHE_LEN),
            ("minitron_gqa4", 32, 8, 128, CACHE_LEN, CACHE_LEN),
            ("musicgen_hd64", 24, 24, 64, EMB_PROMPT + EMB_NEW,
             EMB_PROMPT + EMB_NEW)):
        qd = torch.randn((B, 1, Hd, hdd), generator=g, device=dev).to(bf)
        n_copies = max(8, -(-2 * L2_BYTES // (B * Sc * KVd * hdd * 2 * 2)))
        ks = [torch.randn((B, Sc, KVd, hdd), generator=g, device=dev).to(bf)
              for _ in range(n_copies)]
        vs = [torch.randn((B, Sc, KVd, hdd), generator=g, device=dev).to(bf)
              for _ in range(n_copies)]
        o = flash_decode(qd, ks[0], vs[0], vl)
        need(same_bits(o, flash_decode(qd, ks[0], vs[0], vl)),
             f"flash_decode {name}: two calls differ")
        want = decode_attention_ref(qd[:, 0], ks[0], vs[0], vl)[:, None]
        err = _att_check(f"flash_decode {name}", o, want)
        q32, k32, v32 = qd.to(f32), ks[0].to(f32), vs[0].to(f32)
        err32 = _att_check(f"flash_decode {name} float32",
                           flash_decode(q32, k32, v32, vl),
                           decode_attention_ref(q32[:, 0], k32, v32, vl)[:, None])
        del q32, k32, v32
        # the merge kernel alone, on the split kernel's partials
        ws = decode_partials(qd[:, 0], ks[0], vs[0], vl)
        mo = decode_merge(ws, bf)
        merr = _att_check(f"decode merge {name}", mo, decode_merge_ref(ws, bf))
        qt = qd.transpose(1, 2).contiguous()               # (B,H,1,hd)
        mask = (torch.arange(Sc, device=dev) < vl)[None, None, None, :]
        splits, per = decode_splits(B, KVd, hdd, vl)
        ops = B * Hd * vl * hdd * 4
        nbytes = B * vl * KVd * hdd * 2 * 2 + qd.numel() * 2 * 2
        ms = graph_ms([functools.partial(flash_decode, qd, kc, vc, vl)
                       for kc, vc in zip(ks, vs)])
        dec[name] = dict(
            ms=ms, plain_ms=graph_ms([
                functools.partial(decode_attention_ref, qd[:, 0], kc, vc, vl)
                for kc, vc in zip(ks, vs)], replays=3),
            library_ms=graph_ms([
                _sdpa(qt, kc.transpose(1, 2).contiguous(),
                      vc.transpose(1, 2).contiguous(), attn_mask=mask)
                for kc, vc in zip(ks, vs)]),
            max_abs_err=err, f32_max_abs_err=err32,
            bound=bound(nbytes, ops, BF16_FLOPS_PER_S), gb_per_s=nbytes / ms / 1e6,
            splits=splits, keys_per_split=per, ctas=splits * KVd * B,
            tol=ATT_TOL, bf16_rtol=BF16_RTOL, shape=[B, Sc, Hd, KVd, hdd],
            valid_len=vl, cache_copies=n_copies, dtype="bfloat16")
        # reads every partial once, writes the output
        wss = [decode_partials(qd[:, 0], kc, vc, vl) for kc, vc in zip(ks, vs)]
        merge[name] = dict(
            ms=graph_ms([functools.partial(decode_merge, w, bf) for w in wss]),
            plain_ms=graph_ms([functools.partial(decode_merge_ref, w, bf)
                               for w in wss], replays=3),
            library_ms=None, max_abs_err=merr,
            bound=bound(ws.numel() * 4 + mo.numel() * 2,
                        ws.numel() // (hdd + 2) * (hdd * 2 + 2)),
            tol=ATT_TOL, bf16_rtol=BF16_RTOL, shape=list(ws.shape),
            dtype="float32->bfloat16")
        del ks, vs, ws, wss
        torch.cuda.empty_cache()
    out["decode_attention"] = dict(dec["full"], cases=dec)
    out["decode_attention_merge"] = dict(merge["full"], cases=merge)
    print(json.dumps({"decode_cases": {
        n: {k: c[k] for k in ("splits", "keys_per_split", "ctas", "ms",
                              "gb_per_s", "library_ms", "bound")}
        for n, c in dec.items()}, "decode_ptxas": {
        n: r for n, r in ptxas_summary(_lib.ptxas_report()).items()
        if n.startswith("decode_")}}), flush=True)

    # RG-LRU scan: recurrentgemma-2b's prefill, float32 gates
    W = 2560
    a = torch.sigmoid(torch.randn((B, S, W), generator=g, device=dev))
    b = torch.randn((B, S, W), generator=g, device=dev)
    h, h_last = rglru_scan(a, b)
    hr, lr = rglru_scan_ref(a, b)
    need(same_bits(h, hr) and same_bits(h_last, lr),
         "rglru_scan differs from the plain sequential scan")
    layout = {name: dict(scan_layout(B, W, dt), **next(
        (r for n, r in ptxas_summary(_lib.ptxas_report()).items()
         if n.startswith(f"rglru_kernel<{name}")), {}))
        for name, dt in (("f32", f32), ("bf16", bf))}
    print(json.dumps({"rglru_layout": layout}), flush=True)
    scan = functools.partial(rglru_scan, a, b)
    out["rglru_scan"] = dict(
        ms=statistics.median(graph_ms([scan], replays=20) for _ in range(3)),
        eager_ms=time_ms(scan),
        plain_ms=time_ms(lambda: rglru_scan_ref(a, b), reps=2, runs=3,
                         warmup=1),
        library_ms=None, max_abs_err=max_abs_err(h, hr),
        # a, b read, h written (float32), h_last written; a multiply and an
        # add per element
        bound=bound(a.numel() * 12 + h_last.numel() * 4, a.numel() * 2),
        layout=layout["f32"], tol=0.0, shape=[B, S, W], dtype="float32")
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
    widened), at phi3-mini's and deepseek-moe's heads (bf16), plus
    correctness cases: phi3-mini's head dim 96, a padded sequence and GQA
    through the full ``flash_attention_bwd``. Times of
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
    dkv_cases, dkv32_cases, dq_cases, dq32_cases = {}, {}, {}, {}
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
        # the 3xTF32 dkv and dq kernels, timed
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
        in32 = (q.numel() * 2 + k.numel() * 2) * 4 + lse.numel() * 4 * 2
        ms32 = time_ms(lambda: flash_attention_dkv(*args32, True, window))
        lib32 = _sdpa_bwd_ms(*a32, window)
        # the bound of the route taken: every float32 product is three TF32
        # products (3xTF32) over the TF32 tensor-core rate
        common32 = dict(library_ms=lib32, tol=GRAD_TOL, shape=[B, S, H, KV, hd],
                        window=window, dtype="float32",
                        kernel=TF32X3,
                        library="SDPA backward (both passes)")
        dkv32_cases[name] = dict(
            ms=ms32, plain_ms=time_ms(lambda: attention_dkv_ref(
                *args32, causal=True, window=window), reps=3),
            max_abs_err=f32_err_dkv,
            bound=bound(in32 + out_bytes, 3 * pairs * hd * 8,
                        TF32_FLOPS_PER_S),
            tflops=pairs * hd * 8 / ms32 / 1e9, **common32)
        ms32 = time_ms(lambda: flash_attention_dq(*args32, True, window))
        dq32_cases[name] = dict(
            ms=ms32, plain_ms=time_ms(lambda: attention_dq_ref(
                *args32, causal=True, window=window), reps=3),
            max_abs_err=f32_err_dq,
            # S, dP, dQ: 6 FLOPs per pair and head dim; dq written in float32
            bound=bound(in32 + q.numel() * 4, 3 * pairs * hd * 6,
                        TF32_FLOPS_PER_S),
            tflops=pairs * hd * 6 / ms32 / 1e9, **common32)
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
        ms = time_ms(lambda: flash_attention_dq(*args, True, window))
        dq_cases[name] = dict(
            ms=ms, plain_ms=time_ms(lambda: attention_dq_ref(
                *args, causal=True, window=window), reps=3),
            max_abs_err=err_dq, f32_max_abs_err=f32_err_dq,
            # S, dP, dQ: three products, 6 FLOPs per pair and head dim
            bound=bound(in_bytes + q.numel() * 2, pairs * hd * 6,
                        BF16_FLOPS_PER_S),
            tflops=pairs * hd * 6 / ms / 1e9, kernel="wgmma (tensor cores)",
            **common)
        del o, lse, dsum, args
    del q, k, v, do
    torch.cuda.empty_cache()

    # the tensor-core dkv and dq passes at phi3-mini's heads (32 of 96,
    # PHI3_S tokens) and at spot_loop_moe's (deepseek-moe's 16 of 128, MHA,
    # 2 x LOOP_S)
    for name, Bh, Sh, Hh, hdh in (("phi3_hd96", 1, PHI3_S, 32, 96),
                                  ("deepseek_hd128", 2, LOOP_S, 16, 128)):
        qp, dop, kp, vp = (torch.randn((Bh, Sh, Hh, hdh), generator=g,
                                       device=dev).to(bf) for _ in range(4))
        o, lse = flash_attention_fwd(qp, kp, vp, True, 0)
        dsum = (dop.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        args = (qp, kp, vp, dop, lse, dsum)
        err = max(_grad_check(f"dkv {name} {n}", x, y)
                  for n, x, y in zip(("dk", "dv"),
                                     flash_attention_dkv(*args, True, 0),
                                     attention_dkv_ref(*args, causal=True)))
        err_dq = _grad_check(f"dq {name}", flash_attention_dq(*args, True, 0),
                             attention_dq_ref(*args, causal=True))
        pairs = Bh * Hh * _pairs(Sh, 0)
        common = dict(library_ms=_sdpa_bwd_ms(qp, kp, vp, dop, 0),
                      kernel="wgmma (tensor cores)",
                      shape=[Bh, Sh, Hh, Hh, hdh], window=0,
                      dtype="bfloat16", tol=GRAD_TOL,
                      library="SDPA backward (both passes)")
        ms = time_ms(lambda: flash_attention_dkv(*args, True, 0))
        dkv_cases[name] = dict(
            ms=ms, plain_ms=time_ms(lambda: attention_dkv_ref(
                *args, causal=True), reps=3), max_abs_err=err,
            # q, do, k, v (bf16), lse, D read; dk, dv written in float32
            bound=bound(qp.numel() * 8 + lse.numel() * 8 + qp.numel() * 8,
                        pairs * hdh * 8, BF16_FLOPS_PER_S),
            tflops=pairs * hdh * 8 / ms / 1e9, **common)
        ms = time_ms(lambda: flash_attention_dq(*args, True, 0))
        dq_cases[name] = dict(
            ms=ms, plain_ms=time_ms(lambda: attention_dq_ref(
                *args, causal=True), reps=3), max_abs_err=err_dq,
            # q, do, k, v, lse, D read; dq written in bf16
            bound=bound(qp.numel() * 2 * 5 + lse.numel() * 8,
                        pairs * hdh * 6, BF16_FLOPS_PER_S),
            tflops=pairs * hdh * 6 / ms / 1e9, bf16_ulps=2, **common)
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
            "flash_attention_dkv_tf32x3": dict(
                dkv32_cases["global"], cases=dkv32_cases, checks=extra),
            "flash_attention_dq_wgmma": dict(dq_cases["global"], cases=dq_cases,
                                             checks=extra),
            "flash_attention_dq_tf32x3": dict(
                dq32_cases["global"], cases=dq32_cases, checks=extra)}


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
    prefill shape, in bf16 and in float32 on the same values widened, each
    instance timed as a row of its own (the serving phases run both)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ssm_scan import scan_layout, ssm_scan, ssm_scan_ref

    g = torch.Generator(device=dev)
    g.manual_seed(5)
    B, S, DI, N = SERVE_B, PROMPT, 8192, 16
    u = torch.randn((B, S, DI), generator=g, device=dev).to(torch.bfloat16)
    dt = F.softplus(torch.randn((B, S, DI), generator=g, device=dev) - 2.0
                    ).to(torch.bfloat16)
    # the model's A = -exp(A_log) = -(1..N) and D = 1; B, C in the model
    # dtype, read in place from x_proj's output as the model reads them
    A = -torch.arange(1, N + 1, dtype=torch.float32, device=dev).expand(DI, N)
    A = A.contiguous()
    D = torch.ones(DI, device=dev)
    dt_rank = 256                     # falcon-mamba-7b's x_proj: (256, 16, 16)
    proj = torch.randn((B, S, dt_rank + 2 * N), generator=g, device=dev
                       ).to(torch.bfloat16)
    Bm, Cm = proj[..., dt_rank:dt_rank + N], proj[..., dt_rank + N:]
    args = (u, dt, A, Bm, Cm, D)
    y, h = ssm_scan(*args)
    yr, hr = ssm_scan_ref(*args)
    err = max_abs_err(y, yr)
    need(torch.allclose(y.float(), yr.float(), atol=SCAN_TOL, rtol=BF16_RTOL),
         f"ssm_scan bf16 y: max err {err} (one ulp + {SCAN_TOL})")
    h_err = max_abs_err(h, hr)
    need(h_err <= SCAN_TOL * max(1.0, float(hr.abs().max())),
         f"ssm_scan h_last: max err {h_err}")
    y2, h2 = ssm_scan(*args)
    need(same_bits(y, y2) and same_bits(h, h2),
         "ssm_scan: two calls gave different bits")
    a32 = (u.float(), dt.float(), A, proj.float()[..., dt_rank:dt_rank + N],
           proj.float()[..., dt_rank + N:], D)
    y32, h32 = ssm_scan(*a32)
    yr32, hr32 = ssm_scan_ref(*a32)
    f32_err = max(max_abs_err(y32, yr32), max_abs_err(h32, hr32))
    need(f32_err <= SCAN_TOL, f"ssm_scan float32: max err {f32_err}")
    del y32, h32, yr32, hr32, yr, hr, y2, h2
    clock = sm_clock_mhz()
    exps = B * S * DI * N
    layouts = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        lay = scan_layout(DI, dtype)
        ctas = lay["ctas_per_row"] * B
        lay.update(ctas=ctas, resident_warps_per_sm=min(
            lay["ctas_per_sm"], -(-ctas // H100_SMS)) * lay["threads"] // 32)
        layouts[name] = lay
    print(json.dumps({"ssm_scan_layout": layouts}), flush=True)
    out = {}
    for name, a, esize in (("ssm_scan_bf16", args, 2), ("ssm_scan_f32", a32, 4)):
        # u, dt and y; B and C; A, D and h_last
        nbytes = (u.numel() * esize * 3 + B * S * N * 2 * esize
                  + (A.numel() + D.numel() + h.numel()) * 4)
        out[name] = dict(
            ms=time_ms(lambda: ssm_scan(*a)),
            plain_ms=time_ms(lambda: ssm_scan_ref(*a), reps=2, runs=3, warmup=1),
            library_ms=None,
            max_abs_err=err if name == "ssm_scan_bf16" else f32_err,
            h_last_max_abs_err=h_err if name == "ssm_scan_bf16" else f32_err,
            # exponentials over the special-function units at the card's
            # clock; beside it the float32 pipe's floor: 5 instructions a
            # state and step (dt * A, two products, a sum, y's multiply-add)
            bound=bound(nbytes, exps, H100_SMS * SFU_PER_SM_CLOCK * clock * 1e6),
            fp32_pipe_ms=exps * 5 / (H100_SMS * FP32_PER_SM_CLOCK * clock * 1e6) * 1e3,
            layout=layouts[name.split("_")[-1]],
            sm_clock_mhz=clock, tol=SCAN_TOL,
            bf16_rtol=BF16_RTOL if name == "ssm_scan_bf16" else None,
            shape=[B, S, DI, N], dtype="bfloat16" if esize == 2 else "float32")
    del u, dt, Bm, Cm, y, h, args, a32, proj
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
    # the device time of one save's fingerprints: every tracked leaf's
    # fingerprint_diff, as a save launches them, under the profiler
    from repro_torch.kernels.fingerprint import (fingerprint_blocks,
                                                 fingerprint_diff)
    tracked = [(t, fingerprint_blocks(t, block_bytes=CHUNK))
               for n, t in ser.flatten_state(state).items()
               if tracker._codec_for(n, t) is not None]
    res["fingerprint_save"] = dict(
        _profile(lambda: [fingerprint_diff(t, old, block_bytes=CHUNK)
                          for t, old in tracked], 3),
        leaves=len(tracked), bytes=sum(t.numel() * t.element_size()
                                       for t, _ in tracked))
    del tracked
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
             seq_len=64, factored=False):
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.core import (AZURE_D8S_V3, CheckpointPolicy,
                                  CostAccountant, NoEviction, PeriodicEviction,
                                  ScaleSet, SpotOnCoordinator, TimeModel,
                                  VirtualClock)
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import SpotTrainer, TrainJob

    class RecordingCoordinator(SpotOnCoordinator):
        """Keeps the state handed to each urgent save and the last restore
        (the step is functional, so a held state stays unchanged), and
        each urgent save's step, notice budget (the virtual clock's seconds
        left, which the save waits for in real seconds), wall time on the
        host's clock, whether it committed and its legs (the
        coordinator's ``last_urgent_legs``: wall legs that partition the
        save's wall time, and the threads' busy seconds); after a save
        commits, its chunks are hashed on the host (``_hash_chunks``)."""
        urgent_state = None
        restored = None

        def _save_termination(self, step, state, deadline):
            self.urgent_state = state
            budget = deadline - self.clock.now()
            t0 = time.perf_counter()
            ok = super()._save_termination(step, state, deadline)
            self.urgent_saves.append({"step": step, "budget_s": budget,
                                      "wall_s": time.perf_counter() - t0,
                                      "committed": ok,
                                      "legs": self.last_urgent_legs,
                                      **(_hash_chunks(self.store, step)
                                         if ok else {})})
            return ok

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
    coord.urgent_saves = []
    job = TrainJob(cfg=cfg, opt=AdamWConfig(total_steps=steps, warmup_steps=2,
                                            factored_second_moment=factored),
                   total_steps=steps, n_stages=2, batch=2, seq_len=seq_len)
    trainer = SpotTrainer(job, coord, pool, clock, step_time_s=10.0,
                          max_sessions=10, device=dev)
    t0 = time.perf_counter()
    rep = trainer.run()
    coord.close()
    return rep, coord, time.perf_counter() - t0


def _hash_chunks(store, step) -> dict:
    """Every chunk the committed checkpoint of ``step`` references, read
    back from the pool and hashed on the host with hashlib and zlib: the
    count, and how many do not hash to their name or their CRC-32."""
    import hashlib
    import zlib
    from concurrent.futures import ThreadPoolExecutor
    man, reader = store.latest_valid(max_step=step)
    reader.close()
    need(man.step == step and man.kind == "termination",
         f"the checkpoint of step {step} is {man.kind} step {man.step}")
    refs = {c["h"]: c["c"] for r in man.tensors for c in r.get("chunks", ())}

    def bad(ref) -> bool:
        h, crc = ref
        with open(store.pool.path(h), "rb") as f:
            data = f.read()
        return hashlib.sha1(data).hexdigest() != h or zlib.crc32(data) != crc

    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as ex:
        n_bad = sum(ex.map(bad, refs.items()))
    return {"chunks_hashed": len(refs), "chunks_bad": n_bad,
            "hash_check_s": time.perf_counter() - t0}


def _need_urgent_chunks(what: str, coord, counted: dict) -> None:
    """Every committed urgent save launched the chunk digest (the stores
    here keep float leaves raw, so each save digests on the card) and
    every chunk its manifest references hashes to its name."""
    done = [u for u in coord.urgent_saves if u["committed"]]
    need(bool(done), f"{what}: no urgent save committed")
    need(counted["chunk_digest"] >= len(done),
         f"{what}: {counted['chunk_digest']} chunk digest launches for "
         f"{len(done)} urgent saves")
    for u in done:
        need(u["chunks_hashed"] > 0 and u["chunks_bad"] == 0,
             f"{what}: {u['chunks_bad']} of the {u['chunks_hashed']} chunks "
             f"of the urgent save at step {u['step']} do not hash to their "
             "names")


def _pinned_memory() -> dict:
    """Pinned host memory: the staging pool's free set, and (where this
    PyTorch reports it) what its caching host allocator holds."""
    import torch
    from repro_torch.checkpoint.hostcopy import STAGING
    out = {"staging_free_bytes": STAGING.held_bytes(),
           "staging_stats": dict(STAGING.stats)}
    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is not None:
        st = stats()
        out.update({k: st.get(f"allocated_bytes.{k}") for k in ("current", "peak")
                    if f"allocated_bytes.{k}" in st})
    return out


def _loop_summary(rep, coord, wall_s) -> dict:
    c = rep.coordinator
    return {"completed": rep.completed, "final_loss": rep.final_loss,
            "final_metrics": rep.extra["final_metrics"],
            "evictions_seen": rep.evictions_seen, "restores": rep.restores,
            "lost_steps": rep.lost_steps, "steps_executed": rep.steps_executed,
            "periodic_ckpts": c["periodic_ckpts"],
            "termination_ckpts": c["termination_ckpts"],
            "d2h_bytes": c["d2h_bytes"], "save_stall_s": c["save_stall_s"],
            "mttr_mean_s": c["mttr_mean_s"], "wall_s": wall_s,
            "urgent_saves": coord.urgent_saves,
            "pinned_host": _pinned_memory()}


def _need_variant(counted: dict, what: str, dtype: str) -> None:
    """Every flash forward, dkv and dq launch of a run went through the
    variants ``dtype`` selects (``flash_attention.VARIANTS``): bfloat16 all
    on wgmma; float32 all in 3xTF32."""
    import torch
    from repro_torch.kernels.flash_attention import VARIANTS
    for p, variant in VARIANTS[getattr(torch, dtype)].items():
        k = f"flash_attention_{p}"
        need(counted[f"{k}_{variant}"] == counted[k],
             f"{what}: {counted[f'{k}_{variant}']} of {counted[k]} {k} "
             f"launches went through the {variant} kernel")


def phase_spot_loop(cfg, dev, workdir, steps, launches, *, name="spot_loop",
                    seq_len=64, factored=False, row=False) -> dict:
    import torch
    from repro_torch.checkpoint import serialize as ser
    from repro_torch.kernels import _lib
    base, base_coord, base_wall = run_loop(cfg, dev, workdir / "base", mode="off",
                                   evict_s=None, steps=steps, seq_len=seq_len,
                                   factored=factored)
    shutil.rmtree(workdir / "base", ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    ev, ev_coord, ev_wall = run_loop(cfg, dev, workdir / "ev", mode="transparent",
                               evict_s=55.0, steps=steps, seq_len=seq_len,
                               factored=factored)
    launches[name] = dict(_lib.LAUNCHES)
    shutil.rmtree(workdir / "ev", ignore_errors=True)
    res = {"uninterrupted": _loop_summary(base, base_coord, base_wall),
           "evicted": _loop_summary(ev, ev_coord, ev_wall)}
    need(base.completed and ev.completed, "a spot loop did not complete")
    need(ev.evictions_seen >= 1 and ev.restores >= 1,
         "the evicted run saw no eviction or no restore")
    _need_urgent_chunks(name, ev_coord, launches[name])
    need(ev.lost_steps == 0, f"the evicted run lost {ev.lost_steps} steps "
                             f"(urgent saves: {ev_coord.urgent_saves})")
    need(math.isfinite(base.final_loss), "non-finite loss")
    need(ev.final_loss == base.final_loss,
         f"final loss {ev.final_loss!r} != uninterrupted {base.final_loss!r}")
    need(launches[name]["fingerprint"] > 0,
         "periodic delta saves launched no fingerprint kernel")
    need(launches[name]["fingerprint_final"] == launches[name]["fingerprint"],
         "a fingerprint call's second launch is missing")
    for k in ("flash_attention_fwd", "flash_attention_dkv",
              "flash_attention_dq"):
        need(launches[name][k] > 0, f"the train steps launched no {k} kernel")
    _need_variant(launches[name], name, "bfloat16")
    if cfg.moe is not None:
        aux = ev.extra["final_metrics"]["aux"]
        need(math.isfinite(aux) and aux > 0, f"{name}: aux loss {aux}")
        need(base.extra["final_metrics"]["aux"] == aux,
             f"{name}: aux {aux} != uninterrupted "
             f"{base.extra['final_metrics']['aux']}")
    res["config"] = {"name": cfg.name, "n_layers": cfg.n_layers,
                     "d_model": cfg.d_model, "head_dim": cfg.head_dim,
                     "batch": 2, "seq_len": seq_len,
                     "factored_second_moment": factored}
    res["launches"] = launches[name]
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if row:
        # the chunk digest's row: checked and timed on the leaves the last
        # urgent save digested, after the counts were read
        named = ser.flatten_state(ev_coord.urgent_state)
        leaves = [t for n, t in named.items()
                  if isinstance(t, torch.Tensor) and t.device.type == "cuda"
                  and ev_coord.store.urgent_digest_chunk(n, t) == CHUNK]
        res["kernel_rows"] = chunk_digest_kernel(dev, leaves)
        del named, leaves
    ev_coord.urgent_state = None
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
    res = _loop_summary(rep, coord, wall)
    need(rep.completed and rep.evictions_seen >= 1 and rep.restores >= 1,
         "the int8 loop did not complete through an eviction and a restore")
    _need_urgent_chunks("spot_loop_int8", coord, launches["spot_loop_int8"])
    need(rep.lost_steps == 0, f"the int8 loop lost {rep.lost_steps} steps")
    need(math.isfinite(rep.final_loss), "non-finite loss in the int8 loop")
    for k in ("absmax", "quantize", "dequantize", "fingerprint",
              "fingerprint_final"):
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
# phase: fleet peer exchange and elastic rescale
# ---------------------------------------------------------------------------

FLEET_STEPS = 10               # fleet_peer's train steps: periodic saves at 3, 6, 9
FLEET_MEMBERS = 3


def phase_fleet_peer(cfg, dev, workdir, launches) -> dict:
    """A trainer on the card with a delta-mode store and the device-delta
    tracker until three periodic saves have committed; its coordinator's
    warm tracker rescaled 2 -> 3 -> 2 members (``fleet_mesh_plan``,
    ``member_addressable``), then a delta save of the state with 5% of its
    blocks changed. At an eviction notice member 0 of a three-member
    ``FleetPeerExchange`` (servers on 127.0.0.1) takes the urgent save and
    seeds the survivors with the newest chunks of the latest checkpoint
    under the default 256 MiB budget. Its replacement — member 0's slot,
    with an empty local pool — restores onto the card through
    ``read_through(0, store.pool)``, streaming: every leaf bitwise equal to
    a restore from the store alone, the peer hits equal to the chunks seeded,
    the rest from the store; then again with member 1's server closed."""
    import numpy as np
    import torch
    from repro_torch.checkpoint import CheckpointStore, FleetPeerExchange
    from repro_torch.checkpoint import serialize as ser
    from repro_torch.core import (AZURE_D8S_V3, CheckpointPolicy,
                                  CostAccountant, NoEviction, ScaleSet, Signal,
                                  SimulatedMetadataService, SpotOnCoordinator,
                                  TimeModel, VirtualClock)
    from repro_torch.core.elastic import fleet_mesh_plan, member_addressable
    from repro_torch.kernels import _lib
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (SpotTrainer, TrainJob,
                                   state_template_on_device)

    class LastState(SpotOnCoordinator):
        """Keeps the state of the last step (the step is functional)."""
        state = None

        def on_step_end(self, step, state_fn, **kw):
            self.state = state_fn()
            return super().on_step_end(step, lambda: self.state, **kw)

    _lib.reset_launches()
    clock = VirtualClock()
    store = CheckpointStore(str(workdir / "fleet_store"), time_fn=clock.now,
                            retention=3)
    coord = LastState(store, CheckpointPolicy.transparent(30.0), clock,
                      time_model=TimeModel())
    pool = ScaleSet(clock=clock, schedule=NoEviction(),
                    accountant=CostAccountant(AZURE_D8S_V3),
                    provisioning_delay_s=10.0, notice_s=30.0)
    job = TrainJob(cfg=cfg, opt=AdamWConfig(total_steps=FLEET_STEPS,
                                            warmup_steps=2),
                   total_steps=FLEET_STEPS, n_stages=2, batch=2, seq_len=64)
    t0 = time.perf_counter()
    rep = SpotTrainer(job, coord, pool, clock, step_time_s=10.0,
                      max_sessions=2, device=dev).run()
    res: dict = {"train_s": time.perf_counter() - t0,
                 "periodic_ckpts": rep.coordinator["periodic_ckpts"]}
    need(rep.completed and rep.coordinator["periodic_ckpts"] >= 3,
         f"the trainer committed {rep.coordinator['periodic_ckpts']} "
         "periodic saves, not 3")
    state, step = coord.state, rep.steps_executed
    named = ser.flatten_state(state)
    state_bytes = sum(t.numel() * t.element_size() for t in named.values()
                      if isinstance(t, torch.Tensor))
    tracker = coord.delta_tracker
    # the last step's state, committed: every block moved since the last
    # periodic save (a step updates every weight and moment), so this save
    # copies the state; the tracker then holds the fingerprints of the
    # state the rescale and the next delta save see
    need(coord.save_periodic_now(step, state), "the periodic save failed")
    coord.flush()

    # elastic rescale of the warm tracker, 2 -> 3 -> 2 data-parallel
    # members: every fingerprint survives; then a delta save of the state
    # with 5% of its blocks changed copies only those
    res["rescales"] = []
    for n in (3, 2):
        plan = fleet_mesh_plan(n, model_parallel=1)
        r = coord.rescale_topology(member_addressable(plan, 0))
        need(r["dropped"] == 0 and r["kept"] > 0,
             f"rescale to {n} members kept {r['kept']}, dropped {r['dropped']}")
        res["rescales"].append({"members": n, "mesh_shape": list(plan.shape),
                                **r})
    chosen, n_tracked = _perturb(state, tracker, 0.05, np.random.default_rng(1))
    fp0 = _lib.LAUNCHES["fingerprint"]
    d0, k0 = coord.stats.d2h_bytes, coord.stats.d2h_bytes_skipped
    step += 1
    need(coord.save_periodic_now(step, state), "the delta save failed")
    coord.flush()
    delta = {"d2h_bytes": coord.stats.d2h_bytes - d0,
             "d2h_bytes_skipped": coord.stats.d2h_bytes_skipped - k0,
             "state_bytes": state_bytes,
             "fingerprint_launches": _lib.LAUNCHES["fingerprint"] - fp0,
             "dirty_blocks": sum(map(len, chosen.values())),
             "tracked_blocks": n_tracked}
    res["delta_after_rescale"] = delta
    need(delta["fingerprint_launches"] > 0,
         "the delta save after the rescale launched no fingerprint kernel")
    need(delta["d2h_bytes_skipped"] > 0
         and delta["d2h_bytes"] < state_bytes / 2,
         f"the delta save after the rescale copied {delta['d2h_bytes']} of "
         f"{state_bytes} bytes")

    # the eviction notice: member 0's urgent save, then the seeding
    exchange = FleetPeerExchange(str(workdir / "fleet_fabric"), FLEET_MEMBERS)
    try:
        md = SimulatedMetadataService(clock, "vm-fleet-0")
        coord.attach_instance(md, "vm-fleet-0")
        md.simulate_eviction()
        clock.advance(1.0)
        step += 1
        t0 = time.perf_counter()
        need(coord.on_step_end(step, lambda: state) is Signal.PREEMPTING,
             "the eviction notice was not seen")
        res["urgent_save_s"] = time.perf_counter() - t0
        res["urgent_legs"] = coord.last_urgent_legs
        need(coord.stats.termination_ckpts == 1, "the urgent save failed")
        man, reader = store.latest_valid()
        reader.close()
        need(man.step == step and man.kind == "termination",
             f"the latest checkpoint is {man.kind} step {man.step}")
        hashes = man.chunk_hashes()
        n_refs = sum(len(r.get("chunks", ())) for r in man.tensors)
        t0 = time.perf_counter()
        seed = exchange.seed_from(0, store.pool, sorted(hashes))
        res["seed"] = dict(seed, s=time.perf_counter() - t0,
                           budget_bytes=exchange.budget_bytes,
                           manifest_chunks=len(hashes), manifest_refs=n_refs,
                           manifest_bytes=sum(t["nbytes"] for t in man.tensors))
        need(0 < seed["chunks"] < len(hashes) and seed["survivors"] == 2
             and seed["bytes"] <= exchange.budget_bytes,
             f"seeding pushed {seed}")

        template = state_template_on_device(state, dev)
        t0 = time.perf_counter()
        want, man_store = store.restore(template, streaming=True)
        torch.cuda.synchronize()
        res["restore_store_s"] = time.perf_counter() - t0
        want = ser.flatten_state(want)

        def replacement(what):
            """Member 0's replacement: an empty local pool, a restore onto
            the card through its peers, then the store."""
            shutil.rmtree(exchange.members[0][0].root, ignore_errors=True)
            rcoord = SpotOnCoordinator(store, CheckpointPolicy.transparent(30.0),
                                       clock, time_model=TimeModel())
            rt = exchange.read_through(0, store.pool)
            t0 = time.perf_counter()
            got, man_rt = rcoord.restore_latest(template, chunk_pool=rt)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rcoord.close()
            need(man_rt.step == man_store.step, f"{what}: restored another step")
            got = ser.flatten_state(got)
            for n, t in want.items():
                need(same_bits(got[n], t), f"{what}: leaf {n} differs from "
                                           "the restore from the store")
            st = dict(rt.stats)
            need(st["peer_hits"] == seed["chunks"],
                 f"{what}: {st['peer_hits']} peer hits, {seed['chunks']} "
                 "chunks seeded")
            need(st["peer_hits"] + st["local_hits"] + st["store_reads"]
                 == n_refs and st["store_reads"] > 0,
                 f"{what}: {st} over {n_refs} chunk references")
            return dict(st, restore_s=wall,
                        peer_bytes=rt.client.stats["bytes_fetched"])

        res["restore_peers"] = replacement("peer restore")
        exchange.members[1][1].close()
        res["restore_peer_down"] = replacement("peer restore, member 1 down")
        del want
    finally:
        exchange.close()
        coord.close()
        shutil.rmtree(workdir / "fleet_store", ignore_errors=True)
        shutil.rmtree(workdir / "fleet_fabric", ignore_errors=True)
    launches["fleet_peer"] = dict(_lib.LAUNCHES)
    need(launches["fleet_peer"]["chunk_digest"] > 0,
         "the urgent save launched no chunk digest kernel")
    res["config"] = {"name": cfg.name, "n_layers": cfg.n_layers,
                     "d_model": cfg.d_model, "state_bytes": state_bytes,
                     "members": FLEET_MEMBERS, "batch": 2, "seq_len": 64}
    res["launches"] = launches["fleet_peer"]
    del state, named, template
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
    _need_variant(counted, "train_gemma3", "bfloat16")
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
    # the float32 path: its own counts, through the float32 kernels
    _lib.reset_launches()
    t0 = time.perf_counter()
    loss_d, _, _, grads_d = loss_and_grads(cfg32, params, tok[:, :-1],
                                           tok[:, 1:])
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches["train_gemma3_f32"] = c32 = dict(_lib.LAUNCHES)
    n_attn32 = sum(k in ("global", "local") for k in cfg32.layer_kinds())
    for k in ("flash_attention_fwd_tf32x3", "flash_attention_dkv_tf32x3",
              "flash_attention_dq_tf32x3"):
        need(c32[k] == n_attn32, f"train_gemma3 float32: {c32[k]} {k} "
                                 f"launches, expected {n_attn32}")
    _need_variant(c32, "train_gemma3 float32", "float32")
    params_h = ser.unflatten_like(params, {
        n: t.cpu() for n, t in ser.flatten_state(params).items()})
    del params
    torch.cuda.empty_cache()
    tok_h = tok.cpu()
    t0 = time.perf_counter()
    loss_h, _, _, grads_h = loss_and_grads(cfg32, params_h, tok_h[:, :-1],
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
                keep_logits=False, n_new=None, feed=None):
    """Prefill, then ``n_new`` - 1 greedy decode steps, each synchronised
    and timed, each fed the token it sampled, or with ``feed`` (B, >=
    n_new - 1, D) the next frontend embedding. Returns (tokens (B,
    n_new), prefill s, decode s, the serving state after ``keep_at`` new
    tokens, every step's logits)."""
    import torch
    n_new = n_new or NEW
    t0 = time.perf_counter()
    tok, caches, pos = prefill_fn(params, prompt)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    out, logits_all, kept, decode_s = [tok], [], None, 0.0
    for i in range(n_new - 1):
        if keep_at is not None and len(out) == keep_at:
            kept = {"caches": caches, "cursor": pos + i,
                    "generated": torch.stack(out, dim=1)}
        x = out[-1][:, None] if feed is None else feed[:, i:i + 1]
        t0 = time.perf_counter()
        tok, logits, caches = step_fn(params, x, caches, pos + i)
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
    from repro_torch.kernels import _lib
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
    # the port's kernels (csrc/*.cu), ranked or not, by name and template
    # arguments
    ours = {k.split("<")[0] for k in ptxas_summary(_lib.ptxas_report())}
    port: dict[str, float] = {}
    for e in on_dev:
        m = re.match(r"void \(anonymous namespace\)::((\w+).*)\(", e.key)
        if m and m.group(2) in ours:
            port[m.group(1)] = port.get(m.group(1), 0.0) + dev_us(e) / 1e3 / n
    return {"calls": n, "wall_ms": wall * 1e3 / n,
            "device_busy_ms": busy if busy > 0 else "not measured",
            "device_busy_share": busy / (wall * 1e3 / n) if busy > 0 else None,
            "top_device_ms": [[e.key[:80], dev_us(e) / 1e3 / n] for e in top_dev],
            "top_host_ms": [[e.key[:80], e.self_cpu_time_total / 1e3 / n]
                            for e in top_host],
            "port_kernels_ms": port}


def _cut_params(params, cfg, n_layers: int):
    """The first ``n_layers`` layers of a stacked parameter tree (each
    segment of the cut config's plan sliced from the full one's), with the
    embedding, head and final norm: views, nothing copied."""
    from repro_torch.models import plan_segments
    segs = plan_segments(cfg.scaled(n_layers=n_layers))
    out = {k: v for k, v in params.items() if k != "segments"}
    out["segments"] = [
        {pos: _slice_tree(tree, seg.n_repeats) for pos, tree in sp.items()}
        for seg, sp in zip(segs, params["segments"])]
    return out


def _slice_tree(tree, n: int):
    if isinstance(tree, dict):
        return {k: _slice_tree(v, n) for k, v in tree.items()}
    return tree[:n]


def _config_summary(cfg, params) -> dict:
    import torch
    from repro_torch.checkpoint import serialize as ser
    leaves = [t for t in ser.flatten_state(params).values()
              if isinstance(t, torch.Tensor)]
    out = {"name": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
           "head_dim": cfg.head_dim, "vocab_size": cfg.vocab_size,
           "window": cfg.window, "dtype": cfg.dtype,
           "params": sum(t.numel() for t in leaves),
           "weights_gb": sum(t.numel() * t.element_size() for t in leaves) / 1e9}
    if cfg.moe is not None:
        out["moe"] = {"n_experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k,
                      "d_expert": cfg.moe.d_expert,
                      "n_shared": cfg.moe.n_shared,
                      "capacity_factor": cfg.moe.capacity_factor,
                      "dense_prelude_layers": cfg.moe.dense_prelude_layers}
    return out


def _host_copy(params, dev):
    """The weights on the host by leaf name, and a template to load them
    back onto the card: the caller drops its device copy before the float32
    copy lands."""
    from repro_torch.checkpoint import serialize as ser
    from repro_torch.train import state_template_on_device
    return ({n: t.cpu() for n, t in ser.flatten_state(params).items()},
            state_template_on_device(params, dev))


def _teacher_forcing(what, host, template, cfg32, prompt, n_new, dev,
                     launches, *, feed=None) -> dict:
    """Decode against teacher forcing on a float32 copy of ``host``'s
    weights (emptied as the copy lands on the card): prefill ``prompt``,
    ``n_new`` - 1 greedy decode steps (fed the sampled token, or ``feed``'s
    next frame), counted under ``what``_f32 through the 3xTF32 forward
    and flash decode (the prefill's wall time kept, and with attention
    layers a second prefill's profile); every step's logits within
    LOGIT_TOL of the teacher-forced forward over the same sequence, the
    greedy tokens identical."""
    import torch
    from repro_torch.checkpoint import serialize as ser
    from repro_torch.kernels import _lib
    from repro_torch.models import forward
    from repro_torch.models.transformer import unembed_weights
    from repro_torch.serve import make_decode_step, make_prefill

    kinds = cfg32.layer_kinds()
    n_attn = sum(k in ("global", "local") for k in kinds)
    n_mamba = sum(k == "mamba" for k in kinds)
    params32 = ser.unflatten_like(template, {
        n: t.to(dev).to(torch.float32) for n, t in host.items()})
    host.clear()
    B, P = prompt.shape[:2]
    prefill_fn = make_prefill(cfg32, cache_len=min(CACHE_LEN, P + n_new),
                              device=dev)
    _lib.reset_launches()
    tok32, prefill32_s, _, _, logits32 = _decode_run(
        params32, cfg32, prefill_fn, make_decode_step(cfg32, device=dev),
        prompt, keep_logits=True, n_new=n_new, feed=feed)
    launches[f"{what}_f32"] = c32 = dict(_lib.LAUNCHES)
    for name, n in {"ssm_scan_f32": n_mamba,
                    "flash_attention_fwd_tf32x3": n_attn,
                    "decode_attention": n_attn * (n_new - 1)}.items():
        need(c32[name] == n,
             f"{what} float32: {c32[name]} {name} launches, expected {n}")
    _need_variant(c32, f"{what} float32", "float32")
    # where the copy has attention layers, one more prefill under the
    # profiler, after the counts were read: the device's busy time and the
    # float32 forward's share of it
    prefill_profile = None
    if n_attn:
        prof = _profile(lambda: prefill_fn(params32, prompt), 1)
        prefill_profile = {k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                                "port_kernels_ms")}
    with torch.no_grad():
        rest = tok32[:, :-1] if feed is None else feed[:, :n_new - 1]
        seq = torch.cat([prompt, rest], dim=1)          # (B, P + n_new - 1)
        hidden, _ = forward(params32, cfg32, seq, return_hidden=True)
        tf = hidden[:, P - 1:] @ unembed_weights(params32, cfg32)
    errs = [max_abs_err(lg, tf[:, i + 1]) for i, lg in enumerate(logits32)]
    tf_tokens = torch.argmax(tf, dim=-1).to(torch.int32)
    top2 = torch.topk(tf, 2, dim=-1).values
    out = {"max_abs_err": max(errs), "tol": LOGIT_TOL,
           "tokens_identical": bool(torch.equal(tf_tokens, tok32)),
           "min_top2_gap": float((top2[..., 0] - top2[..., 1]).min()),
           "batch": B, "prompt": P, "new_tokens": n_new,
           "n_layers": cfg32.n_layers, "prefill_s": prefill32_s,
           "prefill_profile": prefill_profile}
    need(max(errs) <= LOGIT_TOL,
         f"{what}: float32 decode logits differ from teacher forcing by "
         f"{max(errs)}")
    need(out["tokens_identical"],
         f"{what}: float32 greedy tokens differ from teacher forcing")
    del params32, hidden, tf, logits32
    torch.cuda.empty_cache()
    return out


def phase_serve(arch, dev, workdir, card, launches, *, tf_cut=None) -> dict:
    """Serve ``arch`` at its full published config. ``tf_cut`` (a dict of
    n_layers, batch, prompt, new_tokens and dropless) cuts the float32 copy
    that decode is held against teacher forcing on; each cut is printed
    under ``reduced``."""
    import dataclasses

    import torch
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.checkpoint import serialize as ser
    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.models import init_params
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
    res = {"card": card, "config": _config_summary(cfg, params),
           "batch": SERVE_B, "prompt": PROMPT, "new_tokens": NEW,
           "cache_len": CACHE_LEN, "prefill_s": prefill_s,
           "prefill_tokens_per_s": SERVE_B * PROMPT / prefill_s,
           "decode_s": decode_s,
           "decode_tokens_per_s": SERVE_B * (NEW - 1) / decode_s,
           "launches": counted,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    want = {"flash_attention_fwd": n_attn, "rglru_scan": n_rec,
            "ssm_scan": n_mamba, "ssm_scan_bf16": n_mamba,
            "decode_attention": n_attn * (NEW - 1),
            "decode_attention_merge": n_attn * (NEW - 1)}
    for name, n in want.items():
        need(counted[name] == n,
             f"{arch}: {counted[name]} {name} launches, expected {n}")
    _need_variant(counted, arch, "bfloat16")
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

    # decode against teacher forcing, on a float32 copy at the same shapes
    # (or at tf_cut's): the bf16 weights leave the card before their
    # float32 copy lands
    cut = tf_cut or {}
    cfg32 = cfg.scaled(dtype="float32", n_layers=cut.get("n_layers",
                                                         cfg.n_layers))
    b32, p32, new32 = (cut.get("batch", SERVE_B), cut.get("prompt", PROMPT),
                       cut.get("new_tokens", NEW))
    reduced = {}
    if "n_layers" in cut:
        params = _cut_params(params, cfg, cut["n_layers"])
        reduced["n_layers"] = f"{cfg.n_layers} -> {cfg32.n_layers}"
    if cut.get("dropless"):
        # a capacity of every group's token count: no (token, k) pair can
        # drop, so the routed sequence path and the dropless decode path
        # compute the same function (prefill at 1.25 drops pairs)
        m = cfg.moe
        cfg32 = cfg32.scaled(moe=dataclasses.replace(
            m, capacity_factor=m.n_experts / m.top_k))
        reduced["capacity_factor"] = (
            f"{m.capacity_factor} -> {m.n_experts}/{m.top_k}: capacity = "
            "the group's tokens, no drops")
    if (b32, p32, new32) != (SERVE_B, PROMPT, NEW):
        reduced.update(batch=f"{SERVE_B} -> {b32}",
                       prompt=f"{PROMPT} -> {p32}",
                       new_tokens=f"{NEW} -> {new32}")
    host, template = _host_copy(params, dev)
    del params
    torch.cuda.empty_cache()
    res["teacher_forcing"] = dict(_teacher_forcing(
        f"serve_{arch}", host, template, cfg32, prompt[:b32, :p32], new32,
        dev, launches), reduced=reduced)
    return res


# ---------------------------------------------------------------------------
# phase: serving an arch without token embeddings
# ---------------------------------------------------------------------------

def phase_embeds(arch, dev, card, launches) -> dict:
    """Serve ``arch`` (no token embeddings) at its full published config
    from seeded frontend embeddings: prefill EMB_PROMPT frames, then
    EMB_NEW - 1 decode steps each fed the next frame's embedding; a
    float32 copy's decode logits against its teacher-forced logits."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.models import init_params
    from repro_torch.serve import make_decode_step, make_prefill

    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch)
    need(not cfg.embed_inputs, f"{arch} takes token ids")
    n_attn = sum(k in ("global", "local") for k in cfg.layer_kinds())
    params = init_params(cfg, seed=0, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    frames = torch.randn((SERVE_B, EMB_PROMPT + EMB_NEW, cfg.d_model),
                         generator=g, device=dev)
    prompt, feed = frames[:, :EMB_PROMPT], frames[:, EMB_PROMPT:]
    cache_len = EMB_PROMPT + EMB_NEW
    prefill_fn = make_prefill(cfg, cache_len=cache_len, device=dev)
    step_fn = make_decode_step(cfg, device=dev)
    tok, caches, pos = prefill_fn(params, prompt[:, :64])     # warm-up
    step_fn(params, feed[:, :1], caches, pos)
    torch.cuda.synchronize()
    del caches

    # the main path: counts reset just before, read just after
    _lib.reset_launches()
    tokens, prefill_s, decode_s, _, _ = _decode_run(
        params, cfg, prefill_fn, step_fn, prompt, n_new=EMB_NEW, feed=feed)
    launches[f"embeds_{arch}"] = counted = dict(_lib.LAUNCHES)
    res = {"card": card, "config": _config_summary(cfg, params),
           "batch": SERVE_B, "prompt_frames": EMB_PROMPT,
           "decode_steps": EMB_NEW - 1, "prefill_s": prefill_s,
           "prefill_tokens_per_s": SERVE_B * EMB_PROMPT / prefill_s,
           "decode_s": decode_s,
           "decode_tokens_per_s": SERVE_B * (EMB_NEW - 1) / decode_s,
           "launches": counted,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    for name, n in {"flash_attention_fwd": n_attn,
                    "decode_attention": n_attn * (EMB_NEW - 1),
                    "decode_attention_merge": n_attn * (EMB_NEW - 1)}.items():
        need(counted[name] == n,
             f"{arch}: {counted[name]} {name} launches, expected {n}")
    _need_variant(counted, arch, "bfloat16")
    need(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
         f"{arch}: tokens out of range")
    _tok, caches_p, _pos = prefill_fn(params, prompt)
    res["decode_profile"] = _profile(
        lambda: step_fn(params, feed[:, :1], caches_p, EMB_PROMPT), 4)
    del caches_p

    # float32 decode against teacher forcing over the same frames
    host, template = _host_copy(params, dev)
    del params
    torch.cuda.empty_cache()
    res["teacher_forcing"] = _teacher_forcing(
        f"embeds_{arch}", host, template, cfg.scaled(dtype="float32"), prompt,
        EMB_NEW, dev, launches, feed=feed)
    return res


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase: a four-rank pod's sharded save and elastic restore on the one card
# ---------------------------------------------------------------------------

POD_CHUNK = 1 << 20
POD_WORLDS = (("save", 4, (2, 2)), ("restore", 2, (1, 2)), ("restore", 4, (4, 1)))
POD_TIMEOUT_S = 240            # each world's time limit, rendezvous included
POD_BARRIER_S = 120.0          # the ranks' time limit for a collective


def _pod_specs(cfg):
    """The phase's state: phi3-mini's parameters (published widths, the cut
    depth) in bf16 and their AdamW moments in float32, as meta specs."""
    import torch
    from repro_torch.checkpoint import serialize as ser
    from repro_torch.models import model
    params = model.param_specs(cfg)
    f32 = lambda: ser.unflatten_like(params, {
        n: torch.empty(t.shape, dtype=torch.float32, device="meta")
        for n, t in ser.flatten_state(params).items()})
    return {"params": params, "opt": {"mu": f32(), "nu": f32()}}


def _pod_leaf(i: int, name: str, spec, dev):
    """Leaf ``i`` of the seeded state, whole, on the card: every rank and
    every world makes the same values (one seed per leaf)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(1000 + i)
    x = torch.randn(spec.shape, generator=g, device=dev, dtype=torch.float32)
    if "/nu/" in f"/{name}/":
        x = x * x * 1e-6
    elif "/mu/" in f"/{name}/":
        x = x * 1e-3
    return x.to(spec.dtype)


def _pod_expected(full, name):
    """What a restore must give for a whole leaf: the leaf, or for a moment
    the dequantize of its int8 quantize with the tensor-global scale (the
    plain versions; bit-identical to the host's ``finish_payload``)."""
    import numpy as np
    from repro_torch.checkpoint import serialize as ser
    from repro_torch.kernels.quantize.ref import (dequantize_int8_ref,
                                                  quantize_with_inv_ref)
    if not ser.is_moment_name(name):
        return full
    scale, inv = ser.int8_scale_inv(np.float32(full.abs().max().item()))
    return dequantize_int8_ref(quantize_with_inv_ref(full, inv), scale,
                               dtype=full.dtype)


def _touched_chunks(rec: dict, region) -> int:
    """The chunks of one saved piece (a v2 record) whose bytes meet the
    global ``region``: the fewest that a reader of the region must decode
    from that piece, reckoned from the record alone."""
    import numpy as np
    from repro_torch.checkpoint import manifest as mf
    from repro_torch.checkpoint import serialize as ser
    pidx = [tuple(int(x) for x in p) for p in rec["index"]]
    inter = [(max(a, p0), min(b, p1)) for (a, b), (p0, p1) in zip(region, pidx)]
    if any(lo >= hi for lo, hi in inter):
        return 0
    local = [(lo - p0, hi - p0) for (lo, hi), (p0, _p1) in zip(inter, pidx)]
    shape = [p1 - p0 for p0, p1 in pidx]
    item = ser.stored_dtype(rec["dtype"],
                            ser.split_codec(rec.get("codec", "raw"))[0]).itemsize
    strides = [int(np.prod(shape[i + 1:], dtype=np.int64)) for i in range(len(shape))]
    # the region's C-order byte runs: one per index of the axes before the
    # last partially covered axis k (the axes after k are whole)
    partial = [i for i, ((a, b), n) in enumerate(zip(local, shape)) if (a, b) != (0, n)]
    k = partial[-1] if partial else 0
    lo = np.zeros(1, dtype=np.int64)
    for i in range(k):
        lo = (lo[:, None] + np.arange(*local[i], dtype=np.int64) * strides[i]).ravel()
    lo = lo + local[k][0] * strides[k]
    hi = lo + (local[k][1] - local[k][0]) * strides[k]
    offs = np.asarray(mf.chunk_byte_offsets(rec), dtype=np.int64)
    hit = np.zeros(len(offs), dtype=np.int64)       # +1 where a run's chunks
    np.add.at(hit, np.searchsorted(offs, lo * item, "right") - 1, 1)  # start,
    np.add.at(hit, np.searchsorted(offs, hi * item, "left"), -1)      # -1 past
    return int((np.cumsum(hit)[:-1] > 0).sum())


def pod_worker(args: dict) -> dict:
    """One rank of a pod world on the card (``--pod-worker``): joins the
    gloo group, then saves (the ``(2, 2)`` world: a periodic and an urgent
    save of its shards) or restores through ``elastic_restore`` onto its
    mesh, streaming, and checks its shards bit for bit. Returns its
    numbers; any failed check raises."""
    t_entry = time.time()
    import datetime
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import AsyncCheckpointer, CheckpointStore, TensorSpec
    from repro_torch.checkpoint import serialize as ser
    from repro_torch.configs import get_config
    from repro_torch.core.elastic import MeshPlan, elastic_restore, plan_mesh_for
    from repro_torch.distributed import multihost
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import _lib

    rank, world = args["rank"], args["world"]
    # from the parent's spawn: the interpreter and this script, then the
    # imports above (torch, the port)
    stamps = {"spawn_s": t_entry - args["spawned_at"],
              "import_s": time.time() - t_entry}
    t_start = time.perf_counter()
    dist.init_process_group("gloo", init_method=args["init"], rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=POD_BARRIER_S))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    waits: dict[str, float] = {}
    sync = multihost.sync_global_devices

    def timed_sync(name, group=None):  # the barrier's wait, per sync point
        t0 = time.perf_counter()
        sync(name, group)
        waits[name] = waits.get(name, 0.0) + time.perf_counter() - t0
    multihost.sync_global_devices = timed_sync
    cfg = get_config("phi3_mini_3p8b").scaled(n_layers=LAYERS)
    specs = ser.flatten_state(_pod_specs(cfg))
    if args["kind"] == "save":
        plan = MeshPlan(tuple(args["mesh"]), ("data", "model"))
    else:                              # the survivors' plan
        plan = plan_mesh_for(world, model_parallel=args["mesh"][1])
        need(plan.shape == tuple(args["mesh"]), f"planned {plan.shape}")
    mesh = plan.build()
    rules = shd.elastic_rules(mesh, fsdp=True)
    sharding = ser.flatten_state(shd.tree_shardings(_pod_specs(cfg), rules))
    store = CheckpointStore(args["root"], chunk_size=POD_CHUNK, compress=False,
                            quantize_moments=True, retention=3)
    _lib.reset_launches()
    res: dict = {"rank": rank, "world": world, "mesh": args["mesh"],
                 "start_s": time.perf_counter() - t_start, **stamps}
    timed_sync("spoton:pod_ready")
    if args["kind"] == "save":
        state, local_bytes = {}, 0
        for i, (n, spec) in enumerate(specs.items()):
            state[n] = shd.distribute(_pod_leaf(i, n, spec, dev), sharding[n])
            local_bytes += state[n].to_local().numel() * spec.element_size()
        state = ser.unflatten_like(_pod_specs(cfg), state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        periodic = store.save(10, state)
        res["periodic_save_s"] = time.perf_counter() - t0
        ac = AsyncCheckpointer(store)
        t0 = time.perf_counter()
        urgent = ac.save_urgent(11, state, timeout_s=POD_BARRIER_S)
        res["urgent_save_s"] = time.perf_counter() - t0
        ac.close()
        res.update(local_bytes=local_bytes, periodic_nbytes=periodic.nbytes,
                   urgent_nbytes=urgent.nbytes, urgent_legs=urgent.legs)
        res["launches"] = dict(_lib.LAUNCHES)
        # the stored int8 payloads against a host quantize of each whole
        # moment (the ranks split the leaves)
        man, reader = store.latest_valid()
        need(man.step == 11 and man.kind == "termination",
             f"the latest save is step {man.step} ({man.kind})")
        checked = 0
        for i, (n, spec) in enumerate(specs.items()):
            if not ser.is_moment_name(n) or i % world != rank:
                continue
            whole = tuple((0, s) for s in spec.shape)
            got, _dt, quant, scale = reader.read_region_payload(n, whole)
            q, want_scale = ser.quantize(ser.to_host(_pod_leaf(i, n, spec, dev)),
                                         "int8", "float32")
            need(quant == "int8" and np.float32(scale) == np.float32(want_scale)
                 and np.array_equal(got, q),
                 f"{n}: the stored int8 payload differs from a host quantize "
                 "of the whole tensor")
            checked += 1
        res["int8_leaves_checked"] = checked
        del state
    else:
        template = lambda m: ser.unflatten_like(_pod_specs(cfg), {
            n: TensorSpec(tuple(spec.shape), spec.dtype, dev, m,
                          sharding[n].placements)
            for n, spec in specs.items()})
        t0 = time.perf_counter()
        got, man = elastic_restore(store, template, mesh, streaming=True)
        res["restore_s"] = time.perf_counter() - t0
        res["launches"] = dict(_lib.LAUNCHES)
        need(man.step == 11 and man.kind == "termination",
             f"restored step {man.step} ({man.kind})")
        st = dict(store.last_region_stats)
        res["region_stats"] = st
        local_bytes = 0
        named = ser.flatten_state(got)
        records: dict[str, list] = {}
        for rec in man.tensors:
            records.setdefault(rec["name"].rsplit("#", 1)[0], []).append(rec)
        res["chunks_total"] = sum(len(r["chunks"]) for r in man.tensors)
        res["chunks_needed"] = 0
        for i, (n, spec) in enumerate(specs.items()):
            t = named[n]
            need(isinstance(t, torch.distributed.tensor.DTensor)
                 and tuple(t.shape) == tuple(spec.shape)
                 and t.to_local().device == dev, f"{n}: not a DTensor on the card")
            (region,) = shd.addressable_shard_spans(mesh, t.placements, spec.shape)
            res["chunks_needed"] += sum(_touched_chunks(r, region)
                                        for r in records[n])
            want = _pod_expected(_pod_leaf(i, n, spec, dev), n)
            want = want[tuple(slice(a, b) for a, b in region)]
            local = t.to_local()
            need(local.shape == want.shape and torch.equal(
                local.view(torch.int16) if local.dtype == torch.bfloat16 else
                local.view(torch.int32), want.contiguous().view(
                    torch.int16 if want.dtype == torch.bfloat16 else torch.int32)),
                 f"{n}: restored shard {region} differs from the seeded state")
            local_bytes += local.numel() * local.element_size()
        res["local_bytes"] = local_bytes
        res["chunk_bytes_decoded"] = st["chunks_decoded"] * POD_CHUNK
        del got, named
    res["barrier_wait_s"] = waits
    res["wall_s"] = time.perf_counter() - t_start
    dist.destroy_process_group()
    res["done_at"] = time.time()
    return res


def _run_world(kind, world, mesh, root, workdir, tag) -> list[dict]:
    """Start ``world`` ranks of ``pod_worker`` on the card, each a process
    of this script, and collect their results. A rank that fails, or a
    world past its time limit, fails the phase; every rank is stopped."""
    init = f"file://{workdir / f'rdv_{tag}'}"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs = []
    for r in range(world):
        spec = json.dumps({"rank": r, "world": world, "mesh": list(mesh),
                           "kind": kind, "root": str(root), "init": init,
                           "spawned_at": time.time()})
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--pod-worker", spec],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env))
    deadline = time.monotonic() + POD_TIMEOUT_S
    outs = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                raise PhaseError(f"{tag}: a rank passed the {POD_TIMEOUT_S} s limit")
            outs.append((p.returncode, out, err, time.time()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, (rc, out, err, reaped) in enumerate(outs):
        if rc != 0:
            print(err[-4000:], file=sys.stderr)
            raise PhaseError(f"{tag}: rank {r} exited {rc}")
        results.append(json.loads(out.strip().splitlines()[-1]))
        # from the rank's last result to its exit being seen here
        results[-1]["exit_s"] = reaped - results[-1].pop("done_at")
    return results


def phase_pod_restore(cfg, dev, workdir, launches) -> dict:
    """Four ranks on a ``(2, 2)`` ``("data", "model")`` mesh hold phi3-mini's
    published-width state (the cut depth) under ``tree_shardings`` of
    ``elastic_rules(fsdp=True)`` and take a periodic and an urgent save
    (absmax and quantize on the local shards, with the all-reduced scale).
    Two are evicted: a world of 2 ranks restores onto ``(1, 2)``, then a
    world of 4 onto ``(4, 1)``, each through ``elastic_restore``, streaming
    (only its regions decoded, int8 regions widened on the card). Every
    rank's shards are held to the seeded state bit for bit, and to the
    dequantize of a whole-tensor quantize for the moments."""
    from repro_torch.checkpoint import serialize as ser
    work = workdir / "pod"
    work.mkdir(parents=True, exist_ok=True)
    specs = ser.flatten_state(_pod_specs(cfg))
    res: dict = {"config": {"name": cfg.name, "n_layers": cfg.n_layers,
                            "d_model": cfg.d_model, "chunk": POD_CHUNK,
                            "param_gb": sum(s.numel() * s.element_size()
                                            for n, s in specs.items()
                                            if n.startswith("params/")) / 1e9,
                            "moment_gb": sum(s.numel() * s.element_size()
                                             for n, s in specs.items()
                                             if not n.startswith("params/")) / 1e9},
                 "worlds": []}
    total = {}
    for i, (kind, world, mesh) in enumerate(POD_WORLDS):
        t0 = time.perf_counter()
        ranks = _run_world(kind, world, mesh, work / "store", work, f"w{i}")
        res["worlds"].append({"kind": kind, "world": world, "mesh": list(mesh),
                              "wall_s": time.perf_counter() - t0, "ranks": ranks})
        for r in ranks:
            for k, v in r["launches"].items():
                total[k] = total.get(k, 0) + v
    launches["pod_restore"] = total
    for k in ("absmax", "quantize", "dequantize"):
        need(total.get(k, 0) > 0, f"the pod worlds launched no {k} kernel")
    save = res["worlds"][0]["ranks"]
    need(sum(r["int8_leaves_checked"] for r in save)
         == sum(ser.is_moment_name(n) for n in specs),
         "not every moment's int8 payload was checked")
    stored = sum(s.numel() * (1 if ser.is_moment_name(n) else s.element_size())
                 for n, s in specs.items())
    for w in res["worlds"][1:]:
        for r in w["ranks"]:
            st = r["region_stats"]
            chunks = st["chunks_decoded"] + st["chunks_skipped"]
            share = chunks / w["world"]
            r["decoded_of_share"] = st["chunks_decoded"] / share
            r["chunk_bytes_decoded_of_state"] = r["chunk_bytes_decoded"] / stored
            need(st["chunks_skipped"] > 0,
                 f"{w['mesh']} rank {r['rank']} skipped no chunk: {st}")
            # O(shard): exactly the chunks the rank's regions touch, each
            # once, and every other chunk of the state skipped
            need(st["chunks_decoded"] == r["chunks_needed"]
                 and chunks == r["chunks_total"],
                 f"{w['mesh']} rank {r['rank']} decoded {st['chunks_decoded']} "
                 f"and skipped {st['chunks_skipped']} chunks; its regions "
                 f"touch {r['chunks_needed']} of {r['chunks_total']}")
    res["launches"] = total
    res["stored_bytes"] = stored
    shutil.rmtree(work, ignore_errors=True)
    return res


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
        key = f"{names[0]}<{','.join([dtype, *ints])}>"
        while key in out:      # instances told apart by a type argument only
            key += "'"
        out[key] = info
    return out


KERNELS = {
    # no TPU kernel: the host digests of every chunk a save writes (the
    # reference's chunk_digest and store_chunk's zlib.crc32), moved onto
    # the card for urgent saves
    "chunk_digest": ("src/repro_torch/kernels/csrc/chunk_digest.cu",
                     "src/repro/checkpoint/chunkstore.py:105"),
    "fingerprint": ("src/repro_torch/kernels/csrc/fingerprint.cu",
                    "src/repro/kernels/fingerprint/fingerprint.py:30"),
    # the fingerprint's second launch: each block's slice sums to its digest
    # and diff, the reference kernel's finalize of its block sum
    "fingerprint_final": ("src/repro_torch/kernels/csrc/fingerprint.cu",
                          "src/repro/kernels/fingerprint/fingerprint.py:30"),
    "absmax": ("src/repro_torch/kernels/csrc/quantize.cu",
               "src/repro/kernels/quantize/quantize.py:38"),
    "quantize": ("src/repro_torch/kernels/csrc/quantize.cu",
                 "src/repro/kernels/quantize/quantize.py:53"),
    "dequantize": ("src/repro_torch/kernels/csrc/quantize.cu",
                   "src/repro/kernels/quantize/quantize.py:62"),
    # rows 5, 6 and 7 have two variants, chosen by dtype, both on the
    # tensor cores: bfloat16 through wgmma, float32 in 3xTF32 (mma.sync)
    "flash_attention_fwd_wgmma": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:65"),
    "flash_attention_fwd_tf32x3": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:65"),
    "flash_attention_dkv_wgmma": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:156"),
    "flash_attention_dkv_tf32x3": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:156"),
    "flash_attention_dq_wgmma": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:201"),
    "flash_attention_dq_tf32x3": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:201"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention/decode_attention.py:30"),
    # flash decode's second launch: the split pass's partials merged, the
    # reference kernel's finalize across its key blocks
    "decode_attention_merge": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/decode_attention.py:30"),
    # the scan's two instances: bfloat16 (the serving path) and float32
    # (the teacher-forced copy)
    "ssm_scan_bf16": ("src/repro_torch/kernels/csrc/ssm_scan.cu",
                      "src/repro/kernels/ssm_scan/ssm_scan.py:36"),
    "ssm_scan_f32": ("src/repro_torch/kernels/csrc/ssm_scan.cu",
                     "src/repro/kernels/ssm_scan/ssm_scan.py:36"),
    "rglru_scan": ("src/repro_torch/kernels/csrc/rglru_scan.cu",
                   "src/repro/kernels/rglru_scan/rglru_scan.py:31"),
}


# rows made by another phase than ``kernels``: the chunk digest is checked
# and timed on the leaves of the spot loop's urgent save
KERNEL_ROW_PHASE = {"chunk_digest": "spot_loop"}


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
    tc_smem = {f"{p}_hd{hd}": getattr(lib, f"spot_flash_attention_{p}_wgmma_smem")(hd)
               for p in ("fwd", "dkv", "dq") for hd in _lib.HEAD_DIMS}
    tc_smem.update({
        f"{p}_tf32x3_hd{hd}": getattr(lib, f"spot_flash_attention_{p}_tf32x3_smem")(hd)
        for p in ("fwd", "dkv", "dq") for hd in _lib.HEAD_DIMS})
    print(json.dumps({"ptxas": ptxas, "tensor_core_dynamic_smem": tc_smem,
                      "ptxas_warnings": _lib.ptxas_warnings()}), flush=True)
    cfg = get_config("phi3_mini_3p8b").scaled(n_layers=LAYERS)
    launches: dict[str, dict] = {}
    results: dict = {"card": card, "build_s": _lib.build_seconds(),
                     "ptxas": ptxas, "tensor_core_dynamic_smem": tc_smem,
                     "config": {"name": cfg.name, "n_layers": cfg.n_layers,
                                "d_model": cfg.d_model}}
    (ROOT / "build").mkdir(exist_ok=True)
    failed = []
    seconds: dict[str, float] = {}
    t_run = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build",
                                     prefix="chip_smoke_") as tmp:
        workdir = Path(tmp)
        phases = {
            "kernels": lambda: phase_kernels(cfg, dev),
            "delta": lambda: phase_delta(cfg, dev, workdir),
            "spot_loop": lambda: phase_spot_loop(cfg, dev, workdir, STEPS,
                                                 launches, row=True),
            "spot_loop_int8": lambda: phase_spot_loop_int8(
                cfg, dev, workdir, STEPS, launches),
            "fleet_peer": lambda: phase_fleet_peer(cfg, dev, workdir,
                                                   launches),
            "pod_restore": lambda: phase_pod_restore(cfg, dev, workdir,
                                                     launches),
            "train_gemma3": lambda: phase_train_gemma3(dev, card, launches),
            "spot_loop_gemma3": lambda: phase_spot_loop(
                get_config("gemma3_1b").scaled(n_layers=LOOP_LAYERS), dev,
                workdir / "gemma3", STEPS, launches, name="spot_loop_gemma3",
                seq_len=LOOP_S),
            "serve_gemma3": lambda: phase_serve("gemma3_1b", dev, workdir,
                                                card, launches),
            "serve_recurrentgemma": lambda: phase_serve(
                "recurrentgemma_2b", dev, workdir, card, launches),
            "serve_phi3": lambda: phase_serve("phi3_mini_3p8b", dev, workdir,
                                              card, launches),
            "serve_falcon_mamba": lambda: phase_serve(
                "falcon_mamba_7b", dev, workdir, card, launches),
            # the rest of the zoo: an MoE model at full width (its float32
            # teacher-forcing copy cut to the prelude and two MoE layers,
            # routed without drops), a dense GQA-4 model with an ungated
            # squared-ReLU MLP, the MoE backward with the factored second
            # moment through the spot loops, and an arch fed frontend
            # embeddings
            "serve_deepseek_moe": lambda: phase_serve(
                "deepseek_moe_16b", dev, workdir, card, launches,
                tf_cut=MOE_TF_CUT),
            "serve_minitron": lambda: phase_serve(
                "minitron_8b", dev, workdir, card, launches),
            "spot_loop_moe": lambda: phase_spot_loop(
                get_config("deepseek_moe_16b").scaled(n_layers=MOE_LOOP_LAYERS),
                dev, workdir / "moe", STEPS, launches, name="spot_loop_moe",
                seq_len=LOOP_S, factored=True),
            "embeds_musicgen": lambda: phase_embeds(
                "musicgen_medium", dev, card, launches),
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
            seconds[phase] = time.perf_counter() - t0
            print(f"phase {phase}: {status} ({seconds[phase]:.1f} s)",
                  flush=True)
            if phase in results:
                print(json.dumps({"phase": phase, "results": results[phase],
                                  "card": card}, default=float), flush=True)
    results["phase_seconds"] = seconds
    results["phases_total_s"] = time.perf_counter() - t_run
    print(json.dumps({"phase_seconds": seconds,
                      "phases_total_s": results["phases_total_s"],
                      "build_s": _lib.build_seconds()}), flush=True)
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
        k = (results[KERNEL_ROW_PHASE[name]]["kernel_rows"]
             if name in KERNEL_ROW_PHASE else results["kernels"])[name]
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
    if sys.argv[1:2] == ["--pod-worker"]:
        print(json.dumps(pod_worker(json.loads(sys.argv[2])), default=float))
        sys.exit(0)
    sys.exit(main())
