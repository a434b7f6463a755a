#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU.

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, holds
each against its plain PyTorch version bit-for-bit at the main path's
shapes (and times both), then drives the Spot-on loop through the entry
points a user calls, at phi3-mini's published width cut to a few layers:

  kernels         fingerprint / absmax / quantize / dequantize vs plain
  delta           delta saves of the full-width state at 1% and 5% block
                  churn: exact d2h accounting, bit-identical restore
  spot_loop       transparent policy, one eviction: bitwise-equal final loss
                  against an uninterrupted run
  spot_loop_int8  the same on a quantize_moments store: the urgent save
                  quantizes the moments on the device, the restore widens
                  them there, bit-identical to the host dequantize

Launch counts are reset just before each loop and read just after it; every
kernel must have launched on the main path. Prints the card's name and power
limit, one ``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``. Exits non-zero, without that line, if any
phase fails or no GPU is present.

    python3 chip_smoke.py
"""

from __future__ import annotations

import os

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import json
import math
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
CHUNK = 1 << 20
LAYERS = 2                     # phi3-mini at full width, cut in depth
STEPS = 8                      # train steps of each spot loop


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
    windows. Every operand here exceeds the 50 MB L2, so each call reads
    from device memory."""
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


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    """Least time the card could take (ms): the larger of the bytes moved
    over the memory rate and the operations over the 32-bit non-tensor-core
    rate, and which of the two it is."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = ops / OPS32_PER_S * 1e3
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

def run_loop(cfg, dev, root, *, mode, evict_s, steps, quantize_moments=False):
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
                   total_steps=steps, n_stages=2, batch=2, seq_len=64)
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


def phase_spot_loop(cfg, dev, workdir, steps, launches) -> dict:
    import torch
    from repro_torch.kernels import _lib
    base, _c, base_wall = run_loop(cfg, dev, workdir / "base", mode="off",
                                   evict_s=None, steps=steps)
    _lib.reset_launches()
    ev, _c, ev_wall = run_loop(cfg, dev, workdir / "ev", mode="transparent",
                               evict_s=55.0, steps=steps)
    launches["spot_loop"] = dict(_lib.LAUNCHES)
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
    need(launches["spot_loop"]["fingerprint"] > 0,
         "periodic delta saves launched no fingerprint kernel")
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

KERNELS = {
    "fingerprint": ("src/repro_torch/kernels/csrc/fingerprint.cu",
                    "src/repro/kernels/fingerprint/fingerprint.py:30"),
    "absmax": ("src/repro_torch/kernels/csrc/quantize.cu",
               "src/repro/kernels/quantize/quantize.py:38"),
    "quantize": ("src/repro_torch/kernels/csrc/quantize.cu",
                 "src/repro/kernels/quantize/quantize.py:53"),
    "dequantize": ("src/repro_torch/kernels/csrc/quantize.cu",
                   "src/repro/kernels/quantize/quantize.py:62"),
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
    cfg = get_config("phi3_mini_3p8b").scaled(n_layers=LAYERS)
    launches: dict[str, dict] = {}
    results: dict = {"card": card, "build_s": _lib.build_seconds(),
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
                print(json.dumps({phase: results[phase]}, default=float),
                      flush=True)
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
                     "bit_exact": True,      # the kernels phase passed
                     "max_abs_err": k["max_abs_err"],
                     # "ms" is the chip-check line's key, "kernel_ms" the
                     # name the port's notes use; one measurement
                     "ms": k["ms"], "kernel_ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound"][0],
                     "bound_by": k["bound"][1], "library_ms": k["library_ms"],
                     "shape": k["shape"], "dtype": k["dtype"]})
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
