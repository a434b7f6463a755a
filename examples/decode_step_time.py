#!/usr/bin/env python3
"""Wall time of gemma3-1b's decode step on one CUDA GPU, for comparing two
source trees of the port in one run.

Serves gemma3-1b at its full published config with seeded weights: a
prefill of batch 4 x 1984 tokens into caches with room for every step
that follows, then ``--steps``
greedy decode steps through ``serve.make_decode_step``, each timed on the
host's clock with the device synchronised after it (the step is
host-bound, so this is its host time); the median after ``--warmup``
steps, and the device busy time of a few steps under ``torch.profiler``.
The package comes from ``PYTHONPATH``, so the same script times any tree:

    PYTHONPATH=<tree>/src python examples/decode_step_time.py --tag <name>

Prints one JSON line: the tag, the card's name and power limit
(``nvidia-smi``), the step times in ms and the kernel launches a step.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--profiled", type=int, default=5)
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.device import set_deterministic
    from repro_torch.kernels import _lib
    from repro_torch.models import init_params
    from repro_torch.serve.serve_step import make_decode_step, make_prefill

    set_deterministic()
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    _lib.library()
    cfg = get_config("gemma3_1b")
    params = init_params(cfg, seed=0, device=dev)
    B, S = 4, 1984
    L = S + args.warmup + args.steps + args.profiled
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                           device=dev, dtype=torch.int32)
    tok, caches, pos = make_prefill(cfg, cache_len=L, device=dev)(params,
                                                                  prompt)
    step = make_decode_step(cfg, device=dev)
    times = []
    for i in range(args.warmup + args.steps):
        if i == args.warmup:
            _lib.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, _, caches = step(params, tok[:, None], caches, pos + i)
        torch.cuda.synchronize()
        if i >= args.warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    launches = {k: v / args.steps for k, v in _lib.LAUNCHES.items() if v}
    base = pos + args.warmup + args.steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(args.profiled):
            tok, _, caches = step(params, tok[:, None], caches, base + i)
        torch.cuda.synchronize()
    busy = sum(getattr(e, "self_device_time_total", 0.0)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / args.profiled
    print(json.dumps({
        "tag": args.tag, "package": os.path.dirname(repro_torch.__file__),
        "card": card, "steps": args.steps,
        "median_step_ms": statistics.median(times),
        "mean_step_ms": statistics.fmean(times),
        "min_step_ms": min(times), "max_step_ms": max(times),
        "device_busy_ms": busy if busy > 0 else "not measured",
        "launches_per_step": launches}))


if __name__ == "__main__":
    main()
