"""Production training entrypoint: Spot-on-protected training of any assigned
architecture, on the GPU unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch gemma3-1b --steps 200 --ckpt-dir /nfs/ckpts \
        --compile-cache-dir /nfs/ckpts/kernels --remat full --microbatches 4 \
        --mode transparent --interval 300 --simulate-eviction-every 3600

``--smoke`` selects the reduced config; with ``--device cpu`` the whole
eviction -> termination-checkpoint -> restore loop runs on the CPU through
the kernels' plain versions. Every flag and default is the reference's
(``repro.launch.train``), and ``--device`` is added. The port's only
compile step is ``nvcc``'s build of the kernel library, so
``--compile-cache-dir`` holds that library: a replacement instance loads it
from the checkpoint volume instead of building it before its first step.
Prints a ``{"kernel_library": ...}`` line (where it was loaded from,
whether this process built it, the seconds it took), then the run's
summary as the last output: the reference's keys, then the device, the
remat mode and microbatches, each urgent save (step, notice budget, wall
seconds, committed, legs) and each kernel's launches. Exits 0 only if the run
completed.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

from ..models.transformer import REMAT_MODES

# compile-cache retention knobs: same shape as the checkpoint store's sweep
# (age gate first, then a size budget), tuned for a shared volume that many
# fleet members write kernel libraries into
CACHE_GC_MAX_BYTES = 2 << 30          # 2 GiB of cached libraries
CACHE_GC_MAX_AGE_S = 14 * 86400       # entries idle two weeks are dead weight
CACHE_GC_MIN_INTERVAL_S = 300.0       # walk the dir at most once per 5 min

_last_cache_gc = 0.0


def sweep_compilation_cache(cache_dir: str, *,
                            max_bytes: int = CACHE_GC_MAX_BYTES,
                            max_age_s: float = CACHE_GC_MAX_AGE_S,
                            min_interval_s: float = CACHE_GC_MIN_INTERVAL_S,
                            ) -> int:
    """Size/age-gated gc of the compile cache directory.

    The cache dir on the shared checkpoint volume grows without bound: every
    change to a kernel source or the build flags adds a library, and nothing
    removes the old ones. Retention mirrors the checkpoint store's pool
    sweep: regular files past the age gate go first (``kernels._lib``
    refreshes a library's mtime on each load, so "old" means *unused*), then
    the oldest beyond the size budget. Runs opportunistically after
    checkpoint commits (``CheckpointStore.post_commit``) and rate-limits
    itself so the directory walk never becomes a per-save cost. Best-effort
    throughout — a janitor must never fail a save. Returns bytes removed.
    """
    import stat as stat_mod

    global _last_cache_gc
    now = time.time()
    if min_interval_s > 0 and now - _last_cache_gc < min_interval_s:
        return 0
    _last_cache_gc = now
    entries = []       # (mtime, size, path)
    try:
        for name in os.listdir(cache_dir):
            path = os.path.join(cache_dir, name)
            try:
                st = os.stat(path)
            except OSError:
                continue
            if stat_mod.S_ISREG(st.st_mode):   # one stat per entry, no TOCTOU
                entries.append((st.st_mtime, st.st_size, path))
    except OSError:
        return 0
    removed = 0

    def _rm(size: int, path: str) -> int:
        try:
            os.remove(path)
            return size
        except OSError:
            return 0

    entries.sort()                      # oldest first
    kept = []
    for mtime, size, path in entries:
        if now - mtime > max_age_s:
            removed += _rm(size, path)
        else:
            kept.append((mtime, size, path))
    total = sum(size for _, size, _ in kept)
    for mtime, size, path in kept:      # oldest-first until under budget
        if total <= max_bytes:
            break
        removed += _rm(size, path)
        total -= size
    return removed


def setup_compilation_cache(cache_dir: str) -> bool:
    """Build and load the kernel library in a directory that survives
    instance replacement (the checkpoint volume is the natural home).

    This is the compile leg of the fast-resume pipeline: a replacement
    instance loads the library a fleet member built instead of running
    ``nvcc`` inside its recovery time. Returns False when the library is
    already loaded from elsewhere or the directory cannot be made."""
    from ..kernels import _lib

    try:
        os.makedirs(cache_dir, exist_ok=True)
        _lib.set_build_dir(cache_dir)
        return True
    except (OSError, RuntimeError):
        return False


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--stages", type=int, default=5)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "spoton_ckpts"))
    ap.add_argument("--mode", choices=["off", "application", "transparent"],
                    default="transparent")
    ap.add_argument("--interval", type=float, default=60.0,
                    help="periodic transparent-checkpoint interval (s)")
    ap.add_argument("--simulate-eviction-every", type=float, default=0.0,
                    help="inject an eviction every N seconds (0 = none)")
    ap.add_argument("--provision-delay", type=float, default=5.0)
    ap.add_argument("--quantize-moments", type=int, default=0)
    ap.add_argument("--compile-cache-dir", default="",
                    help="where the kernel library is built and loaded "
                         "(e.g. a dir on the checkpoint volume); empty "
                         "keeps it in the repo's build/")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--remat", default="none", choices=REMAT_MODES)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    if args.compile_cache_dir and \
            not setup_compilation_cache(args.compile_cache_dir):
        ap.error(f"--compile-cache-dir {args.compile_cache_dir}: cannot "
                 "build the kernel library there")

    from ..checkpoint import CheckpointStore
    from ..configs import get_config, get_smoke_config
    from ..core import (AZURE_D8S_V3, CheckpointPolicy, CostAccountant,
                        NoEviction, PeriodicEviction, ScaleSet,
                        SpotOnCoordinator, StragglerDetector, WallClock)
    from ..device import resolve_device
    from ..kernels import _lib
    from ..optim import AdamWConfig
    from ..train import SpotTrainer, TrainJob

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    clock = WallClock()
    accountant = CostAccountant(AZURE_D8S_V3)
    schedule = PeriodicEviction(args.simulate_eviction_every) \
        if args.simulate_eviction_every else NoEviction()
    pool = ScaleSet(clock=clock, schedule=schedule, accountant=accountant,
                    provisioning_delay_s=args.provision_delay)
    store = CheckpointStore(args.ckpt_dir,
                            quantize_moments=bool(args.quantize_moments))
    if args.compile_cache_dir:
        # cache hygiene rides the checkpoint cadence: after each commit the
        # (rate-limited) sweep keeps the shared cache dir inside its
        # size/age budget — off the save's critical path, never fatal
        store.post_commit.append(
            lambda d=args.compile_cache_dir: sweep_compilation_cache(d))
    policy = {
        "off": CheckpointPolicy.off(),
        "application": CheckpointPolicy.application(),
        "transparent": CheckpointPolicy.transparent(args.interval),
    }[args.mode]
    coord = SpotOnCoordinator(store, policy, clock,
                              straggler=StragglerDetector())
    job = TrainJob(cfg=cfg, opt=AdamWConfig(total_steps=args.steps),
                   total_steps=args.steps, n_stages=args.stages,
                   batch=args.batch, seq_len=args.seq_len, seed=args.seed,
                   remat=args.remat, microbatches=args.microbatches)
    trainer = SpotTrainer(job, coord, pool, clock, device=device)
    # SpotTrainer built or loaded the kernel library on a GPU
    print(json.dumps({"kernel_library": {
        "dir": str(_lib.build_dir()), "built": _lib.built(),
        "seconds": _lib.build_seconds()}}), flush=True)
    _lib.reset_launches()
    report = trainer.run()
    coord.close()
    summary = {
        "arch": cfg.name, "completed": report.completed,
        "total_time_s": round(report.total_time_s, 2),
        "final_loss": report.final_loss,
        "steps_executed": report.steps_executed,
        "lost_steps": report.lost_steps,
        "restores": report.restores,
        "instances_used": report.instances_used,
        "evictions": report.evictions_seen,
        "coordinator": report.coordinator,
        "cost": accountant.summary(clock.now()),
        "device": str(device), "remat": args.remat,
        "microbatches": args.microbatches,
        "urgent_saves": coord.urgent_saves,
        # each kernel's launches in the run (none on the CPU)
        "launches": dict(_lib.LAUNCHES),
    }
    print(json.dumps(summary, indent=1))
    return 0 if report.completed else 1


if __name__ == "__main__":
    raise SystemExit(main())
