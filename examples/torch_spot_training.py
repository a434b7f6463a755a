"""End to end on the PyTorch port: train a ~100M-param model under
Spot-on on one CUDA GPU, in REAL time, with a real mid-run eviction
triggered through the chosen cloud's metadata API (Azure Scheduled Events
by default; ``--provider aws|gcp`` exercises the IMDS / GCE-metadata
backends) — then verify the run completes, rode out the eviction without
losing a step, and the loss went down.

    PYTHONPATH=src python examples/torch_spot_training.py [--steps 120] [--provider azure]
    PYTHONPATH=src python examples/torch_spot_training.py --device cpu --model smoke \\
        --steps 40

The twin of ``examples/spot_training.py`` through ``repro_torch``. The
reference fires its eviction 30 s into the run, which a card passes long
before; here it fires once the run reaches a third of ``--steps``, and the
provider's notice (30 s) is ridden out in wall time.
``--model smoke`` trains phi3-mini's smoke config instead, for a CPU run.
"""

import argparse
import math
import tempfile
import time

from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import get_smoke_config
from repro_torch.core import (CheckpointPolicy, NoEviction, SpotOnCoordinator,
                              WallClock, get_provider)
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig
from repro_torch.train import SpotTrainer, TrainJob


def hundred_m_config() -> ModelConfig:
    """~100M-param dense decoder (real weights)."""
    base = get_smoke_config("phi3-mini-3.8b")
    return base.scaled(n_layers=10, d_model=640, n_heads=10, n_kv_heads=10,
                       head_dim=64, d_ff=2560, vocab_size=32064)


class EvictingCoordinator(SpotOnCoordinator):
    """Mid-run, simulate a real spot eviction through the metadata service:
    once the run reaches ``evict_at``, the pool's running instance announces
    its preemption, which the coordinator then polls like any notice."""

    def __init__(self, *a, pool, evict_at: int, **kw):
        super().__init__(*a, **kw)
        self._pool, self._evict_at = pool, evict_at
        self.evicted_at_step = None

    def on_step_end(self, step, state_provider, step_duration_s=None):
        inst = self._pool.current
        if self.evicted_at_step is None and step >= self._evict_at \
                and inst is not None and inst.alive:
            print(f">>> simulate-eviction issued at step {step} "
                  f"({self.provider.name}, {self.provider.notice_s:.0f}s "
                  f"notice)", flush=True)
            inst.announce_preemption(notice_s=30.0)
            self.evicted_at_step = step
        return super().on_step_end(step, state_provider,
                                   step_duration_s=step_duration_s)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--provider", default="azure",
                    choices=("azure", "aws", "gcp"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--model", default="100m", choices=("100m", "smoke"))
    args = ap.parse_args()

    clock = WallClock()
    prov = get_provider(args.provider)
    pool = prov.make_pool(clock, NoEviction(), provisioning_delay_s=1.0,
                          notice_s=30.0)
    cfg = hundred_m_config() if args.model == "100m" \
        else get_smoke_config("phi3-mini-3.8b")
    print(f"model: {cfg.name}-derived, {cfg.param_count()/1e6:.1f}M params, "
          f"on {args.device}")
    job = TrainJob(cfg=cfg, opt=AdamWConfig(total_steps=args.steps,
                                            warmup_steps=10, peak_lr=1e-3),
                   total_steps=args.steps, n_stages=3, batch=4, seq_len=128)
    with tempfile.TemporaryDirectory(prefix="spoton_e2e_") as root:
        coord = EvictingCoordinator(
            CheckpointStore(root), CheckpointPolicy.transparent(20.0), clock,
            provider=prov, pool=pool,
            evict_at=max(1, args.steps // 3))
        trainer = SpotTrainer(job, coord, pool, clock, device=args.device)
        t0 = time.time()
        try:
            report = trainer.run()
        finally:
            coord.close()

    floor = math.log(cfg.vocab_size) - 0.2
    print(f"completed:          {report.completed}")
    print(f"wall time:          {time.time()-t0:.1f}s")
    print(f"steps executed:     {report.steps_executed}")
    print(f"urgent saves:       {report.coordinator['termination_ckpts']}")
    print(f"restores:           {report.restores}")
    print(f"lost steps:         {report.lost_steps}")
    print(f"final loss:         {report.final_loss:.4f} "
          f"(ln vocab - 0.2 = {floor:.4f})")
    assert report.completed
    # the announced eviction was caught: an urgent save, then a restore
    assert report.coordinator["termination_ckpts"] >= 1
    assert report.restores >= 1
    assert report.lost_steps == 0
    assert report.final_loss < floor, \
        f"loss should drop from ~ln({cfg.vocab_size})={math.log(cfg.vocab_size):.1f}"
    print("OK")


if __name__ == "__main__":
    main()
