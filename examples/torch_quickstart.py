"""Quickstart on the PyTorch port: train a small model with Spot-on
protection on one CUDA GPU, survive simulated evictions, and verify the
restored run continues bit-exactly.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu] [--steps 240]

The twin of ``examples/quickstart.py`` through ``repro_torch``: the same
pool (an eviction every 20 virtual minutes), policy and reduced gemma3-1b
(its head dim 64, the smallest the card's attention kernels are built
for), on the card unless ``--device cpu`` is given. The evicted run's final loss
is held bit for bit against an uninterrupted run of the same job (without
checkpoints). A step is 10 virtual seconds: ``--steps`` must reach past
the first eviction (``--evict-every``, default 1200 s).
"""

import argparse
import tempfile

from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import get_smoke_config
from repro_torch.core import (AZURE_D8S_V3, CheckpointPolicy, CostAccountant,
                              NoEviction, PeriodicEviction, ScaleSet,
                              SpotOnCoordinator, TimeModel, VirtualClock)
from repro_torch.optim import AdamWConfig
from repro_torch.train import SpotTrainer, TrainJob


def run(steps: int, device: str, evict_every_s: float | None):
    clock = VirtualClock()
    accountant = CostAccountant(AZURE_D8S_V3)
    # a spot pool that preempts us every `evict_every_s` virtual seconds
    schedule = (PeriodicEviction(evict_every_s) if evict_every_s
                else NoEviction())
    pool = ScaleSet(clock=clock, schedule=schedule, accountant=accountant,
                    provisioning_delay_s=120.0)
    with tempfile.TemporaryDirectory(prefix="spoton_quickstart_") as root:
        # the uninterrupted run needs no checkpoints: transparent saves
        # never change the training math
        policy = (CheckpointPolicy.transparent(periodic_interval_s=300.0)
                  if evict_every_s else CheckpointPolicy.off())
        coordinator = SpotOnCoordinator(CheckpointStore(root), policy, clock,
                                        time_model=TimeModel())
        # reduced same-family config, at head dim 64: the smallest the
        # card's attention kernels are built for
        cfg = get_smoke_config("gemma3-1b").scaled(head_dim=64)
        job = TrainJob(cfg=cfg, opt=AdamWConfig(total_steps=steps),
                       total_steps=steps, n_stages=4, batch=4, seq_len=32)
        trainer = SpotTrainer(job, coordinator, pool, clock,
                              step_time_s=10.0, device=device)
        try:
            report = trainer.run()
        finally:
            coordinator.close()
    return report, accountant.summary(clock.now())["total_usd"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=240)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--evict-every", type=float, default=1200.0,
                    help="virtual seconds between evictions (10 a step)")
    args = ap.parse_args()

    report, usd = run(args.steps, args.device, args.evict_every)
    base, _ = run(args.steps, args.device, None)

    print(f"device:               {args.device}")
    print(f"completed:            {report.completed}")
    print(f"virtual time:         {report.total_time_s:,.0f} s")
    print(f"final loss:           {report.final_loss:.4f}")
    print(f"evictions survived:   {report.evictions_seen}")
    print(f"restores:             {report.restores}")
    print(f"lost steps:           {report.lost_steps} (0 = termination ckpts caught the frontier)")
    print(f"periodic ckpts:       {report.coordinator['periodic_ckpts']}")
    print(f"termination ckpts:    {report.coordinator['termination_ckpts']}")
    print(f"cost:                 ${usd:.4f}")
    print(f"uninterrupted loss:   {base.final_loss:.4f} "
          f"(bit-exact: {report.final_loss == base.final_loss})")
    assert report.completed and base.completed
    assert report.evictions_seen >= 1 and report.restores >= 1
    assert report.lost_steps == 0
    assert report.final_loss == base.final_loss, "resume is not bit-exact"
    print("OK")


if __name__ == "__main__":
    main()
