"""The port's Spot-on loop end to end on the CPU: the trainer, coordinator,
spot simulator and store of ``tests/test_trainer_integration.py``, driven
through ``repro_torch``. Transparent checkpointing costs nothing without
evictions, an evicted run resumes to a bitwise-equal final loss, and a
``quantize_moments`` store takes its urgent saves through the int8 path."""

import math

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.checkpoint import serialize as ser  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import (AZURE_D8S_V3, CheckpointPolicy,  # noqa: E402
                              CostAccountant, NoEviction, PeriodicEviction,
                              ScaleSet, SpotOnCoordinator, TimeModel,
                              VirtualClock)
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.train import SpotTrainer, TrainJob  # noqa: E402


class RecordingCoordinator(SpotOnCoordinator):
    """Keeps the state handed to the last urgent save and the last restore
    (the train step is functional, so a held state never changes)."""
    urgent_state = None
    restored = None

    def _save_termination(self, step, state, deadline):
        self.urgent_state = state
        return super()._save_termination(step, state, deadline)

    def restore_latest(self, template, **kw):
        self.restored = super().restore_latest(template, **kw)
        return self.restored


def run_job(tmp_path, mode, evict_s, *, total=40, step_time=10.0,
            periodic_s=100.0, tag="", quantize_moments=False):
    clock = VirtualClock()
    acct = CostAccountant(AZURE_D8S_V3)
    sched = PeriodicEviction(evict_s) if evict_s else NoEviction()
    pool = ScaleSet(clock=clock, schedule=sched, accountant=acct,
                    provisioning_delay_s=60.0, notice_s=30.0)
    store = CheckpointStore(str(tmp_path / f"ckpt{tag}"), time_fn=clock.now,
                            quantize_moments=quantize_moments)
    policy = {"off": CheckpointPolicy.off(),
              "application": CheckpointPolicy.application(),
              "transparent": CheckpointPolicy.transparent(periodic_s)}[mode]
    coord = RecordingCoordinator(store, policy, clock, time_model=TimeModel())
    cfg = get_smoke_config("phi3_mini_3p8b")
    job = TrainJob(cfg=cfg, opt=AdamWConfig(total_steps=total),
                   total_steps=total, n_stages=3, batch=2, seq_len=16)
    tr = SpotTrainer(job, coord, pool, clock, step_time_s=step_time,
                     max_sessions=40, device="cpu")
    rep = tr.run()
    coord.close()
    return rep, coord


def test_off_and_transparent_equal_time_without_evictions(tmp_path):
    off, _ = run_job(tmp_path, "off", None, tag="a")
    tr, _ = run_job(tmp_path, "transparent", None, tag="b")
    assert off.completed and tr.completed
    assert tr.coordinator["periodic_ckpts"] >= 2
    assert tr.total_time_s <= off.total_time_s * 1.05
    assert tr.final_loss == off.final_loss


def test_transparent_evicted_resume_is_bit_exact(tmp_path):
    base, _ = run_job(tmp_path, "off", None, tag="base")
    ev, coord = run_job(tmp_path, "transparent", 250.0, tag="ev")
    assert ev.completed
    assert ev.evictions_seen >= 1 and ev.restores >= 1
    assert ev.lost_steps == 0                 # the urgent save caught the frontier
    assert math.isfinite(base.final_loss)
    assert ev.final_loss == base.final_loss   # bitwise, not approximately
    # periodic saves after the first went through the fingerprint tracker
    assert ev.coordinator["d2h_bytes"] > 0


def test_application_policy_rolls_back_to_the_stage(tmp_path):
    ev, _ = run_job(tmp_path, "application", 420.0, total=60, tag="app")
    assert ev.completed
    assert ev.lost_steps > 0
    assert ev.coordinator["termination_ckpts"] == 0


def test_quantize_moments_urgent_save_and_restore(tmp_path):
    rep, coord = run_job(tmp_path, "transparent", 250.0, tag="q",
                         quantize_moments=True)
    assert rep.completed and rep.evictions_seen >= 1 and rep.restores >= 1
    assert rep.lost_steps == 0 and math.isfinite(rep.final_loss)
    state, man = coord.restored
    assert man.kind == "termination"
    # the restored moments are the host dequantize of the host quantize of
    # the moments the urgent save was handed, bit for bit; everything else
    # is restored exactly
    saved, got = ser.flatten_state(coord.urgent_state), ser.flatten_state(state)
    n_moments = 0
    for name, t in saved.items():
        want = ser.to_host(t)
        if ser.is_moment_name(name) and t.ndim:
            dtype = ser.dtype_to_name(t.dtype)
            q, scale = ser.quantize(want, "int8", dtype)
            want = ser.finish_payload(q, dtype_name=dtype, quant="int8",
                                      scale=scale)
            n_moments += 1
        np.testing.assert_array_equal(
            ser.to_host(got[name]).reshape(-1).view(np.uint8),
            np.ascontiguousarray(want).reshape(-1).view(np.uint8), err_msg=name)
    assert n_moments > 0
    recs = {r["name"].rsplit("#", 1)[0]: r for r in man.tensors}
    assert all(recs[n]["codec"].startswith("int8")
               for n in saved if ser.is_moment_name(n) and saved[n].ndim)
