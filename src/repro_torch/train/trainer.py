"""SpotTrainer — the paper's Fig. 1 workflow as a training-cluster loop.

One run = the life of a long-running workload on a spot Scale Set:

    provision instance → restore most-recent-valid checkpoint (or cold-start)
    → step loop [periodic ckpts | stage ckpts | eviction notice → termination
    ckpt] → instance dies → replacement provisions → restore → ... → complete.

The *workload* is a staged training job — ``n_stages`` plays metaSPAdes'
k-mer-stage role: the application-specific policy may checkpoint only at
stage boundaries, the transparent policy at any step.

Two time modes:
  * wall mode (clock=WallClock, step_time_s=None): durations are physical.
  * virtual mode (clock=VirtualClock, step_time_s=x): steps still execute
    (the state evolution and checkpoint bytes are real) but the clock
    advances by a modeled per-step cost, and checkpoint/restore costs come
    from the coordinator's TimeModel.

The steps run on ``device`` (default ``"cuda"``) with deterministic
algorithms, so a run resumed from a checkpoint ends bitwise equal to an
uninterrupted one. The reference's ahead-of-time step compile has no twin:
PyTorch runs eagerly.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass, field

from ..core.clock import Clock
from ..core.coordinator import Signal, SpotOnCoordinator
from ..core.spot_sim import InstancePool
from ..data import PipelineState, TokenPipeline
from ..device import resolve_device, set_deterministic
from ..kernels import _lib
from ..models.config import ModelConfig
from ..optim import AdamWConfig
from .train_step import (batch_to_device, init_train_state, make_train_step,
                         state_template, state_template_on_device)

log = logging.getLogger("spoton")


@dataclass
class TrainJob:
    cfg: ModelConfig
    opt: AdamWConfig
    total_steps: int
    n_stages: int = 5                      # metaSPAdes used 5 k-mer stages
    batch: int = 8
    seq_len: int = 64
    seed: int = 0

    def stage_boundaries(self) -> list[int]:
        return [math.ceil(self.total_steps * (i + 1) / self.n_stages)
                for i in range(self.n_stages)]


@dataclass
class RunReport:
    completed: bool
    total_time_s: float
    stage_times_s: list[float]             # per-stage durations (Table I rows)
    steps_executed: int                    # including rolled-back work
    lost_steps: int
    restores: int
    cold_starts: int
    instances_used: int
    evictions_seen: int
    final_loss: float
    coordinator: dict
    extra: dict = field(default_factory=dict)


class SpotTrainer:
    def __init__(self, job: TrainJob, coordinator: SpotOnCoordinator,
                 pool: InstancePool, clock: Clock, *,
                 step_time_s: float | None = None,
                 max_sessions: int = 200, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_deterministic()
            _lib.library()       # build the kernels now, not inside a save
        self.job = job
        self.coord = coordinator
        self.pool = pool
        self.clock = clock
        self.ledger = coordinator.ledger   # shared virtual-time accounting
        self.step_time_s = step_time_s
        self.max_sessions = max_sessions
        cfg = job.cfg
        if not cfg.embed_inputs:
            raise NotImplementedError("frontend-embedding archs are not ported yet")
        self.pipeline = TokenPipeline(
            vocab_size=cfg.vocab_size, batch=job.batch, seq_len=job.seq_len,
            seed=job.seed)
        self._step_fn = make_train_step(cfg, job.opt)

    # -----------------------------------------------------------------------

    def _fresh_state(self):
        return init_train_state(self.job.cfg, self.job.opt, seed=self.job.seed,
                                device=self.device)

    def resume(self, template):
        """Eviction→first-step-back: streaming restore of the latest
        checkpoint straight onto the device, and an O(1) fast-forward of the
        data pipeline to the restored cursor. Returns (state, manifest,
        step, pipeline_state) or None when no checkpoint exists."""
        restored = self.coord.restore_latest(
            state_template_on_device(template, self.device))
        if restored is None:
            return None
        state, man = restored
        step = int(state["step"])
        pstate = self.pipeline.fast_forward(int(state["data"]["next_batch_index"]))
        return state, man, step, pstate

    def run(self) -> RunReport:
        job = self.job
        clock = self.clock
        t_start = clock.now()
        boundaries = job.stage_boundaries()
        stage_cross_time: dict[int, float] = {}   # stage idx -> crossing time
        steps_executed = 0
        lost_steps = 0
        cold_starts = 0
        sessions = 0
        last_session_max_step = 0
        final_loss = float("nan")
        template = state_template(self._fresh_state())
        self.pool.start()
        completed = False

        while not completed and sessions < self.max_sessions:
            sessions += 1
            inst = self.pool.wait_for_instance()
            self.coord.attach_instance(inst.metadata, inst.name)
            resumed = self.resume(template)
            if resumed is not None:
                state, _man, step, pstate = resumed
            else:
                state = self._fresh_state()
                step = 0
                cold_starts += 1
                pstate = self.pipeline.fast_forward(0)
            # work executed beyond this restore point is lost
            if last_session_max_step > step:
                lost_steps += last_session_max_step - step
            # crossings beyond the restore point are invalidated (rolled back)
            for si in [s for s, _ in list(stage_cross_time.items())
                       if boundaries[s] > step]:
                stage_cross_time.pop(si, None)

            preempted = False
            while step < job.total_steps:
                if self.pool.tick() is None:       # platform killed the VM
                    break
                # the host-side cursor mirrors state["data"]["next_batch_index"]
                batch = batch_to_device(
                    self.pipeline.batch_at(pstate.next_batch_index), self.device)
                t0 = clock.now()
                state, metrics = self._step_fn(state, batch)
                final_loss = float(metrics["loss"])     # syncs the step
                pstate = PipelineState(pstate.next_batch_index + 1)
                self.ledger.charge_step(self.step_time_s)
                dur = clock.now() - t0
                step += 1
                steps_executed += 1
                for si, b in enumerate(boundaries):
                    if step == b:
                        stage_cross_time[si] = clock.now()
                        self.coord.on_stage_end(si, step, state)
                # the supplier is invoked lazily, only when the coordinator
                # decides to checkpoint; the coordinator owns the prestage
                # (it knows the save kind). The step never writes `state`, so
                # copies still in flight read unchanged bytes.
                sig = self.coord.on_step_end(step, lambda s=state: s,
                                             step_duration_s=dur)
                if sig is Signal.PREEMPTING:
                    preempted = True
                    break
                if sig is Signal.STRAGGLER:
                    inst.terminate()
                    break
            last_session_max_step = step
            if step >= job.total_steps:
                completed = True
                break
            if preempted:       # ride the notice out until the platform kills us
                while self.pool.tick() is not None:
                    clock.sleep(1.0)
            self.coord.detach()

        self.coord.flush()
        self.pool.shutdown()
        total = clock.now() - t_start
        stage_times = []
        prev = t_start
        for si in range(job.n_stages):
            t = stage_cross_time.get(si)
            if t is None:
                stage_times.append(float("nan"))
            else:
                stage_times.append(t - prev)
                prev = t
        st = self.coord.stats
        return RunReport(
            completed=completed,
            total_time_s=total,
            stage_times_s=stage_times,
            steps_executed=steps_executed,
            lost_steps=lost_steps,
            restores=st.restores,
            cold_starts=cold_starts,
            instances_used=self.pool.instances_created,
            evictions_seen=self.pool.evictions_announced,
            final_loss=final_loss,
            coordinator={
                "periodic_ckpts": st.periodic_ckpts,
                "termination_ckpts": st.termination_ckpts,
                "termination_failures": st.termination_failures,
                "rebalance_ckpts": st.rebalance_ckpts,
                "stage_ckpts": st.stage_ckpts,
                "ckpt_bytes_written": st.ckpt_bytes_written,
                "ckpt_time_s": st.ckpt_time_s,
                "d2h_bytes": st.d2h_bytes,
                "d2h_bytes_skipped": st.d2h_bytes_skipped,
                "save_stall_s": st.save_stall_s,
                "restore_queue_wait_s": st.restore_queue_wait_s,
                "restore_decode_s": st.restore_decode_s,
                "save_yields": st.save_yields,
                "io_retries": st.io_retries,
                "faults_injected": st.faults_injected,
                "saves_degraded": st.saves_degraded,
                "backend_retries": st.backend_retries,
                "backend_outages": st.backend_outages,
                "spooled_bytes": st.spooled_bytes,
                "poll_failures": st.poll_failures,
                "mttr_mean_s": st.mttr_mean_s,
                "mttr_samples": list(st.mttr_samples),
            },
            extra={"provider": self.coord.provider.name},
        )
