"""FleetCoordinator — N per-instance coordinators, one shared store.

Scales the paper's single-instance workflow to a **heterogeneous fleet**: each
member is one spot instance on its own cloud provider (pool manager + metadata
schema + prices), all members mount the same ``CheckpointStore`` (the shared
NFS volume of the paper), and one ``SpotOnCoordinator`` runs beside each
member. The fleet models elastic data-parallel training:

* **replicated state** — every member holds the full training state, so the
  fleet only rolls back when *all* members are simultaneously dead (a full
  outage); a single eviction costs capacity, not progress;
* **single-writer periodic checkpoints** — the fleet owns the periodic
  cadence and asks the current leader (lowest-index alive member) to write,
  so N members don't save N copies. Termination checkpoints are written by
  whichever member receives the eviction notice, tagged with its provider;
* **eviction-driven elastic rescale** — when the alive count changes the
  fleet re-plans the device mesh (``core.elastic.fleet_mesh_plan``) and, when
  this process has enough devices to host the plan, records its data- and
  model-parallel degrees (no device mesh is built: that comes with the
  port's multi-device layer). With fewer members the global batch is
  fixed, so per-step time stretches by ``size/alive``;
* **per-provider cost accounting** — one ``CostAccountant`` per provider
  aggregates instance-seconds at that provider's prices.

The run loop drives a synthetic replicated workload (a numpy state whose
tensor equals the step count — cheap, and bit-exact restores are checkable),
against the real checkpoint store: atomic commit, latest-valid search and
retention all execute for real. The trainer (train/trainer.py) remains the
single-instance path with real jitted steps; the fleet is the scale harness.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass, field, replace

import numpy as np

from ..checkpoint.store import CheckpointStore
from ..distributed.sharding import elastic_rules
from .clock import Clock
from .coordinator import Signal, SpotOnCoordinator
from .cost import CostAccountant
from .elastic import MeshPlan, fleet_mesh_plan, member_addressable
from .ledger import TimeLedger, TimeModel
from .policy import CheckpointPolicy
from .providers import CloudProvider, get_provider
from .spot_sim import EvictionSchedule, InstancePool, NoEviction, SpotInstance

log = logging.getLogger("spoton.fleet")


@dataclass(frozen=True)
class FleetSpec:
    """One fleet member per entry: provider name (or instance) + its eviction
    schedule. ``hosts_per_instance``/``model_parallel`` shape the rescale
    planning; ``provisioning_delay_s`` applies to every member's pool."""

    providers: tuple = ("azure", "aws", "gcp")
    schedules: tuple | None = None          # None -> NoEviction() per member
    hosts_per_instance: int = 1
    model_parallel: int = 1
    provisioning_delay_s: float = 60.0


@dataclass
class _Member:
    index: int
    provider: CloudProvider
    pool: InstancePool
    coordinator: SpotOnCoordinator
    attached: str | None = None
    evictions_seen: int = 0


@dataclass
class FleetReport:
    completed: bool
    total_time_s: float
    steps_executed: int
    lost_steps: int
    restores: int
    full_outages: int
    final_state_consistent: bool
    rescale_events: list[dict] = field(default_factory=list)
    per_provider: dict[str, dict] = field(default_factory=dict)
    checkpoints: dict = field(default_factory=dict)
    total_usd: float = 0.0


class FleetCoordinator:
    def __init__(
        self,
        store: CheckpointStore,
        policy: CheckpointPolicy,
        clock: Clock,
        spec: FleetSpec,
        *,
        time_model: TimeModel | None = None,
        peer_exchange=None,
    ):
        self.store = store
        self.policy = policy
        self.clock = clock
        self.spec = spec
        # optional checkpoint.peer_exchange.FleetPeerExchange: when present,
        # an evictee seeds survivors' local pools during its notice window
        # and a cold member restores through its peer read-through pool
        self.peer_exchange = peer_exchange
        self.peer_seed_events: list[dict] = []
        self.ledger = TimeLedger(clock, time_model)
        # members never self-schedule periodic saves (the fleet owns the
        # cadence, below) but keep on-demand termination checkpoints
        member_policy = replace(policy, periodic_interval_s=math.inf)
        self._accountants: dict[str, CostAccountant] = {}
        self.members: list[_Member] = []
        schedules = spec.schedules or tuple(NoEviction() for _ in spec.providers)
        if len(schedules) != len(spec.providers):
            raise ValueError("one eviction schedule per provider required")
        for i, (prov_spec, sched) in enumerate(zip(spec.providers, schedules)):
            prov = get_provider(prov_spec)
            acct = self._accountants.setdefault(prov.name,
                                                CostAccountant(prov.prices))
            pool = prov.make_pool(
                clock, sched, acct,
                provisioning_delay_s=spec.provisioning_delay_s,
                hosts_per_instance=spec.hosts_per_instance,
                # distinct prefixes: N pools must not collide on instance names
                name_prefix=f"{prov.instance_prefix}m{i}-")
            coord = SpotOnCoordinator(store, member_policy, clock,
                                      provider=prov, ledger=self.ledger)
            self.members.append(_Member(index=i, provider=prov, pool=pool,
                                        coordinator=coord))
        self.size = len(self.members)
        self.rescale_events: list[dict] = []
        self._last_alive = -1

    # -- plumbing ---------------------------------------------------------------

    def _tick_member(self, m: _Member) -> SpotInstance | None:
        inst = m.pool.tick()
        if inst is None:
            if m.attached is not None:
                m.coordinator.detach()
                m.attached = None
            return None
        if inst.name != m.attached:
            m.coordinator.attach_instance(inst.metadata, inst.name)
            m.attached = inst.name
        return inst

    def _advance_to_next_capacity(self) -> None:
        """Nobody alive: jump the clock to the earliest pending replacement."""
        targets = [m.pool._pending_ready_at for m in self.members
                   if m.pool._pending_ready_at is not None]
        assert targets, "fleet stalled with no replacement provisioning"
        self.clock.sleep(max(min(targets) - self.clock.now(), 0.0) + 1e-9)

    def _record_rescale(self, n_alive: int) -> None:
        event = {"t": self.clock.now(), "alive": n_alive,
                 "capacity": n_alive * self.spec.hosts_per_instance}
        plan = None
        try:
            plan = fleet_mesh_plan(
                n_alive, hosts_per_instance=self.spec.hosts_per_instance,
                model_parallel=self.spec.model_parallel)
            event["mesh_shape"] = plan.shape
            event["mesh_axes"] = plan.axes
            try:
                # materialize only where the process group has enough
                # ranks; the fleet reads the degrees, so a CPU mesh serves
                rules = elastic_rules(plan.build(device_type="cpu"))
                event["dp"], event["tp"] = rules.dp_size, rules.tp_size
            except ValueError:
                pass  # plan recorded; a real fleet builds it on its own chips
        except ValueError as e:
            event["error"] = str(e)  # capacity can't host the MP degree
        # rescale-stable fingerprints: each member remaps its device-delta
        # tracker onto the new plan instead of starting from scratch — the
        # D2H delta win survives the topology change (stable piece keys)
        if plan is not None:
            kept = dropped = 0
            for m in self.members:
                res = m.coordinator.rescale_topology(
                    member_addressable(plan, m.index))
                kept += res["kept"]
                dropped += res["dropped"]
            event["fingerprints_kept"] = kept
            event["fingerprints_dropped"] = dropped
        self.rescale_events.append(event)
        log.info("elastic rescale: %s", event)

    def _seed_peers(self, m: _Member) -> None:
        """Eviction-notice move: the evictee pushes the latest committed
        checkpoint's hottest chunks into the survivors' local pools (AWS
        rebalance gives ≈120 s — the push budget is sized for it), so the
        replacement's restore finds them one NIC hop away."""
        if self.peer_exchange is None:
            return
        opened = self.store.latest_valid()
        if opened is None:
            return
        man, reader = opened
        reader.close()
        try:
            res = self.peer_exchange.seed_from(
                m.index, self.store.pool, sorted(man.chunk_hashes()))
        except OSError as e:            # seeding is best-effort by design
            log.warning("peer seed from member %d failed: %s", m.index, e)
            return
        self.peer_seed_events.append(
            {"t": self.clock.now(), "member": m.index, "step": man.step, **res})

    # -- the run loop -----------------------------------------------------------

    def run(self, *, total_steps: int, step_time_s: float,
            state_elems: int = 1024, max_iterations: int | None = None) -> FleetReport:
        spec = self.spec
        clock = self.clock
        t_start = clock.now()
        template = {"w": np.zeros((state_elems,), np.float32), "step": 0}
        state = {"w": np.zeros((state_elems,), np.float32), "step": 0}
        step = 0
        steps_executed = 0
        lost_steps = 0
        full_outages = 0
        cold = True          # fleet has no in-memory state yet
        last_periodic = clock.now()
        budget = max_iterations or (total_steps * 100 + 10_000)
        for m in self.members:
            m.pool.start()

        it = 0
        while step < total_steps:
            it += 1
            if it > budget:
                break
            alive = [m for m in self.members if self._tick_member(m) is not None]
            if not alive:
                if not cold:
                    # full outage: in-memory replicas gone, must restore
                    cold = True
                    full_outages += 1
                self._advance_to_next_capacity()
                continue
            if cold:
                # a replacement consults surviving peers before the shared
                # store when the fleet runs a peer exchange (read-through:
                # peer hit -> local pool -> decode; miss -> store fallback)
                rt_pool = (self.peer_exchange.read_through(
                               alive[0].index, self.store.pool)
                           if self.peer_exchange is not None else None)
                restored = alive[0].coordinator.restore_latest(
                    template, chunk_pool=rt_pool)
                if restored is not None:
                    state, _man = restored
                    state = {"w": np.asarray(state["w"]), "step": int(state["step"])}
                    lost_steps += max(0, step - state["step"])
                    step = state["step"]
                else:
                    lost_steps += step
                    step = 0
                    state = {"w": np.zeros((state_elems,), np.float32), "step": 0}
                cold = False
            n_alive = len(alive)
            if n_alive != self._last_alive:
                self._record_rescale(n_alive)
                self._last_alive = n_alive
            # elastic DP: fixed global batch -> step stretches with lost capacity
            dur = step_time_s * (self.size / n_alive)
            self.ledger.charge_step(dur)
            step += 1
            steps_executed += 1
            state = {"w": state["w"] + 1.0, "step": step}
            # fleet-owned periodic cadence, written by the current leader
            if (self.policy.periodic_enabled
                    and clock.now() - last_periodic >= self.policy.periodic_interval_s):
                alive[0].coordinator.save_periodic_now(step, state)
                last_periodic = clock.now()
            for m in alive:
                sig = m.coordinator.on_step_end(step, lambda s=state: s,
                                                step_duration_s=dur)
                if sig is Signal.PREEMPTING:
                    m.evictions_seen += 1
                    # the member rides out its notice; replacement provisioning
                    # begins when the platform destroys it (pool.tick above).
                    # Meanwhile the notice window pays for peer seeding: push
                    # the hottest committed chunks to the survivors
                    self._seed_peers(m)

        for m in self.members:
            m.coordinator.flush()
            m.pool.shutdown()
            m.coordinator.close()

        per_provider: dict[str, dict] = {}
        for name, acct in self._accountants.items():
            per_provider[name] = acct.summary(clock.now())
        for m in self.members:
            p = per_provider[m.provider.name]
            p["evictions"] = p.get("evictions", 0) + m.pool.evictions_announced
            p["instances"] = p.get("instances", 0) + m.pool.instances_created
            p["rebalance_recommendations"] = (
                p.get("rebalance_recommendations", 0)
                + m.pool.rebalance_recommendations)
        ckpt = {
            "periodic": sum(m.coordinator.stats.periodic_ckpts for m in self.members),
            "termination": sum(m.coordinator.stats.termination_ckpts for m in self.members),
            "termination_failures": sum(m.coordinator.stats.termination_failures
                                        for m in self.members),
            "periodic_failures": sum(m.coordinator.stats.periodic_failures
                                     for m in self.members),
            "rebalance": sum(m.coordinator.stats.rebalance_ckpts for m in self.members),
            # robustness counters: bounded retries burned on transient IO
            # faults, faults a torture plan injected (0 in clean runs), and
            # periodic saves skipped while a member's storage was degraded
            "io_retries": sum(m.coordinator.stats.io_retries
                              for m in self.members),
            "faults_injected": sum(m.coordinator.stats.faults_injected
                                   for m in self.members),
            "saves_degraded": sum(m.coordinator.stats.saves_degraded
                                  for m in self.members),
            # object-store backend robustness (zeros on a plain POSIX store)
            "backend_retries": sum(m.coordinator.stats.backend_retries
                                   for m in self.members),
            "backend_outages": sum(m.coordinator.stats.backend_outages
                                   for m in self.members),
            "spooled_bytes": sum(m.coordinator.stats.spooled_bytes
                                 for m in self.members),
            # physical bytes pushed to the shared volume: under a delta-mode
            # store this is dirty chunks only, far below N_saves x state size
            "bytes_written": sum(m.coordinator.stats.ckpt_bytes_written
                                 for m in self.members),
            "store_mode": self.store.mode,
            "store_total_bytes": self.store.total_bytes(),
            # peer-exchange accounting (zeros without an exchange fabric)
            "peer_seed_events": len(self.peer_seed_events),
            "peer_seeded_chunks": (self.peer_exchange.stats["seeded_chunks"]
                                   if self.peer_exchange else 0),
            "peer_seeded_bytes": (self.peer_exchange.stats["seeded_bytes"]
                                  if self.peer_exchange else 0),
            "by_provider": {
                name: {
                    "termination": sum(m.coordinator.stats.termination_ckpts
                                       for m in self.members
                                       if m.provider.name == name),
                    "periodic": sum(m.coordinator.stats.periodic_ckpts
                                    for m in self.members
                                    if m.provider.name == name),
                } for name in per_provider
            },
        }
        return FleetReport(
            completed=step >= total_steps,
            total_time_s=clock.now() - t_start,
            steps_executed=steps_executed,
            lost_steps=lost_steps,
            restores=sum(m.coordinator.stats.restores for m in self.members),
            full_outages=full_outages,
            final_state_consistent=bool(np.all(state["w"] == float(step))),
            rescale_events=self.rescale_events,
            per_provider=per_provider,
            checkpoints=ckpt,
            total_usd=sum(p["total_usd"] for p in per_provider.values()),
        )
