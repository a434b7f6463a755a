"""Elastic re-planning — which mesh the surviving capacity can host.

The paper restarts on "a new instance" of the same VM size. At pod scale the
replacement capacity may be *smaller* (a pod is gone) or differently shaped;
because manifests store global shapes and per-piece indices (checkpoint/
sharded.py), restoring under any mesh is just re-slicing. This module is the
policy layer: pick a (data, model) mesh shape for the capacity that is left,
build it as a ``DeviceMesh`` over the ranks of the process group, say which
global byte spans a fleet member owns under it (the ``addressable``
predicate of ``DeviceDeltaTracker.rescale``), and restore a template
rebuilt for the new mesh.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..distributed.multihost import process_count


@dataclass(frozen=True)
class MeshPlan:
    shape: tuple[int, ...]
    axes: tuple[str, ...]

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def build(self, devices=None, *, device_type: str = "cuda"):
        """A ``DeviceMesh`` of this plan over the first ``n_devices`` of
        ``devices`` (default: the ranks of the process group; a process with
        no group is a world of one rank)."""
        from ..launch.mesh import make_mesh
        devices = list(range(process_count())) if devices is None else list(devices)
        n = self.n_devices
        if len(devices) < n:
            raise ValueError(f"need {n} devices, have {len(devices)}")
        return make_mesh(self.shape, self.axes, devices=devices[:n],
                         device_type=device_type)

    def axis_size(self, axis: str) -> int:
        """Size of ``axis`` in this plan (1 when the plan has no such axis)."""
        for size, name in zip(self.shape, self.axes):
            if name == axis:
                return int(size)
        return 1


def plan_mesh_for(n_devices: int, *, model_parallel: int, axes=("data", "model")) -> MeshPlan:
    """Largest (data, model) mesh for the surviving device count, preserving
    the model-parallel degree (param shards must still fit one instance)."""
    if n_devices % model_parallel != 0:
        raise ValueError(f"{n_devices} devices not divisible by model={model_parallel}")
    return MeshPlan((n_devices // model_parallel, model_parallel), tuple(axes))


def fleet_mesh_plan(n_instances: int, *, hosts_per_instance: int = 1,
                    model_parallel: int = 1,
                    axes=("data", "model")) -> MeshPlan:
    """Mesh plan for a fleet's surviving capacity (eviction-driven rescale).

    Each fleet instance contributes ``hosts_per_instance`` accounting units;
    the model-parallel degree is preserved across rescales so parameter
    shards keep fitting one instance. Raises ValueError when the surviving
    capacity cannot host the model-parallel degree — the fleet coordinator
    records that as a stall rather than a rescale.
    """
    if n_instances < 1:
        raise ValueError("fleet has no surviving instances")
    return plan_mesh_for(n_instances * hosts_per_instance,
                         model_parallel=model_parallel, axes=axes)


def member_addressable(plan: MeshPlan, member_index: int, *,
                       model_axis: str = "model"):
    """Byte-span ownership predicate for one fleet member under ``plan`` —
    the ``addressable`` argument of ``DeviceDeltaTracker.rescale`` /
    ``SpotOnCoordinator.rescale_topology``.

    Every axis except ``model_axis`` replicates parameters (data
    parallelism), so with ``model == 1`` each member addresses every span. A
    model-parallel degree ``m > 1`` partitions each leaf's flat byte extent
    into ``m`` equal slices and the member owns the slice of its model
    coordinate (``member_index % m`` — members fill the model axis fastest,
    row-major device placement). A fingerprint span survives the rescale iff
    it lies fully inside the member's slice.
    """
    m = plan.axis_size(model_axis)
    if m <= 1:
        return lambda name, lo, hi, total: True
    coord = member_index % m

    def owns(name: str, lo: int, hi: int, total: int) -> bool:
        if total <= 0:
            return coord == 0
        slice_lo = (coord * total) // m
        slice_hi = ((coord + 1) * total) // m
        return slice_lo <= lo and hi <= slice_hi

    return owns


def elastic_restore(store, template_fn, mesh, *, streaming: bool = False):
    """Restore the latest valid checkpoint onto ``mesh``.

    ``template_fn(mesh) -> state-template`` rebuilds the template leaves
    (``DTensor``s or ``TensorSpec``s with the new mesh's placements; global
    shapes are mesh-independent by construction). Returns (state, manifest).
    """
    return store.restore(template_fn(mesh), streaming=streaming)
