"""Device meshes over the ranks of a process group, the production mesh,
and the card's published rates.

A PyTorch process is one rank on one device, so a mesh of ``n`` devices is
a ``DeviceMesh`` over ``n`` ranks. Building one touches no device state
until it is called.

The production mesh is the reference's 256 devices a pod and 512 across
two pods, laid out for H100s: the ``model`` axis is 8 wide, the cards of
one NVLink node, and ``data`` takes the rest of a pod: (32, 8), and two
such pods on a ``pod`` axis, (2, 32, 8). The reference's 16 x 16 is a TPU
v5e pod's torus and its multi-pod mesh (2, 16, 16) (``launch/mesh.py``); a
16-wide model axis of H100s would cross nodes, so its tensor-parallel
collectives would leave NVLink. ``fake_world`` brings
up torch's ``fake`` process group of any size in this one process, so the
dry run (``launch/dryrun.py``) can build that mesh and trace one rank's
step without the cards.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

# NVIDIA H100 SXM5 80 GB, per card, from NVIDIA's H100 data sheet (the
# roofline's denominators; none measured here)
PEAK_FLOPS_BF16 = 989e12        # dense bf16 tensor-core FLOP/s, no sparsity
HBM_BW = 3.35e12                # HBM3 bytes/s
NVLINK_BW = 450e9               # NVLink 4 bytes/s each direction (900 GB/s
                                # both directions, 18 links)


def make_mesh(shape, axes, *, devices=None, device_type: str = "cuda"
              ) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over ranks ``devices``
    (default ``0..n-1``), row-major. With no process group up, a one-rank
    mesh is this process alone and is built without a backend."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    ranks = list(range(n)) if devices is None else [int(d) for d in devices]
    if len(ranks) != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks, got {len(ranks)}")
    mesh = torch.tensor(ranks, dtype=torch.int64).reshape(shape)
    if not dist.is_initialized():
        if n != 1 or ranks != [0]:
            raise ValueError(f"need {n} devices, have 1: no process group is up")
        return DeviceMesh(device_type, mesh, mesh_dim_names=tuple(axes),
                          _init_backend=False, _rank=0)
    return DeviceMesh(device_type, mesh, mesh_dim_names=tuple(axes))


PRODUCTION_SHAPES = {False: ((32, 8), ("data", "model")),
                     True: ((2, 32, 8), ("pod", "data", "model"))}


def fake_world(n: int, rank: int = 0) -> None:
    """A process group of ``n`` ranks on torch's ``fake`` backend, with this
    process as ``rank``: collectives complete without moving data. Replaces
    any group of another size that is up."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n and dist.get_rank() == rank:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The production mesh (module docstring) over the process group that
    is up, which must have its 256 or 512 ranks (``fake_world``)."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return make_mesh(shape, axes, device_type=device_type)


def mesh_info(mesh: DeviceMesh) -> dict:
    return {"shape": [int(s) for s in mesh.shape],
            "axes": list(mesh.mesh_dim_names)}
