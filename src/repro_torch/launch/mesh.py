"""Device meshes over the ranks of a process group, and the card's
published rates.

A PyTorch process is one rank on one device, so a mesh of ``n`` devices is
a ``DeviceMesh`` over ``n`` ranks. Building one touches no device state
until it is called.
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


def mesh_info(mesh: DeviceMesh) -> dict:
    return {"shape": [int(s) for s in mesh.shape],
            "axes": list(mesh.mesh_dim_names)}
