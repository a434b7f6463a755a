"""Elastic restore on the PyTorch port: checkpoint a sharded training state
on an 8-rank mesh, then resume on 4 ranks (half the capacity evicted) with
identical values — the paper's "restart on a new instance" generalized to a
new topology.

    PYTHONPATH=src python examples/torch_elastic_restore.py [--device cpu]

The twin of ``examples/elastic_restore.py`` through ``repro_torch``. It
re-executes itself as gloo worlds of ranks, as the port's pod restore runs
them: 8 ranks on a ``(4, 2)`` ``("data", "model")`` mesh save, then 4 ranks
on the ``(2, 2)`` mesh ``plan_mesh_for`` plans restore, every rank on one
card (or on the CPU with ``--device cpu``), each checking its own shard.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

INNER = "SPOTON_ELASTIC_INNER"
WORLD_TIMEOUT_S = 300
SHAPE = (64, 128)


def inner(spec: dict) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointStore, TensorSpec
    from repro_torch.core.elastic import plan_mesh_for
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh

    rank, world = spec["rank"], spec["world"]
    torch.set_num_threads(1)             # every rank shares one host
    dist.init_process_group("gloo", init_method=spec["init"], rank=rank,
                            world_size=world)
    dev = torch.device(spec["device"], 0) if spec["device"] == "cuda" \
        else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    w = torch.arange(SHAPE[0] * SHAPE[1], dtype=torch.float32,
                     device=dev).to(torch.bfloat16).reshape(SHAPE)
    store = CheckpointStore(spec["root"])
    if spec["kind"] == "save":
        # "pod" of 8 ranks: (4 data, 2 model)
        mesh8 = make_mesh((4, 2), ("data", "model"), device_type=dev.type)
        sharding = shd.Sharding(mesh8, shd.placements(("data", "model"), mesh8))
        state = {"params": {"w": shd.distribute(w, sharding)}, "step": 42}
        info = store.save(42, state, mesh_info={"shape": [4, 2]})
        if rank == 0:
            print(f"saved on 8 ranks: {info.nbytes} bytes, step {info.step}")
    else:
        # half the capacity disappears: plan a 4-rank mesh and restore
        plan = plan_mesh_for(world, model_parallel=2)
        mesh4 = plan.build(device_type=dev.type)
        tpl = {"params": {"w": TensorSpec(SHAPE, torch.bfloat16, dev, mesh4,
                                          shd.placements(("data", "model"),
                                                         mesh4))},
               "step": 0}
        restored, man = store.restore(tpl)
        got = restored["params"]["w"]
        (region,) = shd.addressable_shard_spans(mesh4, got.placements, SHAPE)
        want = w[tuple(slice(a, b) for a, b in region)]
        local = got.to_local()
        ok = (restored["step"] == 42 and man.step == 42
              and local.device == want.device
              and torch.equal(local.view(torch.int16), want.view(torch.int16)))
        every = [None] * world
        dist.all_gather_object(every, ok)
        if rank == 0:
            print(f"restored on 4 ranks ({plan.shape}): bit-exact "
                  f"{'✓' if all(every) else '✗'}")
        assert all(every), f"ranks whose shard differs: " \
            f"{[r for r, good in enumerate(every) if not good]}"
    dist.destroy_process_group()


def run_world(kind: str, world: int, root: str, device: str) -> None:
    env = dict(os.environ)
    env.setdefault("PYTHONPATH", str(Path(__file__).resolve().parents[1] / "src"))
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    init = f"file://{root}/rdv_{kind}"
    procs = []
    for r in range(world):
        env[INNER] = json.dumps({"rank": r, "world": world, "kind": kind,
                                 "root": f"{root}/ckpt", "init": init,
                                 "device": device})
        procs.append(subprocess.Popen([sys.executable, __file__], env=env))
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    try:
        for p in procs:
            rc = p.wait(timeout=max(deadline - time.monotonic(), 1))
            if rc != 0:
                raise SystemExit(f"{kind}: a rank exited {rc}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def main():
    if os.environ.get(INNER):
        inner(json.loads(os.environ[INNER]))
        return
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA GPU is available; pass --device cpu")
    with tempfile.TemporaryDirectory(prefix="spoton_elastic_") as root:
        run_world("save", 8, root, args.device)
        run_world("restore", 4, root, args.device)
    print("OK")


if __name__ == "__main__":
    main()
