"""The port's multihost barrier held against the reference's (twins of
``tests/test_peer_exchange.py``'s ``TestRestoreBarrier``), plus the
process-group barrier: a gloo world of two CPU ranks in which one never
arrives, and the other raises within the time limit instead of hanging.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
import textwrap
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

PKG_ROOTS = {"reference": "repro", "port": "repro_torch"}
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _load(root: str) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")
    return SimpleNamespace(checkpoint=mod("checkpoint"),
                           multihost=mod("distributed.multihost"))


PKGS = {name: _load(root) for name, root in PKG_ROOTS.items()}


@pytest.fixture(params=list(PKGS))
def pkg(request):
    return PKGS[request.param]


def make_store(pkg, tmp_path, rng, *, elems=8192):
    store = pkg.checkpoint.CheckpointStore(str(tmp_path / "store"))
    state = {"w": rng.normal(size=(elems,)).astype(np.float32),
             "b": rng.normal(size=(257,)).astype(np.float32)}
    store.save(1, state)
    return store, state


class TestRestoreBarrier:
    def test_streaming_restores_rendezvous(self, tmp_path, rng, pkg):
        # three "processes" (threads) restore the same checkpoint; with the
        # simulated barrier installed, none returns before all reach the
        # spoton:restore_streaming sync point
        store, state = make_store(pkg, tmp_path, rng)
        template = {k: np.zeros_like(v) for k, v in state.items()}
        results, errors, returned = [None] * 3, [], []
        barrier = pkg.multihost.SimulatedBarrier(3, timeout_s=30.0)
        first_back = threading.Event()

        def restore(i):
            try:
                if i == 2:          # the last participant arrives late
                    time.sleep(0.3)
                got, _ = store.restore(template, streaming=True)
                returned.append((i, time.monotonic()))
                results[i] = got
            except Exception as e:            # pragma: no cover - diagnostics
                errors.append(e)
            finally:
                first_back.set()

        with pkg.multihost.use_simulated_barrier(barrier):
            t0 = time.monotonic()
            threads = [threading.Thread(target=restore, args=(i,))
                       for i in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads)
        assert not errors
        # nobody passed the rendezvous before the late participant came
        assert all(at - t0 >= 0.3 for _i, at in returned)
        for got in results:
            assert got is not None
            for k in state:
                np.testing.assert_array_equal(np.asarray(got[k]), state[k])

    def test_lost_participant_breaks_loudly(self, pkg):
        barrier = pkg.multihost.SimulatedBarrier(2, timeout_s=0.2)
        with pytest.raises(RuntimeError, match="broken"):
            barrier.wait("spoton:restore_streaming")

    def test_no_barrier_installed_is_a_noop(self, pkg):
        pkg.multihost.sync_global_devices("spoton:restore_streaming")

    def test_barrier_needs_a_party(self, pkg):
        with pytest.raises(ValueError):
            pkg.multihost.SimulatedBarrier(0)


def test_single_process_counts():
    mh = PKGS["port"].multihost
    assert mh.process_count() == 1 and mh.process_index() == 0


LOST_RANK = textwrap.dedent("""
    import sys, time
    import torch.distributed as dist
    rank, init = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
    from repro_torch.distributed import multihost
    if rank == 1:
        time.sleep(20)         # alive, but never reaches the barrier
        sys.exit(0)
    multihost.BARRIER_TIMEOUT_S = 3.0
    t0 = time.monotonic()
    try:
        multihost.sync_global_devices("spoton:restore_streaming")
    except RuntimeError as e:
        print(f"RAISED {time.monotonic() - t0:.2f} {e}")
        sys.exit(0)
    print("PASSED")
    sys.exit(1)
""")


@pytest.mark.timeout(90)
def test_lost_rank_raises_within_the_limit(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC, GLOO_SOCKET_IFNAME="lo")
    init = f"file://{tmp_path / 'rdv'}"
    procs = [subprocess.Popen([sys.executable, "-c", LOST_RANK, str(r), init],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for r in range(2)]
    try:
        out0, err0 = procs[0].communicate(timeout=60)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    assert procs[0].returncode == 0, out0 + err0[-3000:]
    assert out0.startswith("RAISED"), out0
    waited = float(out0.split()[1])
    assert 2.5 <= waited < 15.0, out0
    assert "spoton:restore_streaming" in out0


FAILING_SAVE = textwrap.dedent("""
    import os, sys, time
    import torch, torch.distributed as dist
    rank, init, root = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.distributed import multihost
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    multihost.BARRIER_TIMEOUT_S = 4.0
    mesh = make_mesh((2,), ("data",), device_type="cpu")
    sh = shd.Sharding(mesh, shd.placements(("data",), mesh))
    state = {"w": shd.distribute(torch.arange(64.0), sh), "step": 1}

    def fail_rank_1(phase):          # this rank's write fails after its chunks
        if rank == 1 and phase == "shards_written":
            raise OSError("disk gone")

    store = CheckpointStore(root, fault_injector=fail_rank_1)
    try:
        store.save(1, state)
        print("SAVED")
        sys.exit(1)
    except RuntimeError as e:
        assert "rank 1" in str(e) and "disk gone" in str(e), e
    assert store.committed_steps() == []

    def die_on_rank_1(phase):        # this rank dies in the middle of a save
        if rank == 1 and phase == "staged":
            os._exit(3)

    store = CheckpointStore(root, fault_injector=die_on_rank_1)
    t0 = time.monotonic()
    try:
        store.save(2, state)
    except RuntimeError as e:
        print(f"RAISED {time.monotonic() - t0:.2f}")
        assert store.committed_steps() == []
        sys.exit(0)
    print("SAVED")
    sys.exit(1)
""")


@pytest.mark.timeout(90)
def test_a_failed_or_lost_rank_fails_the_save(tmp_path):
    """A save by two gloo ranks: one rank's failed write fails it on both
    ranks and commits nothing; a rank that dies mid-save makes the other
    raise within the barrier's time limit, and nothing commits."""
    env = dict(os.environ, PYTHONPATH=SRC, GLOO_SOCKET_IFNAME="lo")
    init = f"file://{tmp_path / 'rdv'}"
    procs = [subprocess.Popen([sys.executable, "-c", FAILING_SAVE, str(r), init,
                               str(tmp_path / "store")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for r in range(2)]
    try:
        outs = [p.communicate(timeout=60) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    (out0, err0), (_out1, err1) = outs
    assert procs[0].returncode == 0, out0 + err0[-3000:]
    assert procs[1].returncode == 3, err1[-3000:]     # died where it was told
    assert out0.startswith("RAISED") and float(out0.split()[1]) < 15.0, out0


CONCURRENT_SAVES = textwrap.dedent("""
    import sys, threading
    import numpy as np
    import torch, torch.distributed as dist
    rank, init, root = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
    from repro_torch.checkpoint import (AsyncCheckpointer, CheckpointStore,
                                        TensorSpec)
    from repro_torch.checkpoint import serialize as ser
    from repro_torch.distributed import multihost
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    multihost.BARRIER_TIMEOUT_S = 20.0
    mesh = make_mesh((2,), ("data",), device_type="cpu")
    sh = shd.Sharding(mesh, shd.placements(("data",), mesh))

    def whole(step):                 # each step's values differ
        g = torch.Generator().manual_seed(step)
        return {"params/w": torch.randn(64, 16, generator=g),
                "opt/mu/w": torch.randn(64, 16, generator=g)}

    def state(step):
        w = whole(step)
        return {"params": {"w": shd.distribute(w["params/w"], sh)},
                "opt": {"mu": {"w": shd.distribute(w["opt/mu/w"], sh)}},
                "step": step}

    held, written, release = (threading.Event(), threading.Event(),
                              threading.Event())

    def hold(phase):
        # rank 0's periodic save stops before its write; rank 1's writes
        # and waits for it at the next barrier
        if rank == 0 and phase == "staged" and not held.is_set():
            held.set()
            assert release.wait(60)
        if rank == 1 and phase == "shards_written" and not written.is_set():
            written.set()

    store = CheckpointStore(root, chunk_size=256, compress=False,
                            quantize_moments=True, fault_injector=hold)
    ac = AsyncCheckpointer(store)
    ac.save_async(10, state(10))
    assert (held if rank == 0 else written).wait(30)
    # the notice: an urgent save while the periodic one is in flight
    info = ac.save_urgent(11, state(11))
    assert (info.step, info.kind) == (11, "termination")
    release.set()
    ac.wait_until_finished()
    ac.close()
    assert store.committed_steps() == [10, 11], store.committed_steps()
    template = {"params": {"w": TensorSpec((64, 16), torch.float32,
                                           torch.device("cpu"), mesh,
                                           sh.placements)},
                "opt": {"mu": {"w": TensorSpec((64, 16), torch.float32,
                                               torch.device("cpu"), mesh,
                                               sh.placements)}},
                "step": 0}
    (region,) = shd.addressable_shard_spans(mesh, sh.placements, (64, 16))
    rows = slice(*region[0])

    def dequant(a):
        q, scale = ser.quantize(a, "int8")
        return ser.finish_payload(q, dtype_name="float32", quant="int8",
                                  scale=scale)

    for step in (10, 11):
        got, man = store.restore(template, step=step, streaming=True)
        assert got["step"] == step and man.step == step
        want = {n: v.numpy() for n, v in whole(step).items()}
        # the periodic save quantizes each piece on the host, the urgent
        # one the whole tensor with its all-reduced scale
        mu = (dequant(want["opt/mu/w"][rows]) if step == 10
              else dequant(want["opt/mu/w"])[rows])
        assert np.array_equal(got["params"]["w"].to_local().numpy(),
                              want["params/w"][rows]), step
        assert np.array_equal(got["opt"]["mu"]["w"].to_local().numpy(),
                              mu), step
    dist.destroy_process_group()
    print("OK")
""")


@pytest.mark.timeout(120)
def test_urgent_save_while_a_periodic_save_is_in_flight(tmp_path):
    """Two gloo ranks: the periodic save of step 10 is held on rank 0
    before its write while rank 1 waits for it at a barrier, and an urgent
    save of step 11 (its quantize's reduce, its gather, its commit) runs
    meanwhile. Both commit, and each step restores its own state."""
    env = dict(os.environ, PYTHONPATH=SRC, GLOO_SOCKET_IFNAME="lo")
    init = f"file://{tmp_path / 'rdv'}"
    procs = [subprocess.Popen([sys.executable, "-c", CONCURRENT_SAVES, str(r),
                               init, str(tmp_path / "store")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for r in range(2)]
    try:
        outs = [p.communicate(timeout=90) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out + err[-3000:]
        assert out.strip().splitlines()[-1] == "OK", out
