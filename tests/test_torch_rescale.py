"""The port's elastic planning and rescale-stable fingerprints held against
the reference's (twins of the rescale cases of ``tests/test_pod_restore.py``:
``TestMemberAddressable`` and ``TestRescaleStableFingerprints``).

Plans and ownership predicates are plain Python in both packages and must
agree span for span. The fingerprint cases drive the port's
``DeviceDeltaTracker`` on CPU tensors (its fingerprints through the plain
version) through a 2 -> 3 -> 2 rescale and a model-parallel re-plan, next to
the reference's tracker on the same state, and compare what each keeps,
drops and copies, and the restored bits.
"""

from __future__ import annotations

import importlib
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

PKG_ROOTS = {"reference": "repro", "port": "repro_torch"}
CHUNK = 2048                     # 8 rows of a (*, 64) float32 leaf per chunk


def _load(root: str) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")
    return SimpleNamespace(checkpoint=mod("checkpoint"),
                           elastic=mod("core.elastic"))


PKGS = {name: _load(root) for name, root in PKG_ROOTS.items()}


@pytest.fixture(params=list(PKGS))
def pkg(request):
    return PKGS[request.param]


class TestPlans:
    @pytest.mark.parametrize("n,mp", [(1, 1), (2, 1), (3, 1), (4, 2), (6, 3)])
    def test_fleet_plans_alike(self, n, mp):
        plans = {name: pkg.elastic.fleet_mesh_plan(n, model_parallel=mp)
                 for name, pkg in PKGS.items()}
        assert plans["port"].shape == plans["reference"].shape == (n // mp, mp)
        assert plans["port"].axes == plans["reference"].axes

    def test_indivisible_capacity_rejected(self, pkg):
        with pytest.raises(ValueError):
            pkg.elastic.fleet_mesh_plan(3, model_parallel=2)
        with pytest.raises(ValueError):
            pkg.elastic.fleet_mesh_plan(0)

    def test_hosts_per_instance_multiply(self):
        shapes = {name: pkg.elastic.fleet_mesh_plan(
            3, hosts_per_instance=4, model_parallel=2).shape
            for name, pkg in PKGS.items()}
        assert shapes["port"] == shapes["reference"] == (6, 2)


class TestMemberAddressable:
    def test_dp_only_owns_everything(self, pkg):
        owns = pkg.elastic.member_addressable(
            pkg.elastic.fleet_mesh_plan(3, model_parallel=1), 1)
        assert owns("w", 0, 10_000, 10_000)
        assert owns("w", 123, 456, 10_000)

    def test_model_parallel_partitions_byte_spans(self, pkg):
        plan = pkg.elastic.MeshPlan((1, 2), ("data", "model"))
        m0 = pkg.elastic.member_addressable(plan, 0)
        m1 = pkg.elastic.member_addressable(plan, 1)
        assert m0("w", 0, 50, 100) and not m0("w", 50, 100, 100)
        assert m1("w", 50, 100, 100) and not m1("w", 0, 50, 100)
        assert not m0("w", 25, 75, 100) and not m1("w", 25, 75, 100)
        assert pkg.elastic.member_addressable(plan, 2)("w", 0, 50, 100)

    @pytest.mark.parametrize("shape", [(1, 2), (2, 3), (1, 4)])
    def test_ownership_alike_span_for_span(self, shape):
        spans = [(lo, hi, total) for total in (0, 7, 100, 4096)
                 for lo in range(0, max(total, 1), max(total // 8, 1))
                 for hi in (lo, lo + 1, total) if lo <= hi <= total]
        owns = {}
        for name, pkg in PKGS.items():
            plan = pkg.elastic.MeshPlan(shape, ("data", "model"))
            owns[name] = [[pkg.elastic.member_addressable(plan, m)("w", *s)
                           for s in spans] for m in range(shape[0] * shape[1])]
        assert owns["port"] == owns["reference"]


def _tracker_for(pkg, store):
    return pkg.checkpoint.DeviceDeltaTracker(
        store.pool, chunk_size=store.chunk_size, compress=store.compress,
        quantize_moments=store.quantize_moments)


def _bump(state, r):
    """The state with w[r, 0] += 1 (a new leaf object, as a step makes)."""
    w = state["w"].copy() if isinstance(state["w"], np.ndarray) else \
        state["w"].clone()
    w[r, 0] += 1.0
    return {**state, "w": w}


def _leaf(pkg, arr):
    if pkg is PKGS["port"]:
        return torch.from_numpy(arr.copy())
    import jax.numpy as jnp
    return jnp.asarray(arr)


def _as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rescale_2_3_2(pkg, root, rng_seed) -> dict:
    rng = np.random.default_rng(rng_seed)
    store = pkg.checkpoint.CheckpointStore(str(root), chunk_size=CHUNK)
    tracker = _tracker_for(pkg, store)
    state = {"w": rng.normal(size=(512, 64)).astype(np.float32),
             "b": rng.normal(size=(64 * 1024,)).astype(np.float32)}
    state = {k: _leaf(pkg, v) for k, v in state.items()}
    store.save(0, state, tracker=tracker)
    state = _bump(state, 0) if pkg is PKGS["port"] else \
        {**state, "w": state["w"].at[0, 0].add(1.0)}
    info1 = store.save(1, state, tracker=tracker)
    assert info1.d2h_bytes_skipped > 0
    results = []
    for n_alive in (3, 2):
        plan = pkg.elastic.fleet_mesh_plan(n_alive, model_parallel=1)
        res = tracker.rescale(pkg.elastic.member_addressable(plan, 0))
        assert res["dropped"] == 0 and res["kept"] >= 2
        results.append(res)
    assert tracker.stats["rescale_events"] == 2
    assert tracker.stats["fp_dropped"] == 0
    state = _bump(state, 1) if pkg is PKGS["port"] else \
        {**state, "w": state["w"].at[1, 0].add(1.0)}
    info2 = store.save(2, state, tracker=tracker)
    full = sum(_as_np(v).nbytes for v in state.values())
    assert info2.d2h_bytes_skipped > 0 and info2.d2h_bytes < full / 2
    tpl = {k: np.zeros_like(_as_np(v)) for k, v in state.items()}
    got, man = store.restore(tpl)
    assert man.step == 2
    for k, v in state.items():
        np.testing.assert_array_equal(np.asarray(got[k]), _as_np(v))
    return {"rescales": results, "d2h": (info1.d2h_bytes, info2.d2h_bytes),
            "skipped": (info1.d2h_bytes_skipped, info2.d2h_bytes_skipped),
            "chunks": sorted(h for h, _p in store.pool.all_chunks())}


class TestRescaleStableFingerprints:
    def test_2_3_2_rescale_keeps_fingerprints_and_delta_win(self, tmp_path):
        runs = {name: _rescale_2_3_2(pkg, tmp_path / name, 0)
                for name, pkg in PKGS.items()}
        assert runs["port"] == runs["reference"]

    def test_rescale_drops_only_nonaddressable_spans(self, tmp_path, pkg):
        rng = np.random.default_rng(1)
        store = pkg.checkpoint.CheckpointStore(str(tmp_path), chunk_size=CHUNK)
        tracker = _tracker_for(pkg, store)
        w = rng.normal(size=(512, 64)).astype(np.float32)
        state = {"w": _leaf(pkg, w)}
        store.save(0, state, tracker=tracker)
        w[0, 0] += 1.0
        state = {"w": _leaf(pkg, w)}
        store.save(1, state, tracker=tracker)
        plan = pkg.elastic.MeshPlan((1, 2), ("data", "model"))
        res = tracker.rescale(pkg.elastic.member_addressable(plan, 1))
        assert res["kept"] == 0 and res["dropped"] >= 1
        info = store.save(2, state, tracker=tracker)
        assert info.d2h_bytes >= w.nbytes
        got, _ = store.restore({"w": np.zeros((512, 64), np.float32)})
        np.testing.assert_array_equal(np.asarray(got["w"]), w)
