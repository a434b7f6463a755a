"""The port's pod-scale sharded checkpoint held against the reference's
(twins of ``tests/test_pod_restore.py`` and ``tests/test_sharded_elastic.py``).

Region reads run both packages on the same save and compare the bits and
``region_stats`` case for case. The multi-device cases run gloo worlds of
CPU ranks (``python -c`` processes with a ``file://`` rendezvous under the
test's directory, each world with its own time limit) beside the
reference's fake host devices:

* the reference saves a ``(2, 2)``-sharded state on 4 devices; port worlds
  of 4 ranks (onto ``(4, 1)``) and 2 ranks (onto ``(1, 2)`` and ``(2, 1)``)
  restore it bit for bit, streaming and serial, through multi-piece
  fallback reads;
* 4 port ranks save a state under ``tree_shardings(elastic_rules(fsdp=True))``
  on ``(2, 2)`` (a periodic and an urgent save, its moments quantized on
  each rank's shard with the all-reduced scale); the reference restores it
  bit for bit, its own save of the same state and sharding names the same
  chunks and records, and the int8 payloads equal a host quantize of each
  whole tensor; 2 port ranks restore it onto ``(1, 2)``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro.checkpoint import CheckpointStore as JaxStore  # noqa: E402
from repro.checkpoint import manifest as jmf  # noqa: E402
from repro.checkpoint import serialize as jser  # noqa: E402
from repro.distributed import addressable_shard_spans as jax_spans  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.checkpoint import manifest as mf  # noqa: E402
from repro_torch.distributed import addressable_shard_spans  # noqa: E402
from repro_torch.launch.mesh import make_mesh, mesh_info  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
CHUNK = 2048                     # 8 rows of a (*, 64) float32 leaf per chunk
WORLD_TIMEOUT_S = 120


def _state(rng, *, rows=256, cols=64):
    # one compressible leaf (zlib chunks) + one incompressible (raw chunks)
    ramp = np.tile(np.arange(cols, dtype=np.float32), (rows, 1))
    return {"ramp": ramp,
            "noise": rng.normal(size=(rows, cols)).astype(np.float32)}


@pytest.fixture
def saved(tmp_path, rng):
    """The same state saved by both packages: (state, {pkg: reader})."""
    state = _state(rng)
    readers = {}
    for name, cls in (("reference", JaxStore), ("port", CheckpointStore)):
        store = cls(str(tmp_path / name), chunk_size=CHUNK)
        store.save(3, state)
        readers[name] = store.latest_valid()[1]
    yield state, readers
    for r in readers.values():
        r.close()


class TestRegionReads:
    def test_manifest_carries_shard_span_map(self, saved):
        _state_, readers = saved
        for name in ("ramp", "noise"):
            recs = {p: r.single_piece_record(name) for p, r in readers.items()}
            rec = recs["port"]
            assert rec is not None and "chunks" in rec and "shard_spans" in rec
            spans = mf.record_shard_spans(rec)
            assert spans == jmf.record_shard_spans(recs["reference"])
            assert len(spans) == len(rec["chunks"])
            assert spans[0][0] == 0 and spans[-1][1] == rec["shape"][0]

    @pytest.mark.parametrize("region_rows", [(0, 256), (8, 16), (3, 29),
                                             (248, 256), (0, 1)])
    def test_region_read_bit_identical(self, saved, region_rows):
        state, readers = saved
        a, b = region_rows
        for name in ("ramp", "noise"):
            region = ((a, b), (0, 64))
            got = readers["port"].read_region_streaming(name, region)
            assert got is not None
            np.testing.assert_array_equal(got, state[name][a:b])
            np.testing.assert_array_equal(
                got, readers["port"].read_slice(name, region))
            np.testing.assert_array_equal(
                got, readers["reference"].read_region_streaming(name, region))
        assert readers["port"].region_stats == readers["reference"].region_stats

    def test_small_region_skips_chunks(self, saved):
        state, readers = saved
        for r in readers.values():
            got = r.read_region_streaming("noise", ((8, 16), (0, 64)))
            np.testing.assert_array_equal(got, state["noise"][8:16])
        st = readers["port"].region_stats
        assert st == readers["reference"].region_stats
        assert st["region_reads"] == 1
        assert st["chunks_decoded"] <= 2
        assert st["chunks_skipped"] >= 30

    def test_prefix_sum_path_matches_span_map(self, saved):
        state, readers = saved
        for r in readers.values():
            rec = r.single_piece_record("noise")
            assert rec.pop("shard_spans", None) is not None
            got = r.read_region_streaming("noise", ((3, 29), (0, 64)))
            np.testing.assert_array_equal(got, state["noise"][3:29])
        assert readers["port"].region_stats["chunks_skipped"] > 0
        assert readers["port"].region_stats == readers["reference"].region_stats

    def test_corrupt_span_map_is_rejected_not_trusted(self, saved):
        state, readers = saved
        r = readers["port"]
        rec = r.single_piece_record("noise")
        rec["shard_spans"] = rec["shard_spans"][:-1]
        assert mf.record_shard_spans(rec) is None
        got = r.read_region_streaming("noise", ((8, 16), (0, 64)))
        np.testing.assert_array_equal(got, state["noise"][8:16])
        n = len(rec["chunks"])
        rec["shard_spans"] = [[i * 100 + 50, i * 100] for i in range(n)]
        assert mf.record_shard_spans(rec) is None
        assert jmf.record_shard_spans(rec) is None

    def test_trailing_axis_slice_falls_back(self, saved):
        state, readers = saved
        region = ((0, 8), (0, 32))   # not flat-contiguous in C order
        for r in readers.values():
            assert r.read_region_streaming("noise", region) is None
            got = r.read_region_for_restore("noise", region)
            np.testing.assert_array_equal(np.asarray(got),
                                          state["noise"][0:8, 0:32])
        assert readers["port"].region_stats["fallback_reads"] == 1
        assert readers["port"].region_stats == readers["reference"].region_stats

    def test_v1_records_fall_back(self, tmp_path, rng):
        state = _state(rng, rows=32)
        stats = {}
        for name, cls in (("reference", JaxStore), ("port", CheckpointStore)):
            store = cls(str(tmp_path / name), mode="full")
            store.save(1, state)
            _man, reader = store.latest_valid()
            try:
                assert reader.read_region_streaming(
                    "noise", ((0, 8), (0, 64))) is None
                got = reader.read_region_for_restore("noise", ((0, 8), (0, 64)))
                np.testing.assert_array_equal(np.asarray(got), state["noise"][:8])
                stats[name] = dict(reader.region_stats)
            finally:
                reader.close()
        assert stats["port"]["fallback_reads"] == 1
        assert stats["port"] == stats["reference"]

    def test_chunk_byte_offsets_and_span_map_helpers(self):
        rec = {"chunks": [{"r": 100}, {"r": 100}, {"r": 56}]}
        assert mf.chunk_byte_offsets(rec) == [0, 100, 200, 256]
        spans = mf.shard_span_map((16, 4), 16, [100, 100, 56])
        assert spans == [[0, 7], [6, 13], [12, 16]]
        assert mf.shard_span_map((), 16, [100]) is None
        assert mf.shard_span_map((16, 4), 0, [100]) is None

    @pytest.mark.parametrize("region", [((0, 256), (0, 64)), ((8, 16), (0, 64)),
                                        ((3, 29), (0, 64)), ((0, 8), (0, 32))])
    def test_region_payload_for_the_sharded_restore(self, saved, region):
        # the sharded restore's read: the region's stored payload; a row band
        # is range-addressed, a trailing-axis slice assembles from its piece
        state, readers = saved
        r = readers["port"]
        got, dtype_name, quant, scale = r.read_region_payload("noise", region)
        assert (dtype_name, quant, scale) == ("float32", "", None)
        np.testing.assert_array_equal(
            got, state["noise"][tuple(slice(a, b) for a, b in region)])
        st = r.region_stats
        row_band = region[1] == (0, 64)         # the whole leaf is one too
        assert st["region_reads"] == int(row_band)
        (rec,) = r.by_name["noise"]
        assert 0 < st["chunks_decoded"] <= len(rec["chunks"])
        if row_band:        # a band decodes only its chunks, the leaf all
            assert ((st["chunks_decoded"] == len(rec["chunks"]))
                    == (region == ((0, 256), (0, 64))))
        assert st["fallback_reads"] == int(region[1] != (0, 64))


class TestAddressableShardSpans:
    def test_single_device_whole_leaf(self):
        import jax
        from torch.distributed.tensor import Replicate
        x = jax.device_put(np.arange(12, dtype=np.float32).reshape(3, 4))
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        spans = addressable_shard_spans(mesh, (Replicate(), Replicate()), (3, 4))
        assert spans == jax_spans(x.sharding, (3, 4)) == [((0, 3), (0, 4))]
        assert mesh_info(mesh) == {"shape": [1, 1], "axes": ["data", "model"]}


# ---------------------------------------------------------------------------
# gloo worlds of CPU ranks beside the reference's fake devices
# ---------------------------------------------------------------------------

STATE_SRC = textwrap.dedent("""
    import numpy as np
    BF16 = ("params/wq", "ref/w")

    def port_state():
        # a train state's layout; "wq" column-parallel, "conv" sharded on
        # its channel dim, "norm" data-sharded only (replicated on "model")
        rng = np.random.default_rng(7)
        params = {
            # bf16-exact values: k / 64 with |k| <= 125
            "wq": (((np.arange(64 * 64) % 251) - 125) / 64).astype(
                np.float32).reshape(64, 64),
            "conv": rng.normal(size=(2, 32, 16)).astype(np.float32),
            "norm": rng.normal(size=(64,)).astype(np.float32),
        }
        return {"params": params,
                "opt": {"mu": {k: v * 0.5 for k, v in params.items()},
                        "nu": {k: v * v for k, v in params.items()}}}

    def ref_state():
        rng = np.random.default_rng(11)
        w = np.arange(256, dtype=np.float32).reshape(16, 16)
        return {"w": w, "b": np.ones((16,), np.float32), "mu": w * 0.5,
                "noise": rng.normal(size=(64, 32)).astype(np.float32)}

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}/"))
            else:
                out[f"{prefix}{k}"] = v
        return out

    def unflat(named):
        out = {}
        for n, v in named.items():
            d = out
            *path, leaf = n.split("/")
            for p in path:
                d = d.setdefault(p, {})
            d[leaf] = v
        return out

    REF_SPECS = {"w": ("data", "model"), "b": (None,), "mu": ("data", "model"),
                 "noise": ("data", None)}
""")

REF_SAVE = STATE_SRC + textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.checkpoint import CheckpointStore
    from repro.launch.mesh import make_mesh

    mesh = make_mesh((2, 2), ("data", "model"))
    state = {}
    for n, v in ref_state().items():
        x = jnp.asarray(v).astype(jnp.bfloat16 if "ref/" + n in BF16 else v.dtype)
        state[n] = jax.device_put(x, NamedSharding(mesh, P(*REF_SPECS[n])))
    state["step"] = 11
    CheckpointStore(sys.argv[1], chunk_size=2048).save(11, state)
    print("REF_SAVED")
""")

PORT_WORLD = STATE_SRC + textwrap.dedent("""
    import json, os, sys
    import torch, torch.distributed as dist
    rank, world, init, ref_dir, port_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                            *sys.argv[3:6])
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.checkpoint import (AsyncCheckpointer, CheckpointStore,
                                        TensorSpec)
    from repro_torch.checkpoint import serialize as ser
    from repro_torch.core.elastic import MeshPlan, elastic_restore
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels.quantize.ref import (dequantize_int8_ref,
                                                  quantize_with_inv_ref)
    from repro_torch.launch.mesh import make_mesh

    out = {"rank": rank}
    cpu = torch.device("cpu")

    def tensor(name, v):
        t = torch.from_numpy(np.ascontiguousarray(v))
        return t.to(torch.bfloat16) if name in BF16 else t

    def same(a, b):
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        return a.shape == b.shape and torch.equal(a, b)

    def region_of(t):
        (reg,) = shd.addressable_shard_spans(t.device_mesh, t.placements, t.shape)
        return tuple(slice(a, b) for a, b in reg)

    def dequant_whole(t):
        scale, inv = ser.int8_scale_inv(np.float32(t.abs().max().item()))
        return dequantize_int8_ref(quantize_with_inv_ref(t, inv), scale,
                                   dtype=t.dtype)

    def port_shardings(mesh):
        rules = shd.elastic_rules(mesh, fsdp=True)
        return shd.tree_shardings(unflat({n: torch.empty(v.shape)
                                          for n, v in flat(port_state()).items()}),
                                  rules)

    def port_template(mesh):
        sh = flat(port_shardings(mesh))
        return unflat({n: TensorSpec(v.shape, tensor(n, v).dtype,
                                     cpu, mesh, sh[n].placements)
                       for n, v in flat(port_state()).items()})

    def ref_template(mesh, specs):
        named = {n: TensorSpec(v.shape, tensor("ref/" + n, v).dtype, cpu, mesh,
                               shd.placements(specs[n], mesh))
                 for n, v in ref_state().items()}
        named["step"] = 0
        return named

    def check_ref(got, tag):
        want = ref_state()
        assert got["step"] == 11, tag
        for n, v in want.items():
            t = got[n]
            assert same(t.to_local(), tensor("ref/" + n, v)[region_of(t)]), (tag, n)
        out[tag] = "ok"

    def check_port(got, tag):
        for n, v in flat(port_state()).items():
            t = flat(got)[n]
            full = tensor(n, v)
            if "/mu/" in n or "/nu/" in n:
                full = dequant_whole(full)
            assert same(t.to_local(), full[region_of(t)]), (tag, n)
        out[tag] = "ok"

    if world == 4:
        # the reference's (2, 2) save restored onto (4, 1): streaming,
        # serial, and the region reads of a multi-piece record
        mesh41 = MeshPlan((4, 1), ("data", "model")).build(device_type="cpu")
        specs = {"w": ("data", "model"), "b": ("data",), "mu": (None, "model"),
                 "noise": ("data", None)}
        ref_store = CheckpointStore(ref_dir)
        got, man = elastic_restore(ref_store, lambda m: ref_template(m, specs),
                                   mesh41, streaming=True)
        check_ref(got, "ref_onto_4x1_streaming")
        out["ref_stats_4x1"] = ref_store.last_region_stats
        got_serial, _ = ref_store.restore(ref_template(mesh41, specs))
        check_ref(got_serial, "ref_onto_4x1_serial")
        _man, reader = ref_store.latest_valid()
        (band,) = shd.addressable_shard_spans(mesh41, shd.placements(
            specs["noise"], mesh41), (64, 32))
        out["multi_piece_streaming"] = reader.read_region_streaming("noise", band)
        a = reader.read_region_for_restore("noise", band)
        assert np.array_equal(a, ref_state()["noise"][band[0][0]:band[0][1]])
        out["multi_piece_fallbacks"] = reader.region_stats["fallback_reads"]
        reader.close()

        # the port's own save on (2, 2): a periodic and an urgent save
        mesh22 = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        sh = flat(port_shardings(mesh22))
        state = unflat({n: shd.distribute(tensor(n, v), sh[n])
                        for n, v in flat(port_state()).items()})
        # the port's regions are DTensor's own: distribute_tensor (a
        # scatter over the group) gives each rank the same shard
        for n, v in flat(port_state()).items():
            d = distribute_tensor(tensor(n, v), mesh22, sh[n].placements)
            mine = flat(state)[n]
            assert d.to_local().shape == mine.to_local().shape, n
            assert same(d.to_local(), mine.to_local()), n
        spans = shd.addressable_shard_spans(mesh22, shd.placements(
            ("data", None), mesh22), (64, 32))
        every = [None] * world
        dist.all_gather_object(every, spans)
        out["bands_2x2"] = sorted({tuple(map(tuple, s[0])) for s in every})
        store = CheckpointStore(port_dir, chunk_size=512, compress=False,
                                quantize_moments=True)
        info = store.save(10, state)
        ac = AsyncCheckpointer(store)
        urgent = ac.save_urgent(11, state)
        ac.close()
        out["saved"] = [info.step, urgent.step, urgent.kind]
        got, man = store.restore(port_template(mesh41), streaming=True)
        check_port(got, "port_onto_4x1")
        out["port_stats_4x1"] = store.last_region_stats
    else:
        mesh12 = MeshPlan((1, 2), ("data", "model")).build(device_type="cpu")
        mesh21 = MeshPlan((2, 1), ("data", "model")).build(device_type="cpu")
        specs12 = {"w": (None, "model"), "b": (None,), "mu": ("data", "model"),
                   "noise": (None, "model")}
        specs21 = {"w": ("data", "model"), "b": ("data",), "mu": ("data", None),
                   "noise": ("data", None)}
        ref_store = CheckpointStore(ref_dir)
        got, _ = elastic_restore(ref_store, lambda m: ref_template(m, specs12),
                                 mesh12, streaming=True)
        check_ref(got, "ref_onto_1x2")
        out["ref_stats_1x2"] = ref_store.last_region_stats
        got, _ = elastic_restore(ref_store, lambda m: ref_template(m, specs21),
                                 mesh21, streaming=True)
        check_ref(got, "ref_onto_2x1")
        port_store = CheckpointStore(port_dir)
        got, man = elastic_restore(port_store, port_template, mesh12,
                                   streaming=True)
        assert (man.step, man.kind) == (11, "termination")
        check_port(got, "port_onto_1x2")
        out["port_stats_1x2"] = port_store.last_region_stats
        # a full-mode save by both ranks: one shard file each, one manifest
        full_dir = os.path.join(os.path.dirname(port_dir), "full")
        full = CheckpointStore(full_dir, mode="full")
        info = full.save(12, got)
        out["full_files"] = sorted(os.listdir(info.path))
        back, _ = full.restore(port_template(mesh21), streaming=True)
        check_port(back, "full_onto_2x1")
    dist.destroy_process_group()
    print(json.dumps(out, default=lambda o: None if o is None else str(o)))
""")

REF_CHECK = STATE_SRC + textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding
    from repro.checkpoint import CheckpointStore
    from repro.checkpoint import serialize as ser
    from repro.distributed.sharding import elastic_rules, tree_shardings
    from repro.launch.mesh import make_mesh

    port_dir, ref_dir = sys.argv[1], sys.argv[2]
    out = {}
    named = flat(port_state())
    cast = lambda n, v: np.asarray(jnp.asarray(v).astype(
        jnp.bfloat16 if n in BF16 else v.dtype))
    # the port's urgent save (step 11) restored bit for bit, on one device
    # and onto a (2, 2) mesh of this process's fake devices
    mesh = make_mesh((2, 2), ("data", "model"))
    shardings = jax.tree.map(lambda s: s, tree_shardings(
        unflat({n: jax.ShapeDtypeStruct(v.shape, cast(n, v).dtype)
                for n, v in named.items()}), elastic_rules(mesh, fsdp=True)))
    store = CheckpointStore(port_dir)
    for step in (11, 10):
        got, man = store.restore(unflat({n: np.zeros_like(cast(n, v))
                                         for n, v in named.items()}), step=step)
        got_sh, _ = store.restore(unflat({
            n: jax.ShapeDtypeStruct(v.shape, cast(n, v).dtype,
                                    sharding=flat(shardings)[n])
            for n, v in named.items()}), step=step, streaming=True)
        for n, v in named.items():
            want = cast(n, v)
            if step == 11 and ("/mu/" in n or "/nu/" in n):
                q, scale = ser.quantize(want, "int8")
                want = ser.finish_payload(q, dtype_name="float32", quant="int8",
                                          scale=scale)
            g = np.asarray(flat(got)[n])
            if step == 10 and ("/mu/" in n or "/nu/" in n):
                continue        # quantized per piece on the host
            assert g.tobytes() == want.tobytes(), (step, n)
            assert np.asarray(flat(got_sh)[n]).tobytes() == want.tobytes(), (step, n)
        out[f"restored_{step}"] = man.kind
    # the reference's own periodic save of the same state and sharding
    state = unflat({n: jax.device_put(jnp.asarray(cast(n, v)), flat(shardings)[n])
                    for n, v in named.items()})
    CheckpointStore(ref_dir, chunk_size=512, compress=False,
                    quantize_moments=True).save(10, state)
    print(json.dumps(out))
""")


def _spawn(args_list, env, timeout=WORLD_TIMEOUT_S):
    procs = [subprocess.Popen([sys.executable, "-c", *a], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for a in args_list]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    return [out.strip().splitlines()[-1] for out, _err in outs]


def _world(n, init, ref_dir, port_dir, env):
    return [json.loads(line) for line in _spawn(
        [[PORT_WORLD, str(r), str(n), init, ref_dir, port_dir]
         for r in range(n)], env)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    td = tmp_path_factory.mktemp("pod")
    ref_dir, port_dir, ref_same = (str(td / d) for d in ("ref", "port", "ref_same"))
    env = dict(os.environ, PYTHONPATH=SRC, GLOO_SOCKET_IFNAME="lo")
    env.pop("JAX_PLATFORMS", None)
    env["JAX_PLATFORMS"] = "cpu"
    assert _spawn([[REF_SAVE, ref_dir]], env) == ["REF_SAVED"]
    four = _world(4, f"file://{td / 'rdv4'}", ref_dir, port_dir, env)
    two = _world(2, f"file://{td / 'rdv2'}", ref_dir, port_dir, env)
    ref = json.loads(_spawn([[REF_CHECK, port_dir, ref_same]], env)[0])
    return {"four": four, "two": two, "ref": ref, "port_dir": port_dir,
            "ref_same": ref_same}


def _manifest(root, step):
    return jmf.read_manifest(os.path.join(root, jmf.step_dirname(step)))


class TestPodWorlds:
    def test_reference_save_restores_on_four_ranks(self, worlds):
        for r in worlds["four"]:
            assert r["ref_onto_4x1_streaming"] == r["ref_onto_4x1_serial"] == "ok"
            # every leaf was saved as (2, 2) pieces: multi-piece regions
            assert r["ref_stats_4x1"]["fallback_reads"] >= 1

    def test_reference_save_restores_on_two_ranks(self, worlds):
        for r in worlds["two"]:
            assert r["ref_onto_1x2"] == r["ref_onto_2x1"] == "ok"
            assert r["ref_stats_1x2"]["fallback_reads"] >= 1

    def test_multi_piece_record_falls_back(self, worlds):
        for r in worlds["four"]:
            assert r["multi_piece_streaming"] is None
            assert r["multi_piece_fallbacks"] >= 1

    def test_bands_of_a_row_sharded_leaf(self, worlds):
        # ("data", None) on (2, 2): two distinct row bands over four ranks
        for r in worlds["four"]:
            assert r["bands_2x2"] == [[[0, 32], [0, 32]], [[32, 64], [0, 32]]]

    def test_port_save_restores_on_port_worlds(self, worlds):
        for r in worlds["four"]:
            assert r["saved"] == [10, 11, "termination"]
            assert r["port_onto_4x1"] == "ok"
        for r in worlds["two"]:
            assert r["port_onto_1x2"] == "ok"
            st = r["port_stats_1x2"]
            # (1, 2) regions cover whole saved pieces: the other half's
            # pieces are skipped
            assert st["chunks_skipped"] > 0 and st["chunks_decoded"] > 0

    def test_full_mode_save_by_ranks(self, worlds):
        for r in worlds["two"]:
            assert r["full_files"] == ["COMMITTED", "manifest.json",
                                       "shard_p000.spot", "shard_p001.spot"]
            assert r["full_onto_2x1"] == "ok"

    def test_port_save_restores_in_the_reference(self, worlds):
        assert worlds["ref"] == {"restored_11": "termination",
                                 "restored_10": "transparent"}

    def test_both_packages_write_the_same_chunks_and_records(self, worlds):
        port, ref = (_manifest(worlds[k], 10) for k in ("port_dir", "ref_same"))
        assert port.chunk_hashes() == ref.chunk_hashes()
        strip = lambda m: [(t["name"], t["index"], t["global_shape"], t["shape"],
                            t["codec"], t.get("scale"),
                            [c["h"] for c in t["chunks"]]) for t in m.tensors]
        assert strip(port) == strip(ref)

    def test_sharded_int8_payload_is_a_whole_tensor_quantize(self, worlds):
        from repro_torch.checkpoint import CheckpointStore
        ns = {}
        exec(STATE_SRC, ns)
        _man, reader = CheckpointStore(worlds["port_dir"]).latest_valid()
        try:
            moments = [n for n in ns["flat"](ns["port_state"]())
                       if "/mu/" in n or "/nu/" in n]
            for n in moments:
                whole = ns["flat"](ns["port_state"]())[n]
                recs = reader.by_name[n]
                assert len(recs) > 1 or n.endswith("norm")
                got, _dt, quant, scale = reader.read_region_payload(
                    n, tuple((0, s) for s in whole.shape))
                q, want_scale = jser.quantize(whole, "int8")
                assert quant == "int8" and np.float32(scale) == want_scale, n
                np.testing.assert_array_equal(got, q, err_msg=n)
        finally:
            reader.close()
