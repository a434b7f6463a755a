"""The port's sharding rules held against the reference's, in one process.

Every parameter leaf of all ten architectures' full configs (shapes from
both packages' ``models/model.py`` specs, meta tensors on the port's side)
and every decode-cache leaf gets the same spec from both packages, on
(16, 16), (4, 2), (2, 4) and (1, 8) ``("data", "model")`` meshes and a
(2, 16, 16) ``("pod", "data", "model")`` mesh, with the rule flags off,
``fsdp``, ``pure_fsdp`` and ``seq_parallel``; so do the activation specs and
MoE's routing groups. The reference's rules read only ``mesh.shape`` and
``axis_names``, so a stand-in serves on its side; the port's side uses a
``DeviceMesh`` on torch's ``fake`` process group (test-only). The placements
of a dim sharded over several axes are held to JAX's ``devices_indices_map``
on eight fake host devices, in a subprocess.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.device_mesh import DeviceMesh  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402

from repro.checkpoint import serialize as jser  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import serialize as tser  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "1x8": ((1, 8), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# meshes of the placement and writer cases (not of the spec comparisons)
SMALL_MESHES = {"2x2x2": ((2, 2, 2), ("pod", "data", "model")),
                "2x2": ((2, 2), ("data", "model"))}
FLAGS = {"plain": {}, "fsdp": {"fsdp": True}, "pure_fsdp": {"pure_fsdp": True},
         "seq_parallel": {"seq_parallel": True}}


@pytest.fixture(scope="module", autouse=True)
def fake_group():
    """A 512-rank process group on torch's ``fake`` backend: DeviceMeshes
    of any of the shapes above, with this process as rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
    try:
        yield
    finally:
        dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _mesh(key: str, rank: int = 0) -> DeviceMesh:
    shape, axes = {**MESHES, **SMALL_MESHES}[key]
    ranks = torch.arange(int(np.prod(shape))).reshape(shape)
    if rank == 0:
        return DeviceMesh("cpu", ranks, mesh_dim_names=axes)
    return DeviceMesh("cpu", ranks, mesh_dim_names=axes, _init_backend=False,
                      _rank=rank)


def rules_pair(key: str, flags: dict):
    """(port rules, reference rules) for one mesh and flag set."""
    shape, axes = MESHES[key]
    data_axes = tuple(a for a in axes if a != "model")
    stand_in = SimpleNamespace(shape=dict(zip(axes, shape)), axis_names=axes)
    return (shd.ShardingRules(mesh=_mesh(key), data_axes=data_axes, **flags),
            jsh.ShardingRules(mesh=stand_in, data_axes=data_axes, **flags))


@functools.lru_cache(maxsize=None)
def _specs(arch: str):
    """(port params, reference params, port caches, reference caches) of
    ``arch``'s full config, flattened: {name: shape}."""
    jc, tc = jax_get_config(arch), tconfigs.get_config(arch)
    flat_t = lambda tree: {n: tuple(t.shape) for n, t in
                           tser.flatten_state(tree).items()}
    flat_j = lambda tree: {n: tuple(t.shape) for n, t in
                           jser.flatten_state(tree).items()}
    return (flat_t(tmodel.param_specs(tc)), flat_j(jax_model.param_specs(jc)),
            flat_t(tmodel.cache_specs(tc, 16, 4096)),
            flat_j(jax_model.cache_specs(jc, 16, 4096)))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, mesh):
    tparams, jparams, _tc, _jc = _specs(arch)
    assert tparams == jparams
    for flags in FLAGS.values():
        rules, jrules = rules_pair(mesh, flags)
        for name, shape in tparams.items():
            for path in (name, f"opt/mu/{name}"):
                got = shd.param_pspec(path, shape, rules)
                assert got == tuple(jsh.param_pspec(path, shape, jrules)), \
                    (path, shape, flags)
                assert len(got) == len(shape)
                # every spec places: each mesh axis shards at most one dim
                shd.placements(got, rules.mesh)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_reference(arch, mesh):
    _tp, _jp, tcache, jcache = _specs(arch)
    assert tcache == jcache
    for flags in FLAGS.values():
        rules, jrules = rules_pair(mesh, flags)
        for name, shape in tcache.items():
            leaf = name.rsplit("/", 1)[-1]
            for s in (shape, (shape[0], 3, *shape[2:]) if len(shape) > 1 else shape):
                got = shd.cache_pspec(leaf, s, rules)
                assert got == tuple(jsh.cache_pspec(leaf, s, jrules)), (name, s, flags)


ACTIVATIONS = [
    ("residual", (16, 4096, 3072)), ("residual", (1, 4096, 3072)),
    ("residual", (32, 1, 3072)), ("heads", (16, 4096, 32, 96)),
    ("kv_heads", (16, 4096, 4, 256)), ("heads", (16, 1, 24, 64)),
    ("heads", (16, 4096, 24, 64)), ("kv_heads", (3, 4096, 1, 256)),
    ("logits", (16, 4096, 32064)), ("logits", (16, 32064)),
    ("logits", (16, 1, 32000)), ("logits", (16, 4096, 256000)),
    ("ffn", (16, 4096, 8192)), ("ffn", (16, 4096, 24)),
    ("moe_groups", (32, 512, 2048)), ("moe_groups", (3, 512, 2048)),
    ("moe_experts", (32, 64, 80, 2048)), ("moe_experts", (32, 8, 80, 6144)),
    ("embeddings", (16, 4096, 3072)),
]


@pytest.fixture
def captured(monkeypatch):
    """The reference's activation constraints, captured as their specs."""
    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", lambda x, s: s)


@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_activation_specs_match_reference(mesh, flags, captured):
    rules, jrules = rules_pair(mesh, FLAGS[flags])
    for name, shape in ACTIVATIONS:
        stub = SimpleNamespace(shape=shape, ndim=len(shape))
        with jsh.use_sharding_rules(jrules):
            want = jsh.shard_act(stub, name)
        got = shd.act_spec(shape, name, rules)
        assert got == (None if want is stub else tuple(want)), (name, shape)
    for shape in ((4, 16, 128), (2, 3, 5), (8,)):
        stub = SimpleNamespace(shape=shape, ndim=len(shape))
        with jsh.use_sharding_rules(jrules):
            want = jsh.shard_microbatched({"x": stub})["x"]
        got = shd.microbatch_spec(shape, rules)
        assert got == (None if want is stub else tuple(want)), shape
    for batch in (1, 3, 16, 64):
        assert shd.batch_spec(rules, batch) == tuple(jsh.batch_spec(jrules, batch))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_elastic_rules_match_reference(mesh):
    rules, _ = rules_pair(mesh, {})
    shape, axes = MESHES[mesh]
    jrules = jsh.elastic_rules(SimpleNamespace(shape=dict(zip(axes, shape)),
                                               axis_names=axes), fsdp=True)
    got = shd.elastic_rules(rules.mesh, fsdp=True)
    for f in ("data_axes", "model_axis", "fsdp", "seq_parallel", "dp_size",
              "tp_size", "model_in_dp"):
        assert getattr(got, f) == getattr(jrules, f), f
    for dim in (1, 7, 16, 4096):
        assert got.dp_axes_for(dim) == jrules.dp_axes_for(dim)
        assert got.tp_axis_for(dim) == jrules.tp_axis_for(dim)


def test_one_axis_mesh_doubles_as_data():
    mesh = DeviceMesh("cpu", torch.arange(8), mesh_dim_names=("model",))
    r = shd.elastic_rules(mesh)
    assert r.data_axes == ("model",) and r.model_in_dp
    assert r.tp_axis_for(16) is None


@pytest.mark.parametrize("dp", [1, 2, 4, 16])
def test_moe_groups_follow_the_data_parallel_degree(dp):
    key = {1: "1x8", 2: "2x4", 4: "4x2", 16: "16x16"}[dp]
    rules, jrules = rules_pair(key, {})
    assert rules.dp_size == dp
    for tokens in (1, 3, 7, 12, 64, 4096, 8192, 12288, 65536, 4096 * 48):
        with jsh.use_sharding_rules(jrules):
            want = jmoe._n_groups(tokens)
        with shd.use_sharding_rules(rules):
            got = tmoe._n_groups(tokens)
        assert got == want, tokens
        assert tmoe._n_groups(tokens) == jmoe._n_groups(tokens)   # no rules


def test_current_rules_nest_and_reset():
    rules, _ = rules_pair("4x2", {})
    assert shd.current_rules() is None
    with shd.use_sharding_rules(rules):
        assert shd.current_rules() is rules
        with shd.use_sharding_rules(None):
            assert shd.current_rules() is None
        assert shd.current_rules() is rules
    assert shd.current_rules() is None


def test_placements_of_specs():
    mesh = _mesh("2x16x16")
    assert shd.placements((("pod", "data"), "model"), mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert shd.placements((None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        shd.placements((("data", "pod"), None), mesh)
    with pytest.raises(ValueError, match="twice"):
        shd.placements(("data", "data"), mesh)


SPAN_CASES = [((("pod", "data"), "model"), (8, 4)),
              ((("pod", "data"), None), (16, 6)),
              (("model", ("pod", "data")), (6, 8)),
              ((None, ("pod", "data", "model")), (3, 16)),
              (("data", None, "pod"), (4, 3, 2)),
              ((None,), (5,))]

JAX_SPANS = textwrap.dedent("""
    import os, json, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.launch.mesh import make_mesh
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    flat = list(mesh.devices.reshape(-1))
    out = []
    for spec, shape in json.loads(sys.argv[1]):
        spec = [tuple(e) if isinstance(e, list) else e for e in spec]
        imap = NamedSharding(mesh, P(*spec)).devices_indices_map(tuple(shape))
        by_rank = {}
        for dev, idx in imap.items():
            by_rank[flat.index(dev)] = [
                [0 if s.start is None else s.start, d if s.stop is None else s.stop]
                for s, d in zip(idx, shape)]
        out.append([by_rank[r] for r in range(8)])
    print(json.dumps(out))
""")


def test_nested_shards_give_jax_offsets():
    """A dim sharded over ("pod", "data") splits pod-major, as JAX's
    row-major ``devices_indices_map`` does, on every rank of a 2x2x2 mesh;
    and ``addressable_shard_spans`` agrees with DTensor's own offsets."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", JAX_SPANS,
                           json.dumps(SPAN_CASES)], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    for (spec, shape), per_rank in zip(SPAN_CASES, want):
        for rank in range(8):
            mesh = _mesh("2x2x2", rank)
            pl = shd.placements(spec, mesh)
            (got,) = shd.addressable_shard_spans(mesh, pl, shape)
            assert [list(s) for s in got] == per_rank[rank], (spec, rank)
            lshape, offset = compute_local_shape_and_global_offset(
                torch.Size(shape), mesh, pl)
            assert tuple(b - a for a, b in got) == tuple(lshape)
            assert tuple(a for a, _b in got) == tuple(offset)


def test_writer_is_the_first_replica():
    row = shd.placements(("data", None), _mesh("2x2"))
    writers = [r for r in range(4) if shd.is_writer(_mesh("2x2", r), row)]
    assert writers == [0, 2]              # model coordinate 0
    assert [shd.piece_number(_mesh("2x2", r), row) for r in writers] == [0, 1]
    full = (Replicate(), Replicate())
    assert [r for r in range(4) if shd.is_writer(_mesh("2x2", r), full)] == [0]
    both = shd.placements(("data", "model"), _mesh("2x2"))
    assert [shd.piece_number(_mesh("2x2", r), both) for r in range(4)] == [0, 1, 2, 3]


def test_shard_act_is_a_noop_without_rules_or_dtensor():
    x = torch.ones(4, 8, 16)
    assert shd.shard_act(x, "residual") is x
    rules, _ = rules_pair("4x2", {})
    with shd.use_sharding_rules(rules):
        assert shd.shard_act(x, "residual") is x
        assert shd.shard_microbatched({"x": x})["x"] is x


def test_shard_act_redistributes_a_dtensor():
    mesh = DeviceMesh("cpu", torch.arange(1).reshape(1, 1),
                      mesh_dim_names=("data", "model"))
    rules = shd.elastic_rules(mesh)
    x = DTensor.from_local(torch.arange(64.0).reshape(4, 4, 4), mesh,
                           (Replicate(), Replicate()))
    with shd.use_sharding_rules(rules):
        y = shd.shard_act(x, "residual")
        assert shd.shard_act(x, "unknown") is x
    assert tuple(y.placements) == (Shard(0), Replicate())
    assert torch.equal(y.to_local(), x.to_local())


def test_tree_shardings_follow_param_specs():
    cfg = tconfigs.get_config("phi3_mini_3p8b").scaled(n_layers=2)
    rules = shd.elastic_rules(_mesh("4x2"), fsdp=True)
    specs = tmodel.param_specs(cfg)
    got = tser.flatten_state(shd.tree_shardings(specs, rules))
    for name, t in tser.flatten_state(specs).items():
        spec = shd.param_pspec(name, tuple(t.shape), rules)
        assert got[name].spec == spec
        assert got[name].placements == shd.placements(spec, rules.mesh)
    caches = tser.flatten_state(shd.cache_shardings(
        tmodel.cache_specs(cfg, 8, 256), rules))
    assert all(isinstance(s, shd.Sharding) for s in caches.values())
