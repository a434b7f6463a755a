"""The multi-pod dry run (``launch/dryrun.py`` on a mesh with a ``pod``
axis), on the CPU.

* Splitting a data axis in two does not change what a rank does: at the
  full widths of llava-next-34b and command-r-plus-104b, cut to one layer,
  ``train_4k``'s sequence length and the arch's own knobs (sequence
  parallelism and FSDP on), a (2, 16, 8) pod/data/model mesh and a
  (32, 8) data/model mesh (the same 256 ranks) give one rank the same
  FLOPs, collective bytes and peak live bytes within 2%. (DTensor's op
  strategies took the pod and data dims for two sharding decisions and
  gathered the MLP's activations over both: on the pod mesh as it is,
  19.5x the FLOPs and 10x the live bytes of llava's layer, 12.4x and 2.7x
  command-r-plus's, each over 11 minutes to trace. Smoke widths do not
  show it.) The batch is cut to 32 sequences, one a data rank, in one
  microbatch.
* Parity with the reference on a three-axis mesh: its ``lower_cell`` on a
  (2, 2, 2) ``("pod", "data", "model")`` mesh of 8 XLA host devices (a
  subprocess) against the port's trace of the same mesh, per-device FLOPs
  of smoke gemma3, phi3 and deepseek-moe in a train cell within 4%, with
  ``seq_parallel`` off and on (the reference's one-hot MoE routing FLOPs
  taken from its count, as in ``tests/test_torch_dryrun.py``).
* The sharded unembed and cross-entropy under sequence parallelism keeps
  each chunk's positions on the model axis, as the reference's logits
  layout does (it replicated them there with the whole vocabulary, the
  model axis's width times the work): in a 4-rank gloo world on a (2, 2)
  mesh its loss and gradients equal the unsharded ones, with sequence
  parallelism off and on (the head's gradient lacked its sum over the
  data axis).
* The production multi-pod mesh, (2, 32, 8) over 512 ranks: a batch of 32
  (``prefill_32k``) that its 64 data ranks do not divide goes over the
  ``data`` axis alone, one sequence a rank, each pod a replica; a batch of
  256 over both; a global batch and a microbatch that would split the
  pods unlike are refused; a train cell's microbatches shard like its
  batch; on one pod the reference's rule stands (``--pure-fsdp`` on the
  single mesh); the CLI's JSON of a multi-pod cell reports 512 chips and
  the reference's keys.
* A decode step keeps its batch on the data ranks: at full width, one
  layer, each rank's flash decode reads its own sequences (the query was
  left replicated over the data axes, and every rank gathered every
  rank's cache).
"""

import json
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import SHAPES, get_config, get_smoke_config  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import op_analysis as OA  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
POD_CELL = {"t_pod_train": {"seq_len": 64, "global_batch": 8,
                            "kind": "train"}}
POD_KNOBS = dict(fsdp=False, remat="none", microbatches=1,
                 fused_ce=True, pure_fsdp=False, factored_opt=False)
PARITY_ARCHS = ("gemma3_1b", "phi3_mini_3p8b", "deepseek_moe_16b")
SEQ_PARALLEL = (False, True)
SPLIT_ARCHS = ("llava_next_34b", "command_r_plus_104b")
# the reference's result keys that the port writes (tests/test_torch_dryrun.py)
REFERENCE_KEYS = {"arch", "shape", "mesh", "mesh_info", "status", "knobs",
                  "compile_s", "n_chips", "per_device", "memory",
                  "model_flops", "hlo_flops_global", "useful_flops_frac",
                  "roofline"}

GLOO = textwrap.dedent("""
    import json, sys
    import torch, torch.distributed as dist
    rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=4)
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.train_step import fused_unembed_xent
    gen = torch.Generator().manual_seed(0)
    B, S, Dm, V = 4, 32, 16, 64
    h = torch.randn(B, S, Dm, generator=gen)
    w = torch.randn(Dm, V, generator=gen) / 4
    y = torch.randint(0, V, (B, S), generator=gen)
    hp, wp = h.clone().requires_grad_(), w.clone().requires_grad_()
    want = fused_unembed_xent(hp, wp, y, seq_chunks=2)
    want.backward()
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    def put(t, spec):
        return shd.distribute(t, shd.Sharding(mesh, shd.placements(spec, mesh)))
    res = {}
    for sp in (0, 1):
        rules = shd.ShardingRules(mesh, data_axes=("data",), seq_parallel=bool(sp))
        with shd.use_sharding_rules(rules), implicit_replication():
            hd = put(h, shd.act_spec(h.shape, "residual", rules)).requires_grad_()
            wd = put(w, shd.param_pspec("lm_head", tuple(w.shape), rules)
                     ).requires_grad_()
            yd = put(y, ("data", None))
            got = fused_unembed_xent(hd, wd, yd, seq_chunks=2)
            got.backward()
            res[sp] = {
                "spec": list(shd.act_spec((B, S // 2, V), "logits", rules)),
                "loss": [float(got.full_tensor()), float(want)],
                "grad_h": float((hd.grad.full_tensor() - hp.grad).abs().max()),
                "grad_w": float((wd.grad.full_tensor() - wp.grad).abs().max())}
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()
""")

REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, sys
    import jax
    from repro.configs import SHAPES, get_smoke_config
    from repro.launch import dryrun as D
    from repro.launch.hlo_analysis import analyze
    from repro.launch.mesh import make_mesh
    cells, knobs, archs = (json.loads(a) for a in sys.argv[1:4])
    SHAPES.update(cells)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"),
                     devices=jax.devices()[:8])
    out = {}
    for arch in archs:
        for shape in cells:
            for sp in (False, True):
                _, compiled = D.lower_cell(get_smoke_config(arch), shape, mesh,
                                           dict(knobs, seq_parallel=sp))
                out[f"{arch}/{shape}/{int(sp)}"] = analyze(
                    compiled.as_text())["flops"]
    print("RESULT " + json.dumps(out))
""")


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads: the test workers share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def no_world_left():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def cells():
    added = {k: v for k, v in POD_CELL.items() if k not in SHAPES}
    SHAPES.update(added)
    yield
    for k in added:
        SHAPES.pop(k)


@pytest.fixture(scope="module", autouse=True)
def reference():
    """The reference's dry run of the parity cells on (2, 2, 2), started in
    a subprocess with the module's first test and read when a test needs
    it."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    args = [json.dumps(a) for a in (POD_CELL, POD_KNOBS, PARITY_ARCHS)]
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE, *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    box = {}

    def result():
        if "r" not in box:
            out, err = proc.communicate(timeout=400)
            assert proc.returncode == 0, err[-3000:]
            line = next(x for x in out.splitlines() if x.startswith("RESULT "))
            box["r"] = json.loads(line[len("RESULT "):])
        return box["r"]
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module", autouse=True)
def gloo_world(tmp_path_factory):
    """Four gloo ranks on the CPU (``python -c`` processes, a ``file://``
    rendezvous), started with the module's first test; rank 0's results."""
    tmp = tmp_path_factory.mktemp("gloo")
    env = dict(os.environ, PYTHONPATH=SRC, GLOO_SOCKET_IFNAME="lo")
    init = f"file://{tmp / 'rdv'}"
    out = tmp / "rank0.json"
    procs = [subprocess.Popen([sys.executable, "-c", GLOO, str(r), init,
                               str(out)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for r in range(4)]
    box = {}

    def result():
        if "r" not in box:
            try:
                errs = [p.communicate(timeout=300)[1] for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            assert all(p.returncode == 0 for p in procs), \
                "\n".join(e[-2000:] for e in errs)
            box["r"] = json.loads(out.read_text())
        return box["r"]
    yield result
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.mark.parametrize("arch", SPLIT_ARCHS)
def test_splitting_a_data_axis_does_not_change_a_rank(arch):
    args = SimpleNamespace(remat=None, microbatches=1, fsdp=None,
                           seq_parallel=None, fused_ce=None, pure_fsdp=None,
                           factored_opt=None)
    knobs = D._knobs(arch, args, "train")
    assert knobs["seq_parallel"] and knobs["fsdp"]
    SHAPES["t_split"] = dict(SHAPES["train_4k"], global_batch=32)
    cfg = get_config(arch).scaled(n_layers=1)
    M.fake_world(256)
    try:
        got = {}
        for shape, axes in (((32, 8), ("data", "model")),
                            ((2, 16, 8), ("pod", "data", "model"))):
            mesh = M.make_mesh(shape, axes, device_type="cuda")
            r = D.trace_cell(cfg, "t_split", mesh, knobs, device="cuda")
            got[len(shape)] = (r["flops"], r["collective_bytes"],
                               r["memory"]["live_bytes"])
    finally:
        SHAPES.pop("t_split")
    for one, two in zip(got[2], got[3]):
        assert one > 0
        assert abs(two - one) <= 0.02 * one, (arch, got)


@pytest.mark.parametrize("sp", SEQ_PARALLEL, ids=("sp0", "sp1"))
def test_sharded_cross_entropy_equals_unsharded(gloo_world, sp):
    r = gloo_world()[str(int(sp))]
    # under sequence parallelism a chunk's positions go on the model axis
    # and the vocabulary stays whole, else the vocabulary is sliced there
    assert r["spec"] == (["data", "model", None] if sp
                         else ["data", None, "model"])
    loss, want = r["loss"]
    assert abs(loss - want) <= 1e-5 * abs(want), r
    # the head's gradient sums every rank's rows (it missed the data
    # axis's sum before)
    assert r["grad_h"] <= 1e-6 and r["grad_w"] <= 1e-6, r


def _onehot_flops(arch: str, shape: str, mesh) -> float:
    """The reference's one-hot routing FLOPs per device
    (``tests/test_torch_dryrun.py``): zero for a dense arch; ``mesh`` is
    (data ranks, all ranks)."""
    cfg = get_smoke_config(arch)
    if cfg.moe is None:
        return 0.0
    from repro_torch.models.moe import _n_groups, router_capacity
    m = cfg.moe
    B, S = POD_CELL[shape]["global_batch"], POD_CELL[shape]["seq_len"]
    T = B * S
    with shd.use_sharding_rules(SimpleNamespace(dp_size=mesh[0])):
        G = _n_groups(T)
    Tg = T // G
    C = router_capacity(Tg, m)
    E, K, Dm = m.n_experts, m.top_k, cfg.d_model
    per_layer = 3 * (2 * T * K * E * C) + 5 * (2 * G * Tg * E * C * Dm)
    return per_layer * (cfg.n_layers - m.dense_prelude_layers) / mesh[1]


@pytest.mark.parametrize("sp", SEQ_PARALLEL, ids=("sp0", "sp1"))
@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_three_axis_flops_match_the_reference(cells, reference, arch, sp):
    M.fake_world(8)
    mesh = M.make_mesh((2, 2, 2), ("pod", "data", "model"), device_type="cpu")
    knobs = dict(POD_KNOBS, seq_parallel=sp)
    got = D.trace_cell(get_smoke_config(arch), "t_pod_train", mesh, knobs,
                       device="cpu")["flops"]
    want = reference()[f"{arch}/t_pod_train/{int(sp)}"]
    want -= _onehot_flops(arch, "t_pod_train", (4, 8))
    assert abs(got - want) <= 0.04 * want, (got, want)


def test_production_multi_pod_mesh_is_two_pods_of_512_ranks():
    M.fake_world(512)
    mesh = M.make_production_mesh(multi_pod=True, device_type="cpu")
    assert mesh.size() == 512
    assert M.mesh_info(mesh) == {"shape": [2, 32, 8],
                                 "axes": ["pod", "data", "model"]}
    flat = D.flat_data_mesh(mesh)
    assert M.mesh_info(flat) == {"shape": [64, 8], "axes": ["data", "model"]}
    assert torch.equal(flat.mesh.flatten(), mesh.mesh.flatten())


@pytest.mark.parametrize("shape_name,axes,rows", [
    ("prefill_32k", "data", 1), ("train_4k", ("pod", "data"), 4),
    ("long_500k", None, 1)])
def test_a_batch_the_data_ranks_do_not_divide_falls_back(shape_name, axes,
                                                         rows):
    """32 sequences on 64 data ranks go over the data axis, one a rank in
    each pod, each pod a replica; a batch of 256 goes over both axes, the
    pod and data dims merged into one; a batch of 1 is replicated."""
    M.fake_world(512)
    mesh = M.make_production_mesh(multi_pod=True, device_type="cpu")
    knobs = D._knobs("llava_next_34b", SimpleNamespace(
        remat=None, microbatches=1, fsdp=None, seq_parallel=None,
        fused_ce=None, pure_fsdp=None, factored_opt=None),
        SHAPES[shape_name]["kind"])
    B = SHAPES[shape_name]["global_batch"]
    rules = D._rules(mesh, knobs, (B,))
    spec = shd.batch_spec(rules, B)
    tokens = D._batch_shardings(rules, {"x": torch.empty(B, 16,
                                                         device="meta")})["x"]
    (region,) = shd.addressable_shard_spans(tokens.mesh, tokens.placements,
                                            (B, 16))
    assert region[0][1] - region[0][0] == rows
    if axes == "data":
        # each pod a replica: rank 0's pod is traced
        assert spec == ("data",)
        assert M.mesh_info(rules.mesh) == {"shape": [32, 8],
                                           "axes": ["data", "model"]}
        assert torch.equal(rules.mesh.mesh, mesh.mesh[0])
    elif axes is None:
        assert spec == (None,)
    else:
        assert tuple(rules.mesh.mesh_dim_names) == ("data", "model")
        assert rules.dp_size == 64


@pytest.mark.parametrize("arch,microbatches", [
    ("command_r_plus_104b", 4), ("grok1_314b", 4), ("llava_next_34b", 4),
    ("minitron_8b", 4), ("deepseek_moe_16b", 2)])
def test_microbatches_fit_the_data_ranks(arch, microbatches):
    """256 sequences on 64 data ranks: 8 microbatches of 32 would not
    shard like the batch, 4 of 64 do."""
    M.fake_world(512)
    mesh = M.make_production_mesh(multi_pod=True, device_type="cpu")
    args = SimpleNamespace(remat=None, microbatches=None, fsdp=None,
                           seq_parallel=None, fused_ce=None, pure_fsdp=None,
                           factored_opt=None)
    knobs = D._knobs(arch, args, "train")
    got = D.fit_microbatches(D._rules(mesh, knobs), 256, knobs["microbatches"])
    assert got == microbatches
    single = M.make_mesh((32, 8), ("data", "model"), device_type="cpu")
    assert D.fit_microbatches(D._rules(single, knobs), 256,
                              knobs["microbatches"]) == knobs["microbatches"]


class _DecodeQueries(OA.OpAnalysis):
    """The op analysis, also keeping the local query shape of each flash
    decode it sees."""
    seen: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "repro_torch" and func._opname == "flash_decode":
            _DecodeQueries.seen.append(tuple(args[0].shape))
        return super().__torch_dispatch__(func, types, args, kwargs)


@pytest.mark.parametrize("arch", ["command_r_plus_104b", "grok1_314b",
                                  "phi3_mini_3p8b"])
@pytest.mark.parametrize("multi", [False, True], ids=("single", "multi"))
def test_a_decode_step_keeps_the_batch_on_the_data_ranks(monkeypatch, arch,
                                                         multi):
    """``decode_32k`` at full width, one layer: each rank's flash decode
    reads its own sequences' caches, 128 over 32 or 64 data ranks (the
    query was left replicated over the data axes, and each rank gathered
    every rank's cache: 3x grok's decode FLOPs)."""
    monkeypatch.setattr(D, "OpAnalysis", _DecodeQueries)
    monkeypatch.setattr(_DecodeQueries, "seen", [])
    M.fake_world(512 if multi else 256)
    mesh = M.make_production_mesh(multi_pod=multi, device_type="cpu")
    args = SimpleNamespace(remat=None, microbatches=None, fsdp=None,
                           seq_parallel=None, fused_ce=None, pure_fsdp=None,
                           factored_opt=None)
    knobs = D._knobs(arch, args, "decode")
    cfg = get_config(arch).scaled(n_layers=1)
    D.trace_cell(cfg, "decode_32k", mesh, knobs, device="cuda")
    rows = 128 // (64 if multi else 32)
    assert _DecodeQueries.seen and \
        all(q[0] == rows for q in _DecodeQueries.seen), _DecodeQueries.seen


def _pure_fsdp_knobs(pure: bool = False) -> dict:
    return D._knobs("llava_next_34b", SimpleNamespace(
        remat=None, microbatches=None, fsdp=None, seq_parallel=None,
        fused_ce=None, pure_fsdp=pure, factored_opt=None), "train")


def test_batches_that_split_the_pods_unlike_are_refused():
    """A global batch of 256 over both pods with microbatches of 32 over
    each pod's data ranks alone: no one traced mesh holds both."""
    M.fake_world(512)
    mesh = M.make_production_mesh(multi_pod=True, device_type="cpu")
    with pytest.raises(ValueError, match="split the 2 pods unlike"):
        D._rules(mesh, _pure_fsdp_knobs(), (256, 32))


@pytest.mark.parametrize("batch,axes", [(32, None), (256, ("data", "model")),
                                        (3, None)])
def test_one_pod_keeps_the_reference_rule(batch, axes):
    """With no pod axis the data axes shard a batch they divide and
    replicate any other, as the reference's rule does: ``--pure-fsdp``'s
    (data, model) on the single mesh replicates a batch of 32."""
    M.fake_world(256)
    single = M.make_production_mesh(device_type="cpu")
    rules = D._rules(single, _pure_fsdp_knobs(pure=True), (batch,))
    assert rules.mesh is single
    assert rules.data_axes == ("data", "model")
    assert rules.dp_axes_for(batch) == axes


def test_cli_writes_a_multi_pod_cell(tmp_path):
    D.main(["--arch", "gemma3-1b", "--shape", "decode_32k", "--mesh",
            "multi", "--out", str(tmp_path), "--tag", "t"])
    res = json.loads((tmp_path / "t" / "multi" /
                      "gemma3_1b__decode_32k.json").read_text())
    assert res["status"] == "ok"
    assert res["n_chips"] == 512
    assert res["mesh_info"] == {"shape": [2, 32, 8],
                                "axes": ["pod", "data", "model"]}
    assert set(res) == REFERENCE_KEYS | {"trace_device", "plain"}
    assert res["per_device"]["hlo_flops"] > 0
    assert res["per_device"]["collective_bytes"] > 0
    assert res["hlo_flops_global"] == res["per_device"]["hlo_flops"] * 512
