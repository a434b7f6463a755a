"""FSDP's all-gather at use (``distributed/sharding.py`` ``gather_for_use``),
on the CPU at smoke sizes and at one full-width layer.

The reference's rules shard every weight and moment over the data axes and
gather each where it is used (``src/repro/distributed/sharding.py``:
"all-gather at use", and ``_with_fsdp``: "a per-layer all-gather at use").
The port gathers each period's weights over the data axes at the top of
the period (inside its checkpoint, so ``remat`` gathers again in
backward), and each weight's gradient returns reduce-scattered to its own
sharding (ZeRO-3).

* No product takes a weight still sharded over the data axis: in a fake
  trace of smoke phi3-mini, deepseek-moe and falcon-mamba in a train cell
  on a (2, 4) ``("data", "model")`` mesh (48 positions, so a microbatch's
  192 tokens are no weight's dim), every DTensor product (``aten.mm``,
  ``addmm``, ``bmm``) shards an operand over the data axis only along the
  tokens, and leaves a partial sum over it only where it contracts the
  tokens (a weight's gradient, which the reduce-scatter then sums). Before
  the gather, DTensor chose per product: falcon-mamba's Δ projection
  contracted over its FSDP-sharded input dim (ROADMAP §3, item 7).
* Parity with the reference's compiled cells, collective kind by kind on
  the data axis: its ``lower_cell`` on 8 XLA host devices (the
  subprocess of ``tests/test_torch_dryrun.py``, with ``fsdp`` on, and
  ``remat="full"`` and two microbatches in the train cell) against the
  port's trace of the same cells. Conventions: both sides count a
  collective's operand elements, by kind and mesh axis, the reference's
  while bodies scaled by their trip counts. Elements, not bytes: XLA's
  CPU backend runs bf16 collectives in float32, twice the port's bytes
  for every bf16 weight. Gathers are all-gathers with all-to-alls: on a
  CPU mesh DTensor turns a shard-dim all-to-all (the embedding's output,
  its columns FSDP-sharded, to the batch-sharded residual) into an
  all-gather and a chunk, where the reference's is an all-to-all.
  Reductions are reduce-scatters with all-reduces: XLA's CPU backend
  keeps a gradient's reduction over the data axis an all-reduce (its
  slice follows), the port's is a reduce-scatter of the same operand.
  Each within 5% (measured: within 2%; the reference gathers the head
  once more in its train cells). The reference's falcon-mamba decode cell
  leaves ``x_proj`` sharded and gathers its (8, 32) input rows instead,
  fewer elements at 8 sequences; the port gathers every weight, as the
  reference's train cells do.
* The step that runs: in a 4-rank gloo world on a (2, 2) mesh with
  ``fsdp``, one train step (``remat="full"``, two microbatches) of smoke
  falcon-mamba, phi3-mini and deepseek-moe in float32 equals the
  unsharded step: the loss, every gradient (each placed as its weight is)
  and the updated params and moments, each still sharded as the rules
  place it. Before the gather the embedding's gradient (all three), Mamba's
  ``A_log`` and ``D`` and the experts' lacked their sum over the data
  ranks.
* falcon-mamba-7b's ``train_4k`` at full width, one layer: the two pods'
  (2, 32, 8) rank moves at most 1.1x the collective bytes of the single
  pod's (32, 8) rank and runs half its FLOPs (0.49-0.51). Before the
  gather: 5.37x and 0.496 (11.2x and 0.491 at full depth).
"""

import collections
import json
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402

from repro_torch.configs import SHAPES, get_config, get_smoke_config  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import op_analysis as OA  # noqa: E402

from test_torch_dryrun import REFERENCE  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ("phi3_mini_3p8b", "deepseek_moe_16b", "falcon_mamba_7b")
# 48 positions: a train microbatch's 4 x 48 = 192 tokens are no weight's dim
CELLS = {"fsdp_train": {"seq_len": 48, "global_batch": 8, "kind": "train"},
         "fsdp_decode": {"seq_len": 64, "global_batch": 8, "kind": "decode"}}
KNOBS = dict(fsdp=True, remat="none", microbatches=1, seq_parallel=False,
             fused_ce=True, pure_fsdp=False, factored_opt=False)
CELL_KNOBS = {"fsdp_train": {"remat": "full", "microbatches": 2}}
MESH = (2, 4)
TOKENS = 4 * 48
GATHERS = ("all-gather", "all-to-all")
REDUCTIONS = ("reduce-scatter", "all-reduce")
PRODUCTS = {"mm", "addmm", "bmm"}

GLOO = textwrap.dedent("""
    import json, sys
    from types import SimpleNamespace
    import torch, torch.distributed as dist
    rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=4)
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.checkpoint import serialize as ser
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.train_step import (init_train_state,
                                              loss_and_grads, make_train_step)
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    rules = shd.ShardingRules(mesh, fsdp=True)
    res = {}

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    for arch in json.loads(sys.argv[4]):
        cfg = get_smoke_config(arch).scaled(dtype="float32")
        opt = AdamWConfig(total_steps=100, warmup_steps=1, eps=1e-4)
        state = init_train_state(cfg, opt, 0, device="cpu")
        gen = torch.Generator().manual_seed(1)
        tok = torch.randint(0, cfg.vocab_size, (8, 33), generator=gen)
        batch = {"inputs": tok[:, :-1], "labels": tok[:, 1:]}
        step = make_train_step(cfg, opt, remat="full", microbatches=2)
        # an MoE step routes within groups that start from the data ranks'
        # count (moe._n_groups): the unsharded step takes the sharded one's
        with shd.use_sharding_rules(SimpleNamespace(dp_size=2, fsdp=False,
                                                   pure_fsdp=False)):
            want_state, want_m = step(state, batch)
            *_, want_g = loss_and_grads(cfg, state["params"], batch["inputs"],
                                        batch["labels"])
        shs = ser.flatten_state(shd.tree_shardings(state, rules))
        ds = ser.unflatten_like(state, {
            n: shd.distribute(t, shs[n]) if isinstance(t, torch.Tensor)
            else t for n, t in ser.flatten_state(state).items()})
        bsh = shd.Sharding(mesh, shd.placements(("data", None), mesh))
        db = {k: shd.distribute(v, bsh) for k, v in batch.items()}
        with shd.use_sharding_rules(rules), implicit_replication():
            got_state, got_m = step(ds, db)
            *_, got_g = loss_and_grads(cfg, ds["params"], db["inputs"],
                                       db["labels"])
        r = {"loss": [float(full(got_m["loss"])), float(want_m["loss"])]}
        wg, gg = ser.flatten_state(want_g), ser.flatten_state(got_g)
        r["grad"] = {n: float((full(gg[n]) - wg[n]).abs().max()
                              / wg[n].abs().max().clamp_min(1e-30))
                     for n in wg}
        r["grad_placed"] = [n for n in gg if tuple(gg[n].placements)
                            != tuple(shs["params/" + n].placements)]
        ws, gs = ser.flatten_state(want_state), ser.flatten_state(got_state)
        r["state"] = {n: float((full(gs[n]).double() - ws[n].double())
                               .abs().max())
                      for n in ws if ws[n].is_floating_point()}
        # every leaf the rules shard is still this rank's shard, so placed
        r["unsharded"] = []
        for n, t in gs.items():
            pl = shs[n].placements
            if not any(p.is_shard() for p in pl):
                continue
            (reg,) = shd.addressable_shard_spans(mesh, pl, t.shape)
            if not isinstance(t, DTensor) or tuple(t.placements) != pl \\
                    or tuple(t.to_local().shape) != tuple(b - a for a, b in reg):
                r["unsharded"].append(n)
        r["n_sharded"] = sum(any(p.is_shard() for p in s.placements)
                             for n, s in shs.items()
                             if n.startswith(("params/", "opt/")))
        res[arch] = r
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()
""")
GLOO_ARCHS = ("falcon_mamba_7b", "phi3_mini_3p8b", "deepseek_moe_16b")


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
    added = {k: v for k, v in CELLS.items() if k not in SHAPES}
    SHAPES.update(added)
    yield
    for k in added:
        SHAPES.pop(k)


def _started(procs, timeout):
    """A function that waits for ``procs`` (once) and returns their stdout
    and stderr, each process's return code checked."""
    box = {}

    def result():
        if "r" not in box:
            try:
                outs = [p.communicate(timeout=timeout) for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            assert all(p.returncode == 0 for p in procs), \
                "\n".join(e[-2000:] for _, e in outs)
            box["r"] = outs
        return box["r"]
    return result


@pytest.fixture(scope="module", autouse=True)
def reference():
    """The reference's compiled FSDP cells on a (2, 4) mesh of 8 XLA host
    devices, started in a subprocess with the module's first test."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    args = [json.dumps(a) for a in (CELLS, KNOBS, ARCHS, [MESH], {}, [],
                                    CELL_KNOBS)]
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE, *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    wait = _started([proc], 400)

    def result():
        (out, _), = wait()
        line = next(x for x in out.splitlines() if x.startswith("RESULT "))
        return json.loads(line[len("RESULT "):])
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
    out = tmp / "rank0.json"
    procs = [subprocess.Popen(
        [sys.executable, "-c", GLOO, str(r), f"file://{tmp / 'rdv'}",
         str(out), json.dumps(GLOO_ARCHS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(4)]
    wait = _started(procs, 300)

    def result():
        wait()
        return json.loads(out.read_text())
    yield result
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


class _Recording(OA.OpAnalysis):
    """The op analysis, also keeping each DTensor product (its operands'
    global shapes and placements, its output's placements) and each
    collective's operand elements by kind and mesh axis of the (2, 4)
    mesh (rank r at (r // 4, r % 4))."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.products = []
        self.elements = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        n = len(self.collectives)
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if func.namespace == "_c10d_functional" and len(self.collectives) > n:
            from torch.distributed.distributed_c10d import \
                _resolve_process_group
            group = [a for a in args if isinstance(a, str)][-1]
            ranks = dist.get_process_group_ranks(_resolve_process_group(group))
            tp = MESH[1]
            axis = ("data" if len({r % tp for r in ranks}) == 1 else
                    "model" if len({r // tp for r in ranks}) == 1 else "other")
            self.elements[f"{self.collectives[-1][0]}/{axis}"] += sum(
                t.numel() for t in OA._tensors((args, kwargs)))
        if func._opname in PRODUCTS and not getattr(OA._in_dtensor, "depth", 0) \
                and any(issubclass(t, DTensor) for t in types):
            a, b = [x for x in args if isinstance(x, DTensor)][-2:]
            self.products.append((func._opname, tuple(a.shape),
                                  tuple(b.shape), tuple(a.placements),
                                  tuple(b.placements), tuple(out.placements)))
        return out


@pytest.fixture(scope="module")
def traces(cells):
    """The port's trace of a cell on the (2, 4) mesh, once a cell: the
    ``_Recording`` it ran under."""
    done = {}

    def trace(arch, shape):
        if (arch, shape) not in done:
            M.fake_world(8)
            mesh = M.make_mesh(MESH, ("data", "model"), device_type="cpu")
            modes = []

            class Mode(_Recording):
                def __init__(self, *args, **kwargs):
                    super().__init__(*args, **kwargs)
                    modes.append(self)
            before, D.OpAnalysis = D.OpAnalysis, Mode
            try:
                D.trace_cell(get_smoke_config(arch), shape, mesh,
                             {**KNOBS, **CELL_KNOBS.get(shape, {})},
                             device="cpu")
            finally:
                D.OpAnalysis = before
            done[arch, shape] = modes[-1]
        return done[arch, shape]
    return trace


def _contractions_over_data(products, data: int, tokens: int) -> list:
    """The products that shard an operand over mesh dim ``data`` along
    another dim than the tokens (a weight still FSDP-sharded), or leave a
    partial sum over it without contracting the tokens."""
    bad = []
    for op, a, b, pa, pb, po in products:
        sharded = [(x, p[data]) for x, p in ((a, pa), (b, pb))
                   if p[data].is_shard()]
        if any(x[p.dim] != tokens for x, p in sharded):
            bad.append((op, a, b, pa, pb, po))
        elif po[data].is_partial() and not (
                len(sharded) == 2 and pa[data].dim == len(a) - 1
                and pb[data].dim == len(b) - 2):
            bad.append((op, a, b, pa, pb, po))
    return bad


@pytest.mark.parametrize("arch", ARCHS)
def test_no_product_takes_a_weight_sharded_over_data(traces, arch):
    mode = traces(arch, "fsdp_train")
    assert len(mode.products) > 50
    bad = _contractions_over_data(mode.products, 0, TOKENS)
    assert not bad, bad[:5]
    # a weight's gradient is a partial sum over the data axis, reduced once
    assert mode.elements["reduce-scatter/data"] > 0


def _over_data(elements: dict, kinds) -> int:
    return sum(elements.get(f"{k}/data", 0) for k in kinds)


@pytest.mark.parametrize("shape", tuple(CELLS))
@pytest.mark.parametrize("arch", ARCHS)
def test_data_axis_collectives_match_the_reference(traces, reference, arch,
                                                   shape):
    got = traces(arch, shape).elements
    want = reference()["axis_elements"][f"{arch}/{shape}/{MESH[0]}x{MESH[1]}"]
    for kinds in (GATHERS, REDUCTIONS):
        g, w = _over_data(got, kinds), _over_data(want, kinds)
        assert abs(g - w) <= 0.05 * w, (kinds, g, w, dict(got), want)
    assert _over_data(got, GATHERS) > 0


@pytest.mark.parametrize("arch", GLOO_ARCHS)
def test_sharded_step_equals_the_unsharded_step(gloo_world, arch):
    r = gloo_world()[arch]
    loss, want = r["loss"]
    assert abs(loss - want) <= 1e-5 * abs(want), r["loss"]
    assert max(r["grad"].values()) <= 2e-5, r["grad"]
    assert r["grad_placed"] == [], r["grad_placed"]
    assert max(r["state"].values()) <= 1e-6, r["state"]
    # every param and both its moments sharded, and still this rank's
    # shard after the step
    assert r["n_sharded"] == 3 * len(r["grad"]) and r["unsharded"] == [], r


def test_a_recomputed_function_keeps_the_rules_in_another_thread():
    """A checkpointed period is recomputed in backward, and for a CUDA
    tensor backward runs in the autograd engine's thread, which does not
    see the context's rules (on the card's torch a sharded train step's
    recompute then lost its gathers and constraints). ``keep_rules``
    carries them there."""
    import threading
    M.fake_world(8)
    rules = shd.ShardingRules(M.make_mesh(MESH, ("data", "model"),
                                          device_type="cpu"), fsdp=True)
    seen = {}

    def in_thread(name, fn):
        t = threading.Thread(target=lambda: seen.update({name: fn()}))
        t.start()
        t.join()
    with shd.use_sharding_rules(rules):
        kept = shd.keep_rules(shd.current_rules)
        in_thread("plain", shd.current_rules)
        in_thread("kept", kept)
    assert seen == {"plain": None, "kept": rules}
    assert shd.current_rules() is None


def test_two_pods_move_a_pods_collective_bytes():
    args = SimpleNamespace(remat=None, microbatches=None, fsdp=None,
                           seq_parallel=None, fused_ce=None, pure_fsdp=None,
                           factored_opt=None)
    arch = "falcon_mamba_7b"
    cfg = get_config(arch).scaled(n_layers=1)
    B = SHAPES["train_4k"]["global_batch"]
    got = {}
    for multi in (False, True):
        M.fake_world(512 if multi else 256)
        mesh = M.make_production_mesh(multi_pod=multi, device_type="cuda")
        knobs = D._knobs(arch, args, "train")
        assert knobs["fsdp"]
        knobs["microbatches"] = D.fit_microbatches(
            D._rules(mesh, knobs, (B,)), B, knobs["microbatches"])
        got[multi] = D.trace_cell(cfg, "train_4k", mesh, knobs,
                                  device="cuda")
    one, two = got[False], got[True]
    assert one["collective_bytes"] > 0
    assert two["collective_bytes"] <= 1.1 * one["collective_bytes"], \
        (one["collectives"], two["collectives"])
    assert 0.49 <= two["flops"] / one["flops"] <= 0.51
