"""Multi-pod dry run: trace every (architecture x input shape x mesh) cell's
step on the production mesh with fake tensors (no allocation), and report
one device's memory, FLOPs, bytes and collective bytes for the roofline
table. The port's counterpart of the reference's ``launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Where the reference lowers and compiles against 512 placeholder host
devices, this traces: the process joins a ``fake`` process group of 256
or 512 ranks as rank 0 (``launch/mesh.py``), the state, the batch and the
caches are ``DTensor``s of fake local shards placed by the sharding rules,
and the port's own step function (``make_train_step``, ``make_prefill``,
``make_decode_step``) runs once under ``FakeTensorMode`` inside the op
analysis (``launch/op_analysis.py``), which counts what rank 0 runs. A
one-device mesh traces plain tensors, the path a single card runs.

``--device cuda`` (the default) traces the card's path: each kernel op
counts by its registered formula and its fake implementation gives the
shapes (fake CUDA tensors where torch is built with CUDA; elsewhere fake
meta tensors stand in on a CUDA mesh, counted the same, since autograd on
fake CUDA tensors needs a CUDA build). ``--device cpu`` traces the plain versions,
which compute what the reference's jnp path computes.

Results land in ``results/dryrun_torch/<tag>/<mesh>/<arch>__<shape>.json``
with the reference's keys: ``compile_s`` holds the trace seconds, the
``per_device`` counts keep their ``hlo_`` names, and ``xla_raw_*`` and the
memory's ``generated_code_size_in_bytes`` have no counterpart.
``trace_device`` and ``plain`` say what was traced. ``--all`` runs each
cell in a subprocess of its own (``--timeout`` seconds each) and skips
cells whose JSON already exists.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback

import torch

from ..configs import ARCH_IDS, SHAPES, cell_is_runnable, get_config, resolve
from ..distributed.sharding import (Sharding, ShardingRules, axis_size,
                                    cache_shardings, from_local, placements,
                                    tree_shardings, use_sharding_rules)
from ..models.config import ModelConfig
from ..models.model import cache_specs, input_specs, param_specs
from ..optim import AdamWConfig
from .mesh import fake_world, make_mesh, make_production_mesh, mesh_info
from .op_analysis import OpAnalysis
from .roofline import model_flops, roofline_terms

# Baseline per-arch knobs, the reference's values. fsdp applies to train
# cells; fsdp_inference to prefill/decode cells (serving wants TP-only
# weights unless the model cannot fit one chip row: >=100B).
ARCH_DEFAULTS = {
    "command_r_plus_104b": dict(fsdp=True, fsdp_inference=True, remat="full", microbatches=8, seq_parallel=True),
    "grok1_314b": dict(fsdp=True, fsdp_inference=True, remat="full", microbatches=8, seq_parallel=True),
    "llava_next_34b": dict(fsdp=True, fsdp_inference=False, remat="full", microbatches=4, seq_parallel=True),
    "minitron_8b": dict(fsdp=True, remat="dots", microbatches=4),
    "deepseek_moe_16b": dict(fsdp=True, remat="dots", microbatches=2),
    "falcon_mamba_7b": dict(fsdp=True, remat="full", microbatches=4),
    "musicgen_medium": dict(fsdp=False, remat="dots", microbatches=4),
    "gemma3_1b": dict(fsdp=False, remat="dots", microbatches=4),
    "phi3_mini_3p8b": dict(fsdp=True, remat="dots", microbatches=4),
    "recurrentgemma_2b": dict(fsdp=False, remat="dots", microbatches=4),
}


def _knobs(arch: str, args, kind: str = "train") -> dict:
    k = dict(ARCH_DEFAULTS.get(arch, dict(fsdp=False, remat="dots", microbatches=1)))
    k.setdefault("seq_parallel", False)
    k.setdefault("fused_ce", True)
    k.setdefault("fsdp_inference", False)
    if kind != "train":
        k["fsdp"] = k.pop("fsdp_inference")
    else:
        k.pop("fsdp_inference")
    if args.remat is not None:
        k["remat"] = args.remat
    if args.microbatches is not None:
        k["microbatches"] = args.microbatches
    if args.fsdp is not None:
        k["fsdp"] = bool(args.fsdp)
    if args.seq_parallel is not None:
        k["seq_parallel"] = bool(args.seq_parallel)
    if args.fused_ce is not None:
        k["fused_ce"] = bool(args.fused_ce)
    if args.pure_fsdp is not None:
        k["pure_fsdp"] = bool(args.pure_fsdp)
    k.setdefault("pure_fsdp", False)
    if args.factored_opt is not None:
        k["factored_opt"] = bool(args.factored_opt)
    k.setdefault("factored_opt", False)
    return k


def _rules(mesh, knobs, batches=()) -> ShardingRules:
    """The cell's sharding rules, on the mesh its tensors are traced on.
    A mesh with a ``pod`` axis is traced without its pod dim: where each of
    the cell's ``batches`` (its global and micro batch) divides the pod and
    data axes together, or neither, those two are one mesh dim
    (``flat_data_mesh``); where each divides the data axes alone, or
    neither, each pod is a replica and this rank's pod is traced
    (``pod_mesh``): a batch of 32 on (2, 32) pod/data ranks goes one
    sequence a rank in each pod, where the reference's rule would
    replicate it. DTensor's op strategies take two mesh dims that shard
    one tensor dim for two sharding decisions, and under sequence
    parallelism they gathered the MLP's activations over both."""
    names = tuple(mesh.mesh_dim_names)
    if knobs.get("pure_fsdp"):
        # full-mesh data parallelism: every axis carries batch; weights are
        # ZeRO-3-sharded over the same combined axis set
        data_axes = names
    else:
        data_axes = ("pod", "data") if "pod" in names else ("data",)
    if "pod" in names:
        data_axes = tuple(a for a in data_axes if a != "pod")
        pod = axis_size(mesh, "pod")
        data = 1
        for a in data_axes:
            data *= axis_size(mesh, a)
        whole = {b % (pod * data) == 0 for b in batches if b % data == 0}
        if whole == {False}:
            mesh = pod_mesh(mesh)
        elif whole == {True, False}:
            raise ValueError(
                f"batches {tuple(batches)} split the {pod} pods unlike: some "
                f"divide the {pod * data} pod and data ranks, some only the "
                f"{data} ranks of a pod")
        else:
            mesh = flat_data_mesh(mesh)
    return ShardingRules(mesh, data_axes=data_axes, fsdp=knobs["fsdp"],
                         seq_parallel=knobs["seq_parallel"],
                         pure_fsdp=knobs.get("pure_fsdp", False))


def fit_microbatches(rules: ShardingRules, batch: int, n: int) -> int:
    """The most microbatches, at most ``n``, that split ``batch`` into
    microbatches sharded like the batch: 256 sequences on the 64 data
    ranks of the multi-pod mesh take 4 microbatches of 64 where the
    reference's 32 data ranks take 8 of 32 (each rank accumulates the
    same one sequence a microbatch)."""
    whole = rules.dp_axes_for(batch)
    for m in range(n, 1, -1):
        if batch % m == 0 and rules.dp_axes_for(batch // m) == whole:
            return m
    return 1


def pod_mesh(mesh):
    """The pod of ``mesh`` that holds this rank, without the ``pod`` dim."""
    names = list(mesh.mesh_dim_names)
    i = names.index("pod")
    coord = mesh.get_coordinate()
    ranks = mesh.mesh.select(i, coord[i])
    del names[i]
    return make_mesh(tuple(ranks.shape), names,
                     devices=ranks.flatten().tolist(),
                     device_type=mesh.device_type)


def flat_data_mesh(mesh):
    """``mesh`` with its ``pod`` and ``data`` dims merged into one ``data``
    dim, over the same ranks in the same (row-major) order: a dim sharded
    over ("pod", "data") is split alike on both."""
    names = list(mesh.mesh_dim_names)
    i = names.index("pod")
    if names[i + 1] != "data":
        raise ValueError(f"pod and data are not adjacent in {names}")
    shape = [int(s) for s in mesh.shape]
    shape[i:i + 2] = [shape[i] * shape[i + 1]]
    del names[i]
    return make_mesh(shape, names, devices=mesh.mesh.flatten().tolist(),
                     device_type=mesh.device_type)


def _batch_shardings(rules, specs) -> dict:
    def shard(s):
        if s.ndim < 1:
            return Sharding(rules.mesh, placements((), rules.mesh), ())
        spec = (rules.dp_axes_for(s.shape[0]),) + (None,) * (s.ndim - 1)
        return Sharding(rules.mesh, placements(spec, rules.mesh), spec)
    return {k: shard(v) for k, v in specs.items()}


def trace_device(device: str) -> torch.device:
    """The device of a trace's fake tensors: ``device``, but fake meta
    tensors stand in for CUDA ones where torch has no CUDA build (autograd
    refuses CUDA tensors there). The mesh keeps ``device`` as its device
    type either way, so DTensor picks the collectives it picks on that
    device."""
    if device == "cuda" and not torch.backends.cuda.is_built():
        return torch.device("meta")
    return torch.device(device)


def _tensor_tree(specs, shardings, dev, gen=None, vocab: int = 2):
    """Tensors like ``specs`` (meta tensors): on a one-device mesh the whole
    tensor, else a DTensor of this rank's shard under ``shardings`` (a tree
    of ``Sharding`` like ``specs``). Under a fake mode they are fake; with a
    generator ``gen`` they are real and seeded (floats uniform in [0,
    1/32), so second moments are not negative; ints in [0, vocab)), else
    left unwritten."""
    from ..checkpoint import serialize as ser
    from ..distributed.sharding import addressable_shard_spans
    named = ser.flatten_state(specs)
    shs = ser.flatten_state(shardings) if shardings is not None else {}
    out = {}
    for n, s in named.items():
        if not isinstance(s, torch.Tensor):
            out[n] = s
            continue
        sh = shs.get(n)
        whole = sh is None or sh.mesh.size() == 1
        shape = tuple(s.shape) if whole else tuple(
            b - a for a, b in addressable_shard_spans(sh.mesh, sh.placements,
                                                      s.shape)[0])
        t = torch.empty(shape, dtype=s.dtype, device=dev)
        if gen is not None:
            if s.dtype.is_floating_point:
                t.copy_(torch.rand(shape, generator=gen, device=dev) / 32)
            elif s.dtype in (torch.int32, torch.int64):
                t.copy_(torch.randint(0, vocab, shape, generator=gen,
                                      device=dev))
            else:
                t.zero_()
        out[n] = t if whole else from_local(t, sh, tuple(s.shape))
    return ser.unflatten_like(specs, out)


def trace_cell(cfg: ModelConfig, shape_name: str, mesh, knobs: dict, *,
               device: str = "cuda", fake: bool = True, seed: int = 0
               ) -> dict:
    """Trace one cell's step once under the op analysis: the counterpart of
    the reference's ``lower_cell``, with the same three kinds. Returns the
    analysis (``OpAnalysis.result()``), its ``memory``, the trace seconds
    and what was traced. ``fake=False`` runs the same step for real on
    this rank's seeded shards (on ``device``, the kernels launched there),
    under the same analysis, and adds the step's wall seconds
    (``step_s``, the device synchronised)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    from ..serve.serve_step import make_decode_step, make_prefill
    from ..train.train_step import init_train_state, make_train_step
    sh = SHAPES[shape_name]
    kind, S, B = sh["kind"], sh["seq_len"], sh["global_batch"]
    mb = knobs.get("microbatches", 1) if kind == "train" else 1
    rules = _rules(mesh, knobs, (B, B // mb))
    fake_run = fake
    dev = trace_device(device)
    plain = device == "cpu"
    sharded = mesh.size() > 1
    fake = FakeTensorMode(allow_non_fake_inputs=True) if fake_run else None
    dev = dev if fake_run else torch.device(device)
    t0 = time.perf_counter()
    # the specs (meta tensors, no allocation) and their shardings first,
    # outside the fake mode
    if kind == "train":
        opt_cfg = AdamWConfig(total_steps=10_000,
                              factored_second_moment=knobs.get("factored_opt", False))
        fn = make_train_step(cfg, opt_cfg, remat=knobs["remat"],
                             microbatches=knobs["microbatches"],
                             fused_ce=knobs.get("fused_ce", True))
        state_specs = init_train_state(cfg, opt_cfg, 0, device="meta")
        in_specs = input_specs(cfg, kind="train", seq_len=S, batch=B)
        trees = [(state_specs, tree_shardings(state_specs, rules)),
                 (in_specs, _batch_shardings(rules, in_specs))]
    elif kind == "prefill":
        fn = make_prefill(cfg, cache_len=S, device=dev)
        p_specs = param_specs(cfg)
        in_specs = input_specs(cfg, kind="prefill", seq_len=S, batch=B)
        trees = [(p_specs, tree_shardings(p_specs, rules)),
                 (in_specs, _batch_shardings(rules, in_specs))]
    elif kind == "decode":
        # the caches are donated, as the reference's cell donates them
        # (donate_argnums=(2,)): the step writes its rows into them and
        # returns them, so the analysis counts them once, as aliased
        # argument bytes
        fn = make_decode_step(cfg, device=dev, donate_caches=True)
        p_specs = param_specs(cfg)
        tok = {"x": input_specs(cfg, kind="decode", seq_len=S, batch=B)["inputs"]}
        c_specs = cache_specs(cfg, B, S)
        trees = [(p_specs, tree_shardings(p_specs, rules)),
                 (tok, _batch_shardings(rules, tok)),
                 (c_specs, cache_shardings(c_specs, rules))]
    else:
        raise ValueError(kind)
    with contextlib.ExitStack() as stack:
        stack.enter_context(use_sharding_rules(rules if sharded else None))
        if fake_run:
            stack.enter_context(fake)
            gen = None
        else:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
        if sharded:
            stack.enter_context(implicit_replication())
        made = [_tensor_tree(specs, shs, dev, gen, cfg.vocab_size)
                for specs, shs in trees]
        if kind == "train":
            args = tuple(made)
        elif kind == "prefill":
            args = (made[0], made[1]["inputs"])
        else:
            args = (made[0], made[1]["x"], made[2], S - 1)
        del made
        mode = OpAnalysis(plain=plain, fake_mode=fake, device=device)
        mode.add_arguments(args)
        if dev.type == "cuda" and not fake_run:
            torch.cuda.synchronize(dev)
        t_step = time.perf_counter()
        with mode:
            out = fn(*args)
            if dev.type == "cuda" and not fake_run:
                torch.cuda.synchronize(dev)
            step_s = time.perf_counter() - t_step
            mode.add_outputs(out)
            del out
    res = {**mode.result(), "memory": mode.memory(),
           "trace_s": time.perf_counter() - t0, "trace_device": str(dev),
           "plain": plain}
    if not fake_run:
        res["step_s"] = step_s
    return res


def _mem_dict(analysis: dict) -> dict:
    """One device's argument, output, temporary and alias bytes and its
    peak of live bytes (the reference's ``memory_analysis`` keys, less
    ``generated_code_size_in_bytes``)."""
    return {k: int(v) for k, v in analysis["memory"].items()}


def run_cell(arch: str, shape_name: str, mesh_kind: str, args) -> dict:
    arch = resolve(arch)
    cfg = get_config(arch)
    runnable, reason = cell_is_runnable(cfg, shape_name)
    if not runnable:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": reason}
    knobs = _knobs(arch, args, SHAPES[shape_name]["kind"])
    multi = mesh_kind == "multi"
    fake_world(512 if multi else 256)
    device = getattr(args, "device", "cuda")
    mesh = make_production_mesh(multi_pod=multi, device_type=device)
    if SHAPES[shape_name]["kind"] == "train":
        B = SHAPES[shape_name]["global_batch"]
        knobs["microbatches"] = fit_microbatches(
            _rules(mesh, knobs, (B,)), B, knobs["microbatches"])
    n_chips = mesh.size()
    a = trace_cell(cfg, shape_name, mesh, knobs, device=device)
    flops = float(a["flops"])
    bytes_accessed = float(a["bytes"])
    sh = SHAPES[shape_name]
    mf = model_flops(cfg, kind=sh["kind"], batch=sh["global_batch"],
                     seq_len=sh["seq_len"])
    terms = roofline_terms(per_device_flops=flops,
                           per_device_bytes=bytes_accessed,
                           per_device_coll_bytes=a["collective_bytes"])
    hlo_flops_global = flops * n_chips
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "mesh_info": mesh_info(mesh), "status": "ok",
        "knobs": knobs, "compile_s": a["trace_s"],
        "n_chips": n_chips,
        "per_device": {
            "hlo_flops": flops,
            "hlo_bytes": bytes_accessed,
            "collective_bytes": a["collective_bytes"],
            "collectives": a["collectives"],
            "collective_counts": a["collective_counts"],
        },
        "memory": _mem_dict(a),
        "model_flops": mf,
        "hlo_flops_global": hlo_flops_global,
        "useful_flops_frac": (mf / hlo_flops_global) if hlo_flops_global else None,
        "roofline": terms,
        "trace_device": a["trace_device"], "plain": a["plain"],
    }


def _out_path(args, mesh_kind, arch, shape_name):
    d = os.path.join(args.out, args.tag, mesh_kind)
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{resolve(arch)}__{shape_name}.json")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--fsdp", type=int, default=None)
    ap.add_argument("--seq-parallel", type=int, default=None)
    ap.add_argument("--fused-ce", type=int, default=None)
    ap.add_argument("--pure-fsdp", type=int, default=None)
    ap.add_argument("--factored-opt", type=int, default=None)
    ap.add_argument("--timeout", type=float, default=1800.0)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="trace the card's path (kernel ops) or the plain "
                         "versions")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if args.all:
        cells = [(a, s, m) for m in meshes for a in ARCH_IDS for s in SHAPES]
        failures = []
        for arch, shape_name, mesh_kind in cells:
            path = _out_path(args, mesh_kind, arch, shape_name)
            if os.path.exists(path) and not args.force:
                print(f"[skip-cached] {mesh_kind}/{arch}/{shape_name}")
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape_name, "--mesh", mesh_kind,
                   "--out", args.out, "--tag", args.tag,
                   "--device", args.device]
            for flag, val in (("--remat", args.remat),
                              ("--microbatches", args.microbatches),
                              ("--fsdp", args.fsdp),
                              ("--seq-parallel", args.seq_parallel),
                              ("--fused-ce", args.fused_ce),
                              ("--pure-fsdp", args.pure_fsdp),
                              ("--factored-opt", args.factored_opt)):
                if val is not None:
                    cmd += [flag, str(val)]
            print(f"[run] {mesh_kind}/{arch}/{shape_name}", flush=True)
            try:
                rc = subprocess.run(cmd, timeout=args.timeout).returncode
            except subprocess.TimeoutExpired:
                rc = -9
            if rc != 0:
                failures.append((mesh_kind, arch, shape_name, rc))
                with open(path, "w") as f:
                    json.dump({"arch": arch, "shape": shape_name,
                               "mesh": mesh_kind, "status": "failed",
                               "returncode": rc}, f)
        print(f"done; {len(failures)} failures: {failures}")
        sys.exit(1 if failures else 0)

    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all) required")
    for mesh_kind in meshes:
        path = _out_path(args, mesh_kind, args.arch, args.shape)
        try:
            result = run_cell(args.arch, args.shape, mesh_kind, args)
        except Exception:
            traceback.print_exc()
            result = {"arch": resolve(args.arch), "shape": args.shape,
                      "mesh": mesh_kind, "status": "error",
                      "error": traceback.format_exc()[-2000:]}
        with open(path, "w") as f:
            json.dump(result, f, indent=1)
        status = result["status"]
        if status == "ok":
            r = result["roofline"]
            print(f"{mesh_kind}/{result['arch']}/{args.shape}: OK "
                  f"compile={result['compile_s']:.0f}s "
                  f"compute={r['compute_s']:.3e}s memory={r['memory_s']:.3e}s "
                  f"coll={r['collective_s']:.3e}s dominant={r['dominant']} "
                  f"useful={result['useful_flops_frac'] and round(result['useful_flops_frac'],3)} "
                  f"live={result['memory']['live_bytes']/2**30:.2f}GiB/dev",
                  flush=True)
        else:
            print(f"{mesh_kind}/{result['arch']}/{args.shape}: {status}")
            if status == "error":
                sys.exit(1)


if __name__ == "__main__":
    main()
