"""The port's launch layer against the JAX package: the training entry
point (``launch/train.py``: the compile-cache sweep, the kernel library's
build directory on the checkpoint volume, the CLI) and the analytic
roofline (``launch/roofline.py``).

The sweep runs in both packages on identical directories and must remove
the same names and bytes. The CLI trains SMOKE models on the CPU through
one eviction, with remat and microbatch accumulation, prints the
reference's summary keys, and its last checkpoint restores bit for bit
through the reference's ``CheckpointStore``. The model-FLOP counts equal
the reference's exactly for the ten full configs and every shape kind."""

import ast
import ctypes
import dataclasses
import inspect
import json
import os
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.checkpoint import CheckpointStore as JaxStore  # noqa: E402
from repro.checkpoint import serialize as jser  # noqa: E402
from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamW  # noqa: E402
from repro.train import init_train_state as jax_init_state  # noqa: E402
from repro.train.train_step import state_template as jax_template  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.checkpoint import serialize as tser  # noqa: E402
from repro_torch.core import spot_sim  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import roofline as troof  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.train import (init_train_state,  # noqa: E402
                               state_template_on_device)

DAY = 86400


# ---------------------------------------------------------------------------
# the compile-cache sweep, twinned
# ---------------------------------------------------------------------------

@pytest.fixture
def fresh_sweeps(monkeypatch):
    """Both sweeps' rate limits start unarmed."""
    monkeypatch.setattr(jtrain, "_last_cache_gc", 0.0)
    monkeypatch.setattr(ttrain, "_last_cache_gc", 0.0)


def _populate(root, entries, now):
    """``entries``: (name, size, age in seconds or None for a directory)."""
    root.mkdir()
    for name, size, age in entries:
        p = root / name
        if age is None:
            p.mkdir()
            (p / "inner").write_bytes(b"d" * size)
            continue
        p.write_bytes(b"x" * size)
        os.utime(p, (now - age, now - age))


SWEEP_CASES = {
    # an old library, fresh ones over the budget, a build's object dir
    "age_then_size": ([("libspot_kernels-old.so", 1000, 30 * DAY),
                       ("libspot_kernels-a.so", 1000, 0),
                       ("libspot_kernels-b.so", 1000, 60),
                       ("libspot_kernels-b.ptxas.log", 500, 90),
                       ("libspot_kernels-c.so", 1000, 120),
                       ("obj-123", 4000, None)],
                      dict(max_bytes=2500, max_age_s=14 * DAY)),
    "under_budget": ([("a", 100, 3 * DAY), ("b", 200, 10)],
                     dict(max_bytes=1000, max_age_s=14 * DAY)),
    "all_too_old": ([("a", 100, 20 * DAY), ("b", 200, 15 * DAY),
                     ("build.lock", 0, 15 * DAY)],
                    dict(max_bytes=1 << 30, max_age_s=14 * DAY)),
    "zero_budget": ([("a", 10, 1), ("b", 20, 2), ("c", 0, 3)],
                    dict(max_bytes=0, max_age_s=14 * DAY)),
}


@pytest.mark.parametrize("case", sorted(SWEEP_CASES))
def test_sweep_removes_what_the_reference_removes(case, tmp_path,
                                                  fresh_sweeps):
    entries, kw = SWEEP_CASES[case]
    now = time.time()
    for pkg in ("jax", "torch"):
        _populate(tmp_path / pkg, entries, now)
    got = ttrain.sweep_compilation_cache(str(tmp_path / "torch"),
                                         min_interval_s=0, **kw)
    want = jtrain.sweep_compilation_cache(str(tmp_path / "jax"),
                                          min_interval_s=0, **kw)
    assert got == want
    assert sorted(os.listdir(tmp_path / "torch")) == \
        sorted(os.listdir(tmp_path / "jax"))


def test_sweep_honours_its_rate_limit_like_the_reference(tmp_path,
                                                         fresh_sweeps):
    now = time.time()
    for pkg in ("jax", "torch"):
        _populate(tmp_path / pkg, [("a", 100, 0)], now)
    for mod, pkg in ((jtrain, "jax"), (ttrain, "torch")):
        assert mod.sweep_compilation_cache(str(tmp_path / pkg),
                                           min_interval_s=3600) == 0
        # armed: an immediate rerun is a no-op even with garbage present
        junk = tmp_path / pkg / "junk"
        junk.write_bytes(b"z" * 5000)
        os.utime(junk, (now - 30 * DAY, now - 30 * DAY))
        assert mod.sweep_compilation_cache(str(tmp_path / pkg),
                                           min_interval_s=3600) == 0
        assert junk.exists()
    assert (ttrain.CACHE_GC_MAX_BYTES, ttrain.CACHE_GC_MAX_AGE_S,
            ttrain.CACHE_GC_MIN_INTERVAL_S) == \
        (jtrain.CACHE_GC_MAX_BYTES, jtrain.CACHE_GC_MAX_AGE_S,
         jtrain.CACHE_GC_MIN_INTERVAL_S)


def test_sweep_of_a_missing_directory_removes_nothing(tmp_path, fresh_sweeps):
    for mod in (jtrain, ttrain):
        assert mod.sweep_compilation_cache(str(tmp_path / "absent"),
                                           min_interval_s=0) == 0


# ---------------------------------------------------------------------------
# the kernel library's directory
# ---------------------------------------------------------------------------

@pytest.fixture
def lib_state(monkeypatch):
    """``_lib``'s module state, restored after the test."""
    for name in ("_lib", "_build_dir", "_build_seconds", "_built"):
        monkeypatch.setattr(_lib, name, getattr(_lib, name))
    monkeypatch.setattr(_lib, "_lib", None)
    return monkeypatch


class _FakeCDLL:
    """Stands in for the loaded library: every symbol takes argtypes."""

    def __init__(self, path):
        self.path = path

    def __getattr__(self, name):
        return type("Fn", (), {})()


def test_setup_compilation_cache_moves_the_library(tmp_path, lib_state):
    assert _lib.build_dir() == _lib.BUILD_DIR
    cache = tmp_path / "vol" / "kernels"
    assert ttrain.setup_compilation_cache(str(cache))
    assert cache.is_dir() and _lib.build_dir() == cache


def test_cli_refuses_a_compile_cache_dir_it_cannot_make(tmp_path, capsys,
                                                      lib_state):
    """Where the library cannot go to the cache directory, the CLI stops
    before training rather than building it in the repo."""
    blocker = tmp_path / "file"
    blocker.write_text("")
    with pytest.raises(SystemExit) as e:
        ttrain.main(["--arch", "gemma3-1b", "--smoke", "--device", "cpu",
                     "--compile-cache-dir", str(blocker / "kernels")])
    assert e.value.code == 2
    assert "--compile-cache-dir" in capsys.readouterr().err
    assert _lib.build_dir() == _lib.BUILD_DIR


def test_library_loads_a_cached_build_and_refreshes_it(tmp_path, lib_state):
    """A library already in the directory is loaded, not built (no nvcc),
    and its mtime (and its ptxas log's) is refreshed, so the sweep sees it
    as used."""
    lib_state.setattr(torch.cuda, "is_available", lambda: True)
    lib_state.setattr(ctypes, "CDLL", _FakeCDLL)

    def no_build(target):
        raise AssertionError("nvcc ran for a cached library")
    lib_state.setattr(_lib, "_build", no_build)
    _lib.set_build_dir(tmp_path)
    target = _lib._target()
    old = time.time() - 20 * DAY
    for p in (target, target.with_suffix(".ptxas.log")):
        p.write_bytes(b"lib")
        os.utime(p, (old, old))
    lib = _lib.library()
    assert lib.path == str(target)
    assert _lib.built() is False and _lib.build_seconds() is not None
    for p in (target, target.with_suffix(".ptxas.log")):
        assert time.time() - p.stat().st_mtime < DAY
    # a process loads one library
    with pytest.raises(RuntimeError, match="already loaded"):
        _lib.set_build_dir(tmp_path / "elsewhere")
    _lib.set_build_dir(tmp_path)              # the same place is fine


def test_library_builds_where_none_is_cached(tmp_path, lib_state):
    lib_state.setattr(torch.cuda, "is_available", lambda: True)
    lib_state.setattr(ctypes, "CDLL", _FakeCDLL)
    built = []

    def fake_build(target):
        built.append(target)
        target.write_bytes(b"lib")
    lib_state.setattr(_lib, "_build", fake_build)
    _lib.set_build_dir(tmp_path / "cold")
    _lib.library()
    assert built == [_lib._target()] and _lib.built() is True
    assert _lib.build_dir() == tmp_path / "cold"


# ---------------------------------------------------------------------------
# the CLI on the CPU
# ---------------------------------------------------------------------------

def _reference_summary_keys() -> list[str]:
    """The keys of the reference CLI's summary dict, read from its source."""
    tree = ast.parse(inspect.getsource(jtrain.main))
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == "summary":
            return [k.value for k in node.value.keys]
    raise AssertionError("no summary dict in the reference's main")


class _EvictAtBoot(spot_sim.PeriodicEviction):
    """One eviction, due as the first instance boots: the first step's
    metadata poll sees it, whatever the CPU's speed, and the urgent save
    that follows has the notice (Azure's 30 s) less the set-up and one
    step, which loaded test workers can stretch several times over."""

    def eviction_times(self, start):
        return iter([start])


@pytest.fixture
def evict_at_boot(monkeypatch):
    """A simulated cloud that evicts once, at boot: the CPU run rides one
    notice out."""
    import repro_torch.core as core
    monkeypatch.setattr(core, "PeriodicEviction", _EvictAtBoot)


@pytest.fixture
def few_threads():
    """Two intra-op threads while a CLI run lasts: the test's notice is
    wall time, and the test workers share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("arch", ["gemma3-1b", "deepseek-moe-16b"])
def test_cli_trains_through_an_eviction(arch, tmp_path, capsys, evict_at_boot,
                                        fresh_sweeps, lib_state, few_threads):
    steps = 6
    ckpt, cache = tmp_path / "ckpt", tmp_path / "ckpt" / "kernels"
    rc = ttrain.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--remat", "full", "--microbatches", "2",
                      "--steps", str(steps), "--stages", "2", "--batch", "4",
                      "--seq-len", "32", "--ckpt-dir", str(ckpt),
                      "--compile-cache-dir", str(cache),
                      "--simulate-eviction-every", "1",
                      "--provision-delay", "0.1", "--interval", "1"])
    out = capsys.readouterr().out
    lines = out.splitlines()
    lib_line = json.loads(lines[0])["kernel_library"]
    assert lib_line == {"dir": str(cache), "built": None, "seconds": None}
    summary = json.loads(out[out.index("\n{") + 1:])
    assert rc == 0 and summary["completed"]
    assert list(summary)[:len(_reference_summary_keys())] == \
        _reference_summary_keys()
    assert summary["evictions"] == 1 and summary["restores"] == 1
    assert summary["lost_steps"] == 0 and summary["instances_used"] == 2
    assert summary["coordinator"]["termination_ckpts"] == 1
    assert [u["committed"] for u in summary["urgent_saves"]] == [True]
    assert (summary["remat"], summary["microbatches"]) == ("full", 2)
    assert np.isfinite(summary["final_loss"])
    assert _lib.build_dir() == cache         # set before any library load
    assert cache.is_dir()

    # the last checkpoint, restored by the reference and by the port
    name = arch.replace("-", "_")
    jc = jax_smoke_config(name)
    tc = tconfigs.get_smoke_config(name)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    jrestored, jman = JaxStore(str(ckpt)).restore(
        jax_template(jax_init_state(jc, JaxAdamW(total_steps=steps))))
    tstate = init_train_state(tc, AdamWConfig(total_steps=steps),
                              device="cpu")
    trestored, tman = CheckpointStore(str(ckpt)).restore(
        state_template_on_device(tstate, "cpu"))
    assert jman.step == tman.step and 0 < tman.step <= steps
    got = {k: np.asarray(v) for k, v in jser.flatten_state(jrestored).items()}
    want = tser.flatten_state(trestored)
    assert list(got) == list(want)
    for n, arr in got.items():
        np.testing.assert_array_equal(
            np.ascontiguousarray(arr).reshape(-1).view(np.uint8),
            tser.to_host(want[n]).reshape(-1).view(np.uint8), err_msg=n)
    assert int(trestored["step"]) == tman.step


def test_cli_flags_are_the_references_plus_device():
    def flags(main):
        src = inspect.getsource(main)
        return [n.args[0].value for n in ast.walk(ast.parse(src))
                if isinstance(n, ast.Call)
                and getattr(n.func, "attr", None) == "add_argument"]
    assert flags(ttrain.main) == flags(jtrain.main) + ["--device"]


# ---------------------------------------------------------------------------
# the analytic roofline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_model_flops_equal_the_references(arch):
    jc, tc = jax_get_config(arch), tconfigs.get_config(arch)
    assert troof.active_matmul_params(tc) == jroof.active_matmul_params(jc)
    assert troof._scan_flops_per_token(tc) == jroof._scan_flops_per_token(jc)
    for shape, sh in JAX_SHAPES.items():
        assert tconfigs.SHAPES[shape] == sh
        assert troof._attn_context_sum(tc, sh["seq_len"]) == \
            jroof._attn_context_sum(jc, sh["seq_len"])
        for kind in ("train", "prefill", "decode"):
            kw = dict(kind=kind, batch=sh["global_batch"],
                      seq_len=sh["seq_len"])
            assert troof.model_flops(tc, **kw) == jroof.model_flops(jc, **kw), \
                (shape, kind)


def test_model_flops_refuses_an_unknown_kind():
    with pytest.raises(ValueError):
        troof.model_flops(tconfigs.get_config("gemma3_1b"), kind="serve",
                          batch=1, seq_len=8)


def test_roofline_terms_on_the_h100s_rates():
    t = troof.roofline_terms(per_device_flops=989e12, per_device_bytes=6.7e12,
                             per_device_coll_bytes=450e9)
    assert (t["compute_s"], t["memory_s"], t["collective_s"]) == \
        (989e12 / tmesh.PEAK_FLOPS_BF16, 6.7e12 / tmesh.HBM_BW,
         450e9 / tmesh.NVLINK_BW)
    assert t["dominant"] == "memory" and t["bound_s"] == pytest.approx(2.0)
    # the same bookkeeping as the reference's, on its own rates
    j = jroof.roofline_terms(per_device_flops=1e12, per_device_bytes=1e9,
                             per_device_coll_bytes=1e8)
    p = troof.roofline_terms(per_device_flops=1e12, per_device_bytes=1e9,
                             per_device_coll_bytes=1e8)
    assert set(p) == set(j) and p["dominant"] == "compute" == j["dominant"]
