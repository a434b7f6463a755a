"""Boundaries of the PyTorch port: it imports neither JAX nor the JAX
package (nor ``ml_dtypes``, which ships with JAX), its entry points default
to the GPU and refuse to run without one, and the chip smoke script fails
where there is no GPU instead of printing a result."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.checkpoint import serialize as ser  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.train import (init_train_state,  # noqa: E402
                               state_template_on_device)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    + sorted((ROOT / "examples").glob("torch_*.py"))
    + [ROOT / "examples" / "decode_step_time.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    assert not imported_roots(path) & set(FORBIDDEN)


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.train, repro_torch.checkpoint, "
            "repro_torch.core, repro_torch.kernels.quantize, "
            "repro_torch.kernels.fingerprint, repro_torch.serve, "
            "repro_torch.kernels.flash_attention, "
            "repro_torch.kernels.decode_attention, "
            "repro_torch.kernels.rglru_scan, repro_torch.kernels.ssm_scan, "
            "repro_torch.kernels.chunk_digest, "
            "repro_torch.checkpoint.peer_exchange, repro_torch.core.fleet, "
            "repro_torch.core.elastic, repro_torch.models.ssm, "
            "repro_torch.distributed, repro_torch.distributed.multihost, "
            "repro_torch.launch.mesh, repro_torch.analysis.spotlint, "
            "repro_torch.analysis.lock_witness; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(ROOT / "src"),
                                         "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_refuse_without_a_gpu(no_gpu):
    cfg = get_smoke_config("phi3_mini_3p8b")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        init_train_state(cfg, AdamWConfig())
    state = init_train_state(cfg, AdamWConfig(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        state_template_on_device(state)
    tpl = state_template_on_device(state, "cpu")
    assert all(leaf.device.type == "cpu"
               for leaf in ser.flatten_state(tpl).values())


def test_serve_entry_points_refuse_without_a_gpu(no_gpu):
    from repro_torch.models import init_cache
    from repro_torch.serve import generate, make_decode_step, make_prefill
    cfg = get_smoke_config("gemma3_1b")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        make_prefill(cfg, cache_len=16)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        make_decode_step(cfg)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        init_cache(cfg, 2, 16)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        generate(params, cfg, np.zeros((2, 4), np.int32), 2)
    out = generate(params, cfg, np.zeros((2, 4), np.int32), 2, device="cpu")
    assert tuple(out.shape) == (2, 2)


def test_flash_attention_refuses_an_input_that_requires_grad():
    """The raw forward kernel records no backward and refuses grad, as a raw
    ``pallas_call`` has no VJP; ``flash_attention`` is differentiable."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_fwd)
    q = torch.randn(1, 8, 2, 32, requires_grad=True)
    k = torch.randn(1, 8, 1, 32)
    with pytest.raises(RuntimeError, match="requires? grad"):
        flash_attention_fwd(q, k, k)
    with pytest.raises(RuntimeError, match="requires? grad"):
        flash_attention_fwd(q.detach(), k.requires_grad_(True), k)
    dq, dk = torch.autograd.grad(flash_attention(q, k, k).sum(), (q, k))
    assert dq.shape == q.shape and dk.shape == k.shape
    assert bool(torch.isfinite(dq).all()) and bool(dq.abs().sum() > 0)


def test_trainer_refuses_without_a_gpu(no_gpu, tmp_path):
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.core import (AZURE_D8S_V3, CheckpointPolicy,
                                  CostAccountant, NoEviction, ScaleSet,
                                  SpotOnCoordinator, VirtualClock)
    from repro_torch.train import SpotTrainer, TrainJob
    clock = VirtualClock()
    pool = ScaleSet(clock=clock, schedule=NoEviction(),
                    accountant=CostAccountant(AZURE_D8S_V3))
    coord = SpotOnCoordinator(CheckpointStore(str(tmp_path)),
                              CheckpointPolicy.off(), clock)
    job = TrainJob(cfg=get_smoke_config("phi3_mini_3p8b"),
                   opt=AdamWConfig(), total_steps=2)
    try:
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            SpotTrainer(job, coord, pool, clock)
    finally:
        coord.close()


def test_state_from_numpy_takes_bfloat16_by_dtype_name():
    import ml_dtypes
    from repro_torch.train import state_from_numpy
    a = np.arange(6, dtype=np.float32).astype(ml_dtypes.bfloat16)
    st = state_from_numpy({"params/w": a, "step": np.array(3, np.int32)},
                          device="cpu")
    assert st["params"]["w"].dtype == torch.bfloat16
    assert st["params"]["w"].tolist() == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]
    assert st["step"].dtype == torch.int32 and st["step"].ndim == 0


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "script_alone"])
def test_chip_smoke_fails_without_a_gpu(tmp_path, alone):
    script = ROOT / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    res = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, cwd=script.parent, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
