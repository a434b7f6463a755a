"""The port's example scripts (``examples/torch_*.py``, twins of the
reference's four examples) run end to end on the CPU at their smallest
arguments, each in a process of its own, and each passes the check its
reference makes: a bit-exact resume, continued tokens, the loss down,
identical values after 8 -> 4 ranks. Without ``--device cpu`` they run on
the card, and refuse where there is none."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
# script, smallest arguments, what its output must say
EXAMPLES = {
    "torch_quickstart.py": (["--steps", "60", "--evict-every", "400"],
                            ["bit-exact: True", "lost steps:           0",
                             "evictions survived:   1"]),
    "torch_serve_demo.py": ([], ["continued after restore: True"]),
    "torch_spot_training.py": (["--model", "smoke", "--steps", "40"],
                               ["simulate-eviction issued", "restores:           1"]),
    "torch_elastic_restore.py": ([], ["saved on 8 ranks",
                                      "restored on 4 ranks ((2, 2)): bit-exact ✓"]),
}


def run(script: str, args: list[str], env_extra: dict | None = None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               **(env_extra or {}))
    return subprocess.run([sys.executable, str(ROOT / "examples" / script),
                           *args], capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=240)


@pytest.mark.parametrize("script", list(EXAMPLES))
def test_example_runs_on_the_cpu(script):
    args, says = EXAMPLES[script]
    res = run(script, [*args, "--device", "cpu"])
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    lines = res.stdout.splitlines()
    assert lines[-1] == "OK"
    for text in says:
        assert any(text in line for line in lines), (text, res.stdout)


@pytest.mark.parametrize("script", list(EXAMPLES))
def test_example_refuses_without_a_gpu(script):
    args, _says = EXAMPLES[script]
    res = run(script, args, {"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert "OK" not in res.stdout.splitlines()
    assert "no CUDA GPU" in res.stderr
