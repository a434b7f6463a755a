"""The scans' backward as torch ops (``repro_torch::ssm_scan_bwd``,
``repro_torch::rglru_scan_bwd``), on the CPU: gradients through them bit
for bit those of autograd over the plain version (the path they replace,
which is also what they run, on either device), one op a backward, and
each op's FLOP formula against a count of what that plain autograd
computes.

The count: every element of every arithmetic op the plain autograd runs
(multiplies, adds, exponentials; a reduction counts its input), the
recomputed forward included, leaving out autograd's adds of each step's
gradient slice into a zero tensor the size of the whole input (the
accumulation of ``select_backward`` outputs, quadratic in S, which the
formulas exclude by design). ``launch/op_analysis.py`` follows
``torch.utils.flop_counter``'s registry, which counts products only, so
its plain count of either backward is 0: the count here is the one the
formulas are held to, exactly (every dimension above 1: one of 1 drops a
broadcast's reduction)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.kernels.rglru_scan import ops as ro  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as so  # noqa: E402
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref  # noqa: E402
from repro_torch.launch import op_analysis as OA  # noqa: E402

ARITH = {"mul", "add", "sub", "div", "exp", "neg", "sum"}


class _Arith(TorchDispatchMode):
    """Counts the arithmetic elements of the ops run under it (see the
    module docstring) and the calls of each op."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.calls: dict[str, int] = {}
        self._slices: list = []        # select_backward outputs and their sums

    def _is_slice(self, t) -> bool:
        return any(t is s for s in self._slices)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func._opname
        key = f"{func.namespace}::{name}"
        self.calls[key] = self.calls.get(key, 0) + 1
        ins = [a for a in args if isinstance(a, torch.Tensor)]
        if name == "select_backward" or (name == "add" and any(
                self._is_slice(t) for t in ins)):
            self._slices.append(out)
        elif name == "sum":
            self.flops += ins[0].numel()
        elif name in ARITH:
            self.flops += out.numel()
        return out


def _ssm_inputs(Bb, S, DI, N, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)

    def r(*shape, lo=0.0, hi=1.0):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32))
    return [r(Bb, S, DI).to(dtype), (r(Bb, S, DI) * 0.1).to(dtype),
            -r(DI, N, lo=0.5, hi=2.0), r(Bb, S, N), r(Bb, S, N), r(DI)]


def _lru_inputs(Bb, S, W, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.uniform(lo, hi, (Bb, S, W)).astype(
        np.float32)).to(dtype) for lo, hi in ((0.5, 0.99), (-1.0, 1.0))]


def _grads_plain(ref, xs, dy):
    inputs = [t.detach().requires_grad_(True) for t in xs]
    return torch.autograd.grad(ref(*inputs)[0], inputs, dy)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_grads_through_the_op_equal_plain_autograd(dtype):
    xs = _ssm_inputs(2, 12, 6, 4, dtype)
    leaves = [t.clone().requires_grad_(True) for t in xs]
    y = so.selective_scan(*leaves)
    dy = torch.from_numpy(np.random.default_rng(1).standard_normal(
        y.shape).astype(np.float32)).to(y.dtype)
    with _Arith() as m:
        got = torch.autograd.grad(y, leaves, dy)
    assert m.calls["repro_torch::ssm_scan_bwd"] == 1
    for g, w in zip(got, _grads_plain(ssm_scan_ref, xs, dy)):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lru_scan_grads_through_the_op_equal_plain_autograd(dtype):
    xs = _lru_inputs(2, 12, 6, dtype)
    leaves = [t.clone().requires_grad_(True) for t in xs]
    h = ro.lru_scan(*leaves)
    dh = torch.from_numpy(np.random.default_rng(1).standard_normal(
        h.shape).astype(np.float32)).to(h.dtype)
    with _Arith() as m:
        got = torch.autograd.grad(h, leaves, dh)
    assert m.calls["repro_torch::rglru_scan_bwd"] == 1
    for g, w in zip(got, _grads_plain(rglru_scan_ref, xs, dh)):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_a_gradient_not_asked_for_is_none():
    xs = _ssm_inputs(1, 4, 3, 2)
    u = xs[0].clone().requires_grad_(True)
    y = so.selective_scan(u, *xs[1:])
    (gu,) = torch.autograd.grad(y.sum(), [u])
    assert gu.shape == u.shape


@pytest.mark.parametrize("shape", [(2, 3, 5, 4), (2, 16, 16, 16),
                                   (3, 32, 32, 16), (4, 8, 64, 16)])
def test_ssm_scan_bwd_flops_match_the_plain_autograd(shape):
    xs = _ssm_inputs(*shape)
    dy = torch.ones(shape[:3])
    with _Arith() as m:
        so._scan_bwd(*xs, dy)
    formula = so._scan_bwd_flops(*(tuple(t.shape) for t in xs), dy.shape)
    assert formula == m.flops
    # and the trace of the card's path counts the formula for the op
    a = OA.analyze(lambda: so.BWD(*xs, dy), device="cpu")
    assert a["flops"] == formula
    # op_analysis's plain count follows flop_counter's registry: no
    # product in the plain backward, so nothing
    assert OA.analyze(lambda: so.BWD(*xs, dy), device="cpu",
                      plain=True)["flops"] == 0


@pytest.mark.parametrize("shape", [(2, 8, 6), (2, 32, 64), (4, 16, 128)])
def test_rglru_scan_bwd_flops_match_the_plain_autograd(shape):
    xs = _lru_inputs(*shape)
    dh = torch.ones(shape)
    with _Arith() as m:
        ro._scan_bwd(*xs, dh)
    formula = ro._scan_bwd_flops(shape, shape, shape)
    assert formula == m.flops
    assert OA.analyze(lambda: ro.BWD(*xs, dh), device="cpu")["flops"] == formula
