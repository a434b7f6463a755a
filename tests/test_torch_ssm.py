"""The port's selective scan, its Mamba-1 block and the RG-LRU scan's
gradient against the JAX package, on the same inputs made with numpy.

Tolerances: in float32 the scans differ only in the order of rounding (the
reference's log-depth associative scan against the port's sequential one),
1e-4 as ``tests/test_kernels.py`` holds the Pallas scans, values and
gradients; in bfloat16 5e-2, as there. The Mamba block and decode step,
whose float32 products and sums run in another order, to 1e-5 relative to
the output's largest element."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.rglru_scan import lru_scan as jax_lru_scan  # noqa: E402
from repro.kernels.ssm_scan import selective_scan as jax_selective_scan  # noqa: E402
from repro.kernels.ssm_scan import ssm_scan as jax_ssm_scan  # noqa: E402
from repro.kernels.ssm_scan import ssm_scan_ref as jax_ssm_ref  # noqa: E402
from repro.models import ssm as JSSM  # noqa: E402
from repro.models.config import SSMConfig  # noqa: E402
from repro.models.transformer import _mamba_params as jax_mamba_params  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels.rglru_scan import lru_scan, rglru_scan_ref  # noqa: E402
from repro_torch.kernels.ssm_scan import (selective_scan, ssm_scan,  # noqa: E402
                                          ssm_scan_ref)
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

NP_DT = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x).astype(np.float32)


def pair(x: np.ndarray, dtype: str = "float32"):
    """The same values for JAX (numpy) and the port (a tensor), bfloat16 by
    round-to-nearest-even on both sides."""
    x = x.astype(np.float32)
    return x.astype(NP_DT[dtype]), torch.from_numpy(x.copy()).to(T_DT[dtype])


def scan_inputs(B, S, DI, N, dtype, seed):
    """tests/test_kernels.py's distributions: u normal, dt = softplus(n - 2),
    A = -exp(0.3 n), B and C normal (float32), D = 0.5."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((B, S, DI))
    dt = np.log1p(np.exp(rng.standard_normal((B, S, DI)) - 2.0))
    A = -np.exp(rng.standard_normal((DI, N)) * 0.3)
    Bm, Cm = rng.standard_normal((B, S, N)), rng.standard_normal((B, S, N))
    D = np.full((DI,), 0.5)
    return [pair(u, dtype), pair(dt, "float32"), pair(A), pair(Bm), pair(Cm),
            pair(D)]


SCAN_CASES = [
    # B, S, DI, N, block_d, chunk, dtype, tol (tests/test_kernels.py)
    (2, 128, 256, 16, 128, 32, "float32", 1e-4),
    (1, 64, 512, 8, 512, 64, "float32", 1e-4),
    (2, 96, 128, 16, 64, 32, "float32", 1e-4),
    (1, 128, 256, 16, 256, 64, "bfloat16", 5e-2),
]


@pytest.mark.parametrize("B,S,DI,N,bd,ch,dtype,tol", SCAN_CASES)
def test_ssm_scan_plain_matches_reference_and_interpret(B, S, DI, N, bd, ch,
                                                        dtype, tol):
    ins = scan_inputs(B, S, DI, N, dtype, S * DI)
    (ju, u), (jdt, dt), (jA, A), (jB, Bm), (jC, Cm), (jD, D) = ins
    dt = dt.to(u.dtype)           # the port's kernel takes delta in u's dtype
    jdt = f32(dt).astype(NP_DT[dtype])
    y, h = ssm_scan(u, dt, A, Bm, Cm, D)
    assert y.dtype == u.dtype and h.dtype == torch.float32
    for jy, jh in (jax_ssm_ref(ju, jdt, jA, jB, jC, jD),
                   jax_ssm_scan(ju, jdt, jA, jB, jC, jD, block_d=bd, chunk=ch,
                                interpret=True)):
        np.testing.assert_allclose(f32(y), f32(jy), atol=tol)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=tol)
    yr, hr = ssm_scan_ref(u, dt, A, Bm, Cm, D)
    assert torch.equal(yr, y) and torch.equal(hr, h)
    assert torch.equal(selective_scan(u, dt, A, Bm, Cm, D), y)


def test_selective_scan_grads_match_reference():
    """Gradients of every input through the port's selective_scan (the
    plain version differentiated) against the reference's custom_vjp (its
    jnp version differentiated) and jax.grad of its ssm_scan_ref, for the
    same sum(y * w)."""
    ins = scan_inputs(1, 32, 64, 8, "float32", 0)
    jargs = [j for j, _ in ins]
    targs = [t.requires_grad_(True) for _, t in ins]
    wgt = np.random.default_rng(1).standard_normal((1, 32, 64)).astype(np.float32)
    got = torch.autograd.grad(
        (selective_scan(*targs) * torch.from_numpy(wgt)).sum(), targs)
    argn = tuple(range(6))
    for want in (jax.grad(lambda *a: jnp.sum(jax_selective_scan(*a, 64, 16, True)
                                             * wgt), argn)(*jargs),
                 jax.grad(lambda *a: jnp.sum(jax_ssm_ref(*a)[0] * wgt),
                          argn)(*jargs)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(f32(g), f32(w), atol=1e-4)


def test_lru_scan_grads_match_reference():
    """The RG-LRU scan's gradients through the port's lru_scan against the
    reference's lru_scan (interpret mode, gradients via its jnp oracle)."""
    rng = np.random.default_rng(4)
    ja, a = pair(1.0 / (1.0 + np.exp(-rng.standard_normal((2, 64, 128)))))
    jb, b = pair(rng.standard_normal((2, 64, 128)))
    wgt = rng.standard_normal((2, 64, 128)).astype(np.float32)
    a.requires_grad_(True)
    b.requires_grad_(True)
    h = lru_scan(a, b)
    assert torch.equal(h.detach(), rglru_scan_ref(a.detach(), b.detach())[0])
    got = torch.autograd.grad((h * torch.from_numpy(wgt)).sum(), (a, b))
    want = jax.grad(lambda x, y: jnp.sum(jax_lru_scan(x, y, 128, 32, True) * wgt),
                    (0, 1))(ja, jb)
    for g, w in zip(got, want):
        np.testing.assert_allclose(f32(g), f32(w), atol=1e-4)


def test_raw_scans_refuse_grad_and_cpu_counts_nothing():
    ins = [t for _, t in scan_inputs(1, 4, 8, 16, "float32", 2)]
    _lib.reset_launches()
    selective_scan(*ins)
    assert all(v == 0 for v in _lib.LAUNCHES.values())
    ins[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ssm_scan(*ins)
    with torch.no_grad():
        ssm_scan(*ins)


SCFG = SSMConfig(d_state=4, d_conv=4, expand=2)
D_MODEL = 32


def mamba_weights(seed=0):
    """The reference's own Mamba parameters (float32), for both packages."""
    cfg = ModelConfig(name="t", family="ssm", n_layers=1, d_model=D_MODEL,
                      n_heads=1, n_kv_heads=1, head_dim=1, d_ff=0,
                      vocab_size=8, block_pattern=("mamba",), ssm=SCFG,
                      dtype="float32")
    jw = jax_mamba_params(jax.random.key(seed), cfg, jnp.float32)
    tw = {k: torch.from_numpy(np.array(v)) for k, v in jw.items()}
    return jw, tw


def close_rel(got, want, tol=1e-5):
    g, w = f32(got), f32(want)
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, atol=tol * max(1.0, float(np.abs(w).max())))


def test_mamba_block_matches_reference():
    jw, tw = mamba_weights()
    rng = np.random.default_rng(5)
    jx, x = pair(rng.standard_normal((2, 12, D_MODEL)))
    close_rel(SSM.mamba_block(x, tw, SCFG), JSSM.mamba_block(jx, jw, SCFG))
    jx1, x1 = pair(rng.standard_normal((2, 1, D_MODEL)))   # one token: no conv
    close_rel(SSM.mamba_block(x1, tw, SCFG), JSSM.mamba_block(jx1, jw, SCFG))


def test_mamba_step_matches_reference():
    jw, tw = mamba_weights(1)
    rng = np.random.default_rng(6)
    jstate = JSSM.mamba_init_state(2, D_MODEL, SCFG, jnp.float32)
    state = SSM.mamba_init_state(2, D_MODEL, SCFG, torch.float32)
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: v.shape for k, v in jstate.items()}
    assert state["ssm"].dtype == torch.float32
    for t in range(5):
        jx, x = pair(rng.standard_normal((2, 1, D_MODEL)))
        y, state = SSM.mamba_step(x, state, tw, SCFG)
        jy, jstate = JSSM.mamba_step(jx, jstate, jw, SCFG)
        close_rel(y, jy)
        for k in ("conv", "ssm"):
            close_rel(state[k], jstate[k])


def test_selective_scan_step_matches_reference():
    rng = np.random.default_rng(7)
    (js, s), (ju, u), (jd, d) = (pair(rng.standard_normal(sh)) for sh in
                                 ((2, 16, 4), (2, 16), (2, 16)))
    d, jd = torch.nn.functional.softplus(d), np.log1p(np.exp(jd))
    (jA, A), (jB, Bt), (jC, Ct), (jD, D) = (pair(rng.standard_normal(sh)) for sh in
                                            ((16, 4), (2, 4), (2, 4), (16,)))
    A, jA = -torch.exp(A), -np.exp(jA)
    y, ns = SSM.selective_scan_step(s, u, d, A, Bt, Ct, D)
    jy, jns = JSSM.selective_scan_step(js, ju, jd.astype(np.float32),
                                       jA.astype(np.float32), jB, jC, jD)
    close_rel(y, jy)
    close_rel(ns, jns)
