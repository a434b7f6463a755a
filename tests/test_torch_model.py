"""The port's dense model, loss and AdamW step against the JAX package, on
the reference's own parameters (carried across with ``state_from_numpy``).

Tolerances: in float32 (``cfg.scaled(dtype="float32")``) only the order of
summation differs between the two, so values agree elementwise to 1e-5
(relative and absolute). In bfloat16 the two frameworks round intermediates
at different places (XLA fuses elementwise chains in float32), and each
package's gradients sit about 1.5% (relative error norm) from the float32
computation of the same function, so from each other by as much. A bfloat16
result of the port is therefore held to the reference run in float32 on the
same (bfloat16-valued) parameters, at a relative error norm
``|a - b| / |b|`` of 2e-2."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import serialize as jser  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamW  # noqa: E402
from repro.train import init_train_state as jax_init_state  # noqa: E402
from repro.train import make_train_step as jax_make_step  # noqa: E402
from repro.train.train_step import fused_unembed_xent as jax_xent  # noqa: E402
from repro_torch.checkpoint import serialize as tser  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import forward  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.train import make_train_step, state_from_numpy  # noqa: E402
from repro_torch.train.train_step import fused_unembed_xent  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# a gradient element is resolved (its sign is the same in both packages)
# above this share of its leaf's largest: 100x the f32 tolerance, and in
# bf16 well above the gradients' 1.5% relative error
GRAD_RESOLVED = {"float32": 1e-3, "bfloat16": 0.25}
B, S = 2, 16
LAYERS = 2


def configs(dtype):
    jc = jax_smoke_config("phi3_mini_3p8b").scaled(dtype=dtype, n_layers=LAYERS)
    tc = get_smoke_config("phi3_mini_3p8b").scaled(dtype=dtype, n_layers=LAYERS)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def batch(vocab, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"inputs": tok[:, :-1], "labels": tok[:, 1:]}


def to_numpy(tree) -> dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in jser.flatten_state(tree).items()}


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x).astype(np.float32)


def rel_err(got, want) -> float:
    a, b = f32(got).astype(np.float64), f32(want).astype(np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def close(got, want, dtype, what=""):
    if dtype == "float32":
        np.testing.assert_allclose(f32(got), f32(want), rtol=TOL[dtype],
                                   atol=TOL[dtype], err_msg=what)
    else:
        assert rel_err(got, want) <= TOL[dtype], (what, rel_err(got, want))


@pytest.fixture(params=["float32", "bfloat16"])
def pair(request):
    """(dtype, reference config, port config, reference state, port state):
    the port runs in ``dtype``, the reference in float32 on the same values."""
    dtype = request.param
    _jc, tc = configs(dtype)
    jc, _ = configs("float32")
    jstate = jax_init_state(_jc, JaxAdamW(total_steps=10, warmup_steps=2), seed=3)
    tstate = state_from_numpy(to_numpy(jstate), device="cpu")
    jstate = jax.tree.map(lambda x: x.astype(jnp.float32)
                          if x.dtype == jnp.bfloat16 else x, jstate)
    return dtype, jc, tc, jstate, tstate


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_state_from_numpy_keeps_names_dtypes_and_bits(dtype):
    jc, _tc = configs(dtype)
    jstate = jax_init_state(jc, JaxAdamW(), seed=3)
    tstate = state_from_numpy(to_numpy(jstate), device="cpu")
    jn, tn = to_numpy(jstate), tser.flatten_state(tstate)
    assert list(tn) == list(jn)
    for k, v in jn.items():
        assert tser.dtype_to_name(tn[k].dtype) == v.dtype.name, k
        assert tuple(tn[k].shape) == v.shape, k
        np.testing.assert_array_equal(
            tser.to_host(tn[k]).reshape(-1).view(np.uint8),
            np.ascontiguousarray(v).reshape(-1).view(np.uint8), err_msg=k)
    assert "params/segments/0/pos0/attn/wq" in tn
    assert tn["rng"].dtype == torch.uint32 and tn["step"].dtype == torch.int32


def test_logits_match(pair):
    dtype, jc, tc, jstate, tstate = pair
    b = batch(jc.vocab_size)
    jlog, _aux, _ = jax_forward(jstate["params"], jc, jnp.asarray(b["inputs"]))
    tlog, _aux = forward(tstate["params"], tc, torch.from_numpy(b["inputs"]))
    assert tuple(tlog.shape) == (B, S, jc.vocab_size)
    close(tlog, jlog, dtype, "logits")


def test_loss_and_grads_match(pair):
    dtype, jc, tc, jstate, tstate = pair
    b = batch(jc.vocab_size, seed=1)
    from repro.models.transformer import unembed_weights as jhead

    def jloss(params):
        h, _aux, _ = jax_forward(params, jc, jnp.asarray(b["inputs"]),
                                 return_hidden=True)
        return jax_xent(h, jhead(params, jc), jnp.asarray(b["labels"]))
    jl, jg = jax.value_and_grad(jloss)(jstate["params"])

    named = tser.flatten_state(tstate["params"])
    leaves = {k: v.detach().requires_grad_(True) for k, v in named.items()}
    params = tser.unflatten_like(tstate["params"], leaves)
    h, _aux = forward(params, tc, torch.from_numpy(b["inputs"]),
                      return_hidden=True)
    tl = fused_unembed_xent(h, params["lm_head"],
                            torch.from_numpy(b["labels"]))
    tg = torch.autograd.grad(tl, list(leaves.values()))
    close(tl, jl, dtype, "loss")
    jgn = to_numpy(jg)
    for (k, g) in zip(leaves, tg):
        # grads are compared in units of their own scale
        scale = max(float(np.abs(f32(jgn[k])).max()), 1e-30)
        close(f32(g) / scale, f32(jgn[k]) / scale, dtype, k)


def test_one_adamw_train_step_matches(pair):
    dtype, jc, tc, jstate, tstate = pair
    b = batch(jc.vocab_size, seed=2)
    jstep = jax.jit(jax_make_step(jc, JaxAdamW(total_steps=10, warmup_steps=2)))
    tstep = make_train_step(tc, AdamWConfig(total_steps=10, warmup_steps=2))
    jnew, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
    tnew, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
    close(tm["loss"], jm["loss"], dtype, "loss")
    close(tm["grad_norm"], jm["grad_norm"], dtype, "grad_norm")
    jn, tn = to_numpy(jnew), tser.flatten_state(tnew)
    jold = to_numpy(jstate)
    lr = float(jm["lr"])
    assert lr > 0
    assert list(tn) == list(jn)
    for k, v in jn.items():
        if dtype == "float32":
            assert tser.dtype_to_name(tn[k].dtype) == v.dtype.name, k
        if v.dtype.kind in "iu":
            np.testing.assert_array_equal(tn[k].numpy(), v, err_msg=k)
        elif k.startswith("params/"):
            # AdamW's first update is lr * (g/(|g| + eps) + wd * p), about
            # lr * sign(g): a weight whose gradient cancels to near zero may
            # move either way within the gradients' own tolerance, so only
            # weights whose gradient is well resolved (|g| above GRAD_RESOLVED
            # of the leaf's largest, read off the reference's first moment)
            # have a determined update. There the port's update must match
            # the reference's to TOL of lr, plus the rounding of the new
            # parameter to its own dtype: a missing or sign-flipped update
            # (off by lr or 2 lr) fails
            mom = np.abs(jn["opt/mu/" + k[len("params/"):]])
            resolved = mom > GRAD_RESOLVED[dtype] * mom.max()
            assert resolved.any(), k
            new_t = f32(tn[k]).astype(np.float64)
            new_j, old = f32(v).astype(np.float64), f32(jold[k]).astype(np.float64)
            # both round the new value to f32 on their own (one f32 unit in
            # the last place); the port's bf16 store adds half a bf16 unit
            ulp = np.spacing(np.abs(f32(v)) + np.float32(lr)).astype(np.float64)
            rounding = ulp + (0.5 * ulp * 2 ** 16 if dtype == "bfloat16" else 0)
            err = np.abs((new_t - old) - (new_j - old))
            lim = TOL[dtype] * lr + rounding
            bad = resolved & (err > lim)
            assert not bad.any(), (k, int(bad.sum()), float(err[bad].max()))
            # and every weight stays within the 2 lr an unresolved one may move
            np.testing.assert_allclose(new_t, new_j, rtol=TOL[dtype],
                                       atol=2 * lr, err_msg=k)
        elif "/nu/" in k and dtype == "bfloat16":
            # nu ~ g^2 doubles the gradients' relative error; the update
            # reads it through sqrt, which is where it is held
            close(torch.sqrt(tn[k]), np.sqrt(v), dtype, k)
        else:
            close(tn[k], v, dtype, k)


def test_adamw_update_matches():
    """One AdamW update on the same parameters, gradients and moments."""
    from repro.optim import adamw_update as jax_adamw
    from repro_torch.optim import adamw_update
    rng = np.random.default_rng(7)
    shapes = {"a": (3, 64, 32), "b": (64,), "c": (128, 16)}
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    g = {k: (rng.standard_normal(s) * 0.3).astype(np.float32)
         for k, s in shapes.items()}
    mu = {k: (rng.standard_normal(s) * 0.01).astype(np.float32)
          for k, s in shapes.items()}
    nu = {k: (rng.random(s) * 1e-3).astype(np.float32) for k, s in shapes.items()}
    count = np.array(4, np.int32)
    for cfg_kw in ({}, {"clip_norm": 0.1}, {"warmup_steps": 2, "total_steps": 9}):
        jp, jo, jmet = jax_adamw(
            {k: jnp.asarray(v) for k, v in g.items()},
            {"mu": {k: jnp.asarray(v) for k, v in mu.items()},
             "nu": {k: jnp.asarray(v) for k, v in nu.items()},
             "count": jnp.asarray(count)},
            {k: jnp.asarray(v) for k, v in p.items()}, JaxAdamW(**cfg_kw))
        tp, to, tmet = adamw_update(
            {k: torch.from_numpy(v) for k, v in g.items()},
            {"mu": {k: torch.from_numpy(v) for k, v in mu.items()},
             "nu": {k: torch.from_numpy(v) for k, v in nu.items()},
             "count": torch.from_numpy(count)},
            {k: torch.from_numpy(v) for k, v in p.items()}, AdamWConfig(**cfg_kw))
        for k in shapes:
            close(tp[k], jp[k], "float32", k)
            close(to["mu"][k], jo["mu"][k], "float32", k)
            close(to["nu"][k], jo["nu"][k], "float32", k)
        assert int(to["count"]) == int(jo["count"]) == 5
        close(tmet["lr"], jmet["lr"], "float32", "lr")
        close(tmet["grad_norm"], jmet["grad_norm"], "float32", "grad_norm")


def test_train_step_never_writes_its_input():
    _jc, tc = configs("float32")
    jstate = jax_init_state(_jc, JaxAdamW(), seed=0)
    tstate = state_from_numpy(to_numpy(jstate), device="cpu")
    before = {k: v.clone() for k, v in tser.flatten_state(tstate).items()}
    b = batch(tc.vocab_size)
    make_train_step(tc, AdamWConfig())(
        tstate, {k: torch.from_numpy(v) for k, v in b.items()})
    for k, v in tser.flatten_state(tstate).items():
        assert torch.equal(v, before[k]), k


def test_layers_match_reference_pieces():
    from repro.models import layers as JL
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = np.arange(5)
    np.testing.assert_allclose(
        L.rope(torch.from_numpy(x), torch.from_numpy(pos), theta=1e4).numpy(),
        np.asarray(JL.rope(jnp.asarray(x), jnp.asarray(pos), theta=1e4)),
        rtol=1e-5, atol=1e-6)
    w = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        L.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        rtol=1e-5, atol=1e-6)
    q = rng.standard_normal((1, 6, 4, 8)).astype(np.float32)
    k = rng.standard_normal((1, 6, 2, 8)).astype(np.float32)
    v = rng.standard_normal((1, 6, 2, 8)).astype(np.float32)
    np.testing.assert_allclose(
        L.attention(*map(torch.from_numpy, (q, k, v))).numpy(),
        np.asarray(JL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))),
        rtol=1e-5, atol=1e-6)


def test_once_unported_paths_resolve():
    """The MoE archs and the factored second moment, refused by earlier
    slices, now resolve: grok-1's config, and a {row, col} pair of float32
    means for a 64 x 64 leaf (a vector stays dense)."""
    from repro_torch.configs import get_config
    from repro_torch.optim import init_opt_state
    assert get_config("grok1_314b").moe.n_experts == 8
    st = init_opt_state({"w": torch.zeros(64, 64), "b": torch.zeros(64)},
                        factored=True)
    assert set(st["nu"]["w"]) == {"row", "col"}
    assert tuple(st["nu"]["w"]["row"].shape) == (64,)
    assert tuple(st["nu"]["w"]["col"].shape) == (64,)
    assert st["nu"]["w"]["row"].dtype == torch.float32
    assert tuple(st["nu"]["b"].shape) == (64,)
