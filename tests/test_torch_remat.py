"""Rematerialization, microbatch accumulation and the unfused loss of the
port's train step, inside the port and against the JAX package.

Inside the port, ``remat`` "none", "dots" and "full" give the same loss,
aux loss and gradients bit for bit: a checkpointed period recomputes the
same ops on the same inputs, and the backward graph is the same. Against
the reference, each SMOKE model runs in float32 on the reference's own
parameters (carried across with ``state_from_numpy``), where the two
packages differ only in the order of float32 sums; the tolerances are
``tests/test_torch_zoo.py``'s: loss, ce, aux and gradient norm to 1e-5
relative, each gradient leaf (read off the first AdamW moment) to 1e-4 of
the leaf's largest element, and the unfused cross-entropy to 1e-5
relative."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import serialize as jser  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamW  # noqa: E402
from repro.train import init_train_state as jax_init_state  # noqa: E402
from repro.train import make_train_step as jax_make_step  # noqa: E402
from repro.train.train_step import cross_entropy as jax_cross_entropy  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import serialize as tser  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.train import (cross_entropy, init_train_state,  # noqa: E402
                               loss_and_grads, make_train_step,
                               state_from_numpy)

STEP_TOL = 1e-5
LEAF_TOL = 1e-4
B, S = 4, 16
OPT = dict(total_steps=10, warmup_steps=2)
REMAT_ARCHS = ["gemma3_1b", "recurrentgemma_2b", "falcon_mamba_7b",
               "deepseek_moe_16b"]


def to_numpy(tree) -> dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in jser.flatten_state(tree).items()}


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x).astype(np.float32)


def smoke_pair(arch):
    jc = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
    tc = dataclasses.replace(tconfigs.get_smoke_config(arch), dtype="float32")
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def make_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    return {"inputs": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this module's tests: the test workers share
    the machine's cores, and more threads a worker only oversubscribe
    them."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


@pytest.fixture
def flash_forwards(monkeypatch):
    """Counts the flash forward's plain-version calls (the CPU's launches)."""
    calls = []
    real = flash_ops.attention_ref

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    monkeypatch.setattr(flash_ops, "attention_ref", counted)
    return calls


# ---------------------------------------------------------------------------
# inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_modes_give_bitwise_equal_loss_and_grads(arch, flash_forwards):
    """Each period recomputed in backward: the same loss, ce, aux and every
    gradient leaf bit for bit as without remat, in the config's own dtype;
    each attention layer's forward runs twice under remat."""
    cfg = tconfigs.get_smoke_config(arch)
    params = init_train_state(cfg, AdamWConfig(), seed=0,
                              device="cpu")["params"]
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, 1).items()}
    n_attn = sum(k in ("global", "local") for k in cfg.layer_kinds())
    out, forwards = {}, {}
    for remat in ("none", "dots", "full"):
        flash_forwards.clear()
        out[remat] = loss_and_grads(cfg, params, batch["inputs"],
                                    batch["labels"], remat=remat)
        forwards[remat] = len(flash_forwards)
    assert forwards == {"none": n_attn, "dots": 2 * n_attn,
                        "full": 2 * n_attn}
    want = out["none"]
    assert torch.isfinite(want[0])
    for remat in ("dots", "full"):
        got = out[remat]
        for i in range(3):                       # loss, ce, aux
            assert torch.equal(got[i], want[i]), (remat, i)
        gw, gg = tser.flatten_state(want[3]), tser.flatten_state(got[3])
        assert list(gg) == list(gw)
        for name, g in gw.items():
            assert torch.equal(gg[name], g), (remat, name)
    if cfg.moe is not None:
        assert float(want[2]) > 0


def test_dots_keeps_the_unbatched_products(monkeypatch):
    """"dots" saves the outputs of aten.mm and aten.addmm and recomputes
    every other op; "full" saves none of them."""
    from torch.utils import checkpoint as ckpt
    from repro_torch.models import transformer
    seen = []
    real = ckpt.create_selective_checkpoint_contexts

    def spy(policy, *a, **kw):
        seen.append(policy)
        return real(policy, *a, **kw)
    monkeypatch.setattr(transformer, "create_selective_checkpoint_contexts",
                        spy)
    cfg = dataclasses.replace(tconfigs.get_smoke_config("gemma3_1b"),
                              dtype="float32")
    params = init_train_state(cfg, AdamWConfig(), seed=0,
                              device="cpu")["params"]
    batch = make_batch(cfg, 2)
    loss_and_grads(cfg, params, torch.from_numpy(batch["inputs"]),
                   torch.from_numpy(batch["labels"]), remat="full")
    assert seen == []
    loss_and_grads(cfg, params, torch.from_numpy(batch["inputs"]),
                   torch.from_numpy(batch["labels"]), remat="dots")
    assert seen and all(set(p) == {torch.ops.aten.mm.default,
                                   torch.ops.aten.addmm.default}
                        for p in seen)


@pytest.mark.parametrize("remat", ["Full", "dots_with_no_batch_dims", ""])
def test_unknown_remat_raises(remat):
    """Only "none", "dots" and "full": the reference treats every other
    string as "dots"; the port refuses it."""
    cfg = tconfigs.get_smoke_config("gemma3_1b")
    with pytest.raises(ValueError, match="remat"):
        make_train_step(cfg, AdamWConfig(), remat=remat)


def test_one_microbatch_is_the_plain_step():
    """microbatches=1 with the defaults runs the step it always ran: the
    same state and metrics, bit for bit, as make_train_step(cfg, opt)."""
    cfg = tconfigs.get_smoke_config("gemma3_1b")
    opt = AdamWConfig(**OPT)
    state = init_train_state(cfg, opt, seed=0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, 3).items()}
    a, ma = make_train_step(cfg, opt)(state, batch)
    b, mb = make_train_step(cfg, opt, remat="none", microbatches=1,
                            aux_weight=None, fused_ce=True)(state, batch)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    fa, fb = tser.flatten_state(a), tser.flatten_state(b)
    for name, t in fa.items():
        assert torch.equal(t, fb[name]), name


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

STEP_CASES = {
    "remat_full_mb2": dict(remat="full", microbatches=2),
    "remat_dots_mb2": dict(remat="dots", microbatches=2),
    "remat_full_mb2_aux_weight": dict(remat="full", microbatches=2,
                                      aux_weight=0.5),
    "unfused_ce": dict(fused_ce=False),
}


@pytest.mark.parametrize("arch,case", [
    ("gemma3_1b", "remat_full_mb2"), ("recurrentgemma_2b", "remat_dots_mb2"),
    ("deepseek_moe_16b", "remat_full_mb2_aux_weight"),
    ("gemma3_1b", "unfused_ce")])
def test_train_step_options_match_reference(arch, case):
    """Loss, ce, aux, gradient norm and every gradient leaf of one AdamW
    step with the reference's options (remat with microbatch accumulation,
    the unfused loss, an aux-weight override) against its make_train_step
    with the same ones."""
    kw = STEP_CASES[case]
    jc, tc = smoke_pair(arch)
    jstate = jax_init_state(jc, JaxAdamW(**OPT), seed=3)
    tstate = state_from_numpy(to_numpy(jstate), device="cpu")
    batch = make_batch(jc, 4)
    jnew, jm = jax.jit(jax_make_step(jc, JaxAdamW(**OPT), **kw))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tnew, tm = make_train_step(tc, AdamWConfig(**OPT), **kw)(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("loss", "ce", "aux", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=STEP_TOL, atol=1e-7, err_msg=key)
    if tc.moe is not None:
        w = kw.get("aux_weight", tc.moe.aux_loss_weight)
        assert float(tm["aux"]) > 0
        np.testing.assert_allclose(float(tm["loss"]),
                                   float(tm["ce"]) + w * float(tm["aux"]),
                                   rtol=1e-6)
    jn, tn = to_numpy(jnew), tser.flatten_state(tnew)
    assert list(tn) == list(jn)
    moments = [k for k in jn if k.startswith("opt/mu/")]
    assert moments
    for k in moments:
        want = f32(jn[k])
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(f32(tn[k]) - want).max()) / scale
        assert err <= LEAF_TOL, (k, err)


@pytest.mark.parametrize("chunk_tokens", [32768, 8, 7, 3])
def test_cross_entropy_matches_reference(chunk_tokens):
    """The unfused loss over (3, 8, 50) logits: one chunk, or chunks of at
    most ``chunk_tokens`` tokens (a divisor of the 24 tokens), against the
    reference's lax.map over the same chunks; and its gradient against
    the reference's."""
    rng = np.random.default_rng(5)
    logits = (3 * rng.standard_normal((3, 8, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (3, 8)).astype(np.int32)
    want, jgrad = jax.value_and_grad(
        lambda lg: jax_cross_entropy(lg, jnp.asarray(labels),
                                     chunk_tokens=chunk_tokens))(
        jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_(True)
    got = cross_entropy(lt, torch.from_numpy(labels),
                        chunk_tokens=chunk_tokens)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=STEP_TOL)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jgrad),
                               rtol=STEP_TOL, atol=1e-8)
    one = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(one), rtol=STEP_TOL)
