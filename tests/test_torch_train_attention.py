"""Training through the port's kernels, against the JAX package on the same
inputs made with numpy: the flash-attention backward (its plain two-pass
formulas and the differentiable ``flash_attention``), the SMOKE training
steps of every ported architecture, the chunked cross-entropy's checkpoint,
and a bit-exact evicted resume of gemma3 through ``SpotTrainer``.

Tolerances, all in float32, where only the order of summation differs:
attention gradients to 2e-4 absolute, the reference's own gradient
tolerance (``tests/test_kernels.py``: 10 x 2e-5); a training step's loss
and gradient norm to 1e-5 relative, and each gradient leaf (read off the
first AdamW moment, ``(1 - b1)`` times the clipped gradient) to 3e-5 of the
leaf's largest element: the largest seen is 6e-6, recurrentgemma's, whose
reference runs an associative scan that rounds otherwise than the port's
sequential one."""

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import serialize as jser  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.kernels.flash_attention import attention_ref as jax_attention_ref  # noqa: E402
from repro.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention_bwd as jax_flash_bwd, flash_attention_fwd as jax_flash_fwd)
from repro.optim import AdamWConfig as JaxAdamW  # noqa: E402
from repro.train import init_train_state as jax_init_state  # noqa: E402
from repro.train import make_train_step as jax_make_step  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.checkpoint import serialize as tser  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import (AZURE_D8S_V3, CheckpointPolicy,  # noqa: E402
                              CostAccountant, NoEviction, PeriodicEviction,
                              ScaleSet, SpotOnCoordinator, TimeModel,
                              VirtualClock)
from repro_torch.kernels.flash_attention import (attention_bwd_ref,  # noqa: E402
                                                 attention_ref,
                                                 flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_fwd)
from repro_torch.models import forward  # noqa: E402
from repro_torch.models.transformer import unembed_weights  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.train import (SpotTrainer, TrainJob,  # noqa: E402
                               loss_and_grads, make_train_step,
                               state_from_numpy)
from repro_torch.train.train_step import fused_unembed_xent  # noqa: E402

GRAD_TOL = 2e-4
STEP_TOL = 1e-5
LEAF_TOL = 3e-5


def to_numpy(tree) -> dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in jser.flatten_state(tree).items()}


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x).astype(np.float32)


def normal(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x, torch.from_numpy(x.copy())


# FLASH_CASES[:4] of tests/test_kernels.py, a window case and a head-dim-96
# case (phi3-mini's heads)
BWD_CASES = [
    # B, S, H, KV, hd, window, bq, bk
    (2, 256, 4, 2, 64, 0, 128, 128),
    (1, 256, 4, 1, 64, 64, 64, 64),
    (2, 192, 2, 2, 32, 0, 128, 128),     # padding path
    (1, 128, 8, 4, 128, 0, 128, 128),
    (1, 384, 2, 1, 64, 128, 128, 128),   # window
    (1, 160, 4, 2, 96, 0, 64, 64),       # head dim 96, padding path
]


@pytest.mark.parametrize("B,S,H,KV,hd,window,bq,bk", BWD_CASES)
def test_backward_formulas_match_reference(B, S, H, KV, hd, window, bq, bk):
    """The port's flash_attention_bwd (its CPU path, padding included) and
    attention_bwd_ref against the reference's Pallas backward in interpret
    mode and against jax.vjp of its attention_ref."""
    rng = np.random.default_rng(S * H + hd)
    (jq, q), (jk, k), (jv, v), (jdo, do) = (
        normal(rng, (B, S, n, hd)) for n in (H, KV, KV, H))
    o, lse = flash_attention_fwd(q, k, v, True, window)
    got = flash_attention_bwd(q, k, v, o, lse, do, True, window)
    plain = attention_bwd_ref(q, k, v, o, lse, do, causal=True, window=window)

    Sp = -(-S // bq) * bq
    pad = ((0, 0), (0, Sp - S), (0, 0), (0, 0))
    jq_p, jk_p, jv_p, jdo_p = (jnp.pad(jnp.asarray(a), pad)
                               for a in (jq, jk, jv, jdo))
    jo, jlse = jax_flash_fwd(jq_p, jk_p, jv_p, causal=True, window=window,
                             block_q=bq, block_k=bk, interpret=True)
    pallas = jax_flash_bwd(jq_p, jk_p, jv_p, jo, jlse, jdo_p, causal=True,
                           window=window, block_q=bq, block_k=bk,
                           interpret=True)
    _, vjp = jax.vjp(lambda a, b, c: jax_attention_ref(a, b, c, causal=True,
                                                       window=window),
                     jq, jk, jv)
    autodiff = vjp(jnp.asarray(jdo))
    for name, g, p, jp, ja in zip(("dq", "dk", "dv"), got, plain, pallas,
                                  autodiff):
        assert tuple(g.shape) == ja.shape and g.dtype == torch.float32
        np.testing.assert_allclose(f32(g), f32(jp)[:, :S], atol=GRAD_TOL,
                                   err_msg=name)
        np.testing.assert_allclose(f32(g), f32(ja), atol=GRAD_TOL, err_msg=name)
        np.testing.assert_allclose(f32(p), f32(ja), atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("B,S,H,KV,hd,window", [
    (2, 64, 4, 1, 32, 0),
    (1, 70, 4, 2, 16, 24),        # padding path, window
    (2, 128, 2, 2, 96, 0),
])
def test_flash_attention_function_grads_match_autograd(B, S, H, KV, hd,
                                                        window):
    """The differentiable flash_attention against torch autograd through
    the plain attention_ref, on the same float32 inputs."""
    rng = np.random.default_rng(S + hd)
    q, k, v = (normal(rng, (B, S, n, hd))[1].requires_grad_(True)
               for n in (H, KV, KV))
    out = flash_attention(q, k, v, True, window)
    got = torch.autograd.grad(torch.sin(out).sum(), (q, k, v))
    want = torch.autograd.grad(
        torch.sin(attention_ref(q, k, v, causal=True, window=window)[0]).sum(),
        (q, k, v))
    for g, w in zip(got, want):
        np.testing.assert_allclose(f32(g), f32(w), atol=GRAD_TOL)


def _xent_before_checkpoint(hidden, head, labels, seq_chunks=8):
    """fused_unembed_xent as it was before each chunk was checkpointed."""
    B, S, _ = hidden.shape
    n = min(seq_chunks, S)
    while S % n:
        n -= 1
    head32, labels = head.to(torch.float32), labels.to(torch.int64)
    total = torch.zeros((), dtype=torch.float32)
    c = S // n
    for i in range(n):
        logits = hidden[:, i * c:(i + 1) * c].to(torch.float32) @ head32
        lse = torch.logsumexp(logits, dim=-1)
        onehot = torch.nn.functional.one_hot(labels[:, i * c:(i + 1) * c],
                                             logits.shape[-1])
        gold = torch.sum(logits * onehot.to(logits.dtype), dim=-1)
        total = total + torch.sum(lse - gold)
    return total / (B * S)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpointed_xent_is_bitwise_what_it_was(dtype):
    """phi3-mini SMOKE's hidden state and head: the checkpointed chunks give
    the same loss and the same gradients, bit for bit."""
    cfg = get_smoke_config("phi3_mini_3p8b").scaled(dtype=dtype)
    rng = np.random.default_rng(0)
    hidden = torch.from_numpy(rng.standard_normal((2, 32, cfg.d_model))
                              .astype(np.float32)).to(getattr(torch, dtype))
    head = torch.from_numpy(rng.standard_normal((cfg.d_model, cfg.vocab_size))
                            .astype(np.float32) / 8).to(getattr(torch, dtype))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)))
    results = []
    for fn in (fused_unembed_xent, _xent_before_checkpoint):
        h, w = hidden.clone().requires_grad_(True), head.clone().requires_grad_(True)
        loss = fn(h, w, labels)
        results.append((loss, *torch.autograd.grad(loss, (h, w))))
    for a, b in zip(*results):
        assert a.dtype == b.dtype and torch.equal(a, b)


ARCHS = ["phi3_mini_3p8b", "gemma3_1b", "recurrentgemma_2b", "falcon_mamba_7b"]
B, S = 2, 24            # longer than the smoke models' 16-token window


def _smoke_pair(arch):
    jc = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
    tc = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_train_step_matches_reference(arch):
    """One training step of each ported architecture's SMOKE model against
    the reference's make_train_step (its attention the plain L.attention
    under jax.checkpoint; its scans associative), on the reference's own
    state carried across with state_from_numpy."""
    jc, tc = _smoke_pair(arch)
    opt = dict(total_steps=10, warmup_steps=2)
    jstate = jax_init_state(jc, JaxAdamW(**opt), seed=3)
    tstate = state_from_numpy(to_numpy(jstate), device="cpu")
    rng = np.random.default_rng(1)
    tok = rng.integers(0, jc.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"inputs": tok[:, :-1], "labels": tok[:, 1:]}
    jnew, jm = jax.jit(jax_make_step(jc, JaxAdamW(**opt)))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tnew, tm = make_train_step(tc, AdamWConfig(**opt))(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=STEP_TOL, err_msg=key)
    jn, tn = to_numpy(jnew), tser.flatten_state(tnew)
    assert list(tn) == list(jn)
    moments = [k for k in jn if k.startswith("opt/mu/")]
    assert len(moments) == len(tser.flatten_state(tstate["params"]))
    for k in moments:
        want = f32(jn[k])
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(f32(tn[k]) - want).max()) / scale
        assert err <= LEAF_TOL, (k, err)


def test_loss_and_grads_is_the_train_steps_gradient():
    """loss_and_grads, which the chip check holds across devices, is what
    make_train_step differentiates: gemma3 SMOKE's first moment is
    (1 - b1) times its clipped gradients."""
    _jc, tc = _smoke_pair("gemma3_1b")
    jstate = jax_init_state(_jc, JaxAdamW(), seed=0)
    state = state_from_numpy(to_numpy(jstate), device="cpu")
    rng = np.random.default_rng(2)
    tok = torch.from_numpy(rng.integers(0, tc.vocab_size, (B, S + 1)).astype(np.int32))
    loss, _aux, grads = loss_and_grads(tc, state["params"], tok[:, :-1], tok[:, 1:])
    new, m = make_train_step(tc, AdamWConfig())(
        state, {"inputs": tok[:, :-1], "labels": tok[:, 1:]})
    assert torch.equal(loss, m["loss"])
    gn = math.sqrt(sum(float((g.double() ** 2).sum())
                       for g in tser.flatten_state(grads).values()))
    np.testing.assert_allclose(float(m["grad_norm"]), gn, rtol=1e-6)
    clip = min(1.0, AdamWConfig().clip_norm / gn)
    for name, g in tser.flatten_state(grads).items():
        np.testing.assert_allclose(
            f32(tser.flatten_state(new["opt"]["mu"])[name]),
            f32(g) * (1 - AdamWConfig().b1) * clip, rtol=1e-5, atol=1e-12,
            err_msg=name)
    # the head is tied: the embedding's gradient carries both uses
    assert "lm_head" not in grads
    h, _ = forward(state["params"], tc, tok[:, :-1], return_hidden=True)
    assert unembed_weights(state["params"], tc).shape == (tc.d_model, tc.vocab_size)
    assert h.shape == (B, S, tc.d_model)


def _run_gemma3_loop(tmp_path, tag, evict_s):
    clock = VirtualClock()
    sched = PeriodicEviction(evict_s) if evict_s else NoEviction()
    pool = ScaleSet(clock=clock, schedule=sched,
                    accountant=CostAccountant(AZURE_D8S_V3),
                    provisioning_delay_s=60.0, notice_s=30.0)
    store = CheckpointStore(str(tmp_path / tag), time_fn=clock.now)
    policy = (CheckpointPolicy.transparent(100.0) if evict_s
              else CheckpointPolicy.off())
    coord = SpotOnCoordinator(store, policy, clock, time_model=TimeModel())
    cfg = get_smoke_config("gemma3_1b")
    job = TrainJob(cfg=cfg, opt=AdamWConfig(total_steps=30), total_steps=30,
                   n_stages=3, batch=2, seq_len=S)
    rep = SpotTrainer(job, coord, pool, clock, step_time_s=10.0,
                      max_sessions=20, device="cpu").run()
    coord.close()
    return rep


def test_gemma3_evicted_resume_is_bit_exact(tmp_path):
    """gemma3 SMOKE (bf16, tied head, window and global layers through
    flash attention) resumed after an eviction ends bitwise equal to an
    uninterrupted run."""
    base = _run_gemma3_loop(tmp_path, "base", None)
    ev = _run_gemma3_loop(tmp_path, "ev", 200.0)
    assert base.completed and ev.completed
    assert ev.evictions_seen >= 1 and ev.restores >= 1
    assert ev.lost_steps == 0
    assert math.isfinite(base.final_loss)
    assert ev.final_loss == base.final_loss
