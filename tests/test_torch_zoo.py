"""The rest of the model zoo in the port, against the JAX package: the six
architectures beside the four of the first slices (musicgen-medium and
llava-next-34b without token embeddings, command-r-plus and minitron-8b,
the MoE models deepseek-moe-16b and grok-1-314b), the factored second
moment of AdamW, and the shape specs of ``models/model.py``.

Each SMOKE model runs in float32 on the reference's own parameters
(carried across with ``state_from_numpy``), where the two packages differ
only in the order of float32 sums. Tolerances: logits to 5e-4 absolute (the
reference's own decode-vs-teacher-forcing tolerance,
``tests/test_models.py``), the same for decode against teacher forcing
and for caches; losses, cross-entropy, aux loss and gradient norm to 1e-5
relative; each gradient leaf (read off the first AdamW moment, ``(1 - b1)``
times the clipped gradient) to 1e-4 of the leaf's largest element; the
factored AdamW state to 1e-5 relative and absolute. The MoE SMOKE configs
route with a capacity of every group's token count (deepseek's factor 4.0
over 8 experts top-2, grok's 2.0 over 4 top-2), so no pair drops and the
routed sequence path and the dropless decode path compute the same
function, as the reference's own test arranges."""

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import CheckpointStore as JaxStore  # noqa: E402
from repro.checkpoint import serialize as jser  # noqa: E402
from repro.configs import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamW  # noqa: E402
from repro.optim import adamw_update as jax_adamw  # noqa: E402
from repro.optim import init_opt_state as jax_init_opt  # noqa: E402
from repro.train import init_train_state as jax_init_state  # noqa: E402
from repro.train import make_train_step as jax_make_step  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.checkpoint import serialize as tser  # noqa: E402
from repro_torch.core import (AZURE_D8S_V3, CheckpointPolicy,  # noqa: E402
                              CostAccountant, NoEviction, ScaleSet,
                              SpotOnCoordinator, TimeModel, VirtualClock)
from repro_torch.models import (decode_step, forward, init_cache,  # noqa: E402
                                init_params, prefill)
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state  # noqa: E402
from repro_torch.serve import make_decode_step, make_prefill  # noqa: E402
from repro_torch.train import (SpotTrainer, TrainJob,  # noqa: E402
                               init_train_state, make_train_step,
                               state_from_numpy, state_template_on_device)

LOGIT_TOL = 5e-4
STEP_TOL = 1e-5
LEAF_TOL = 1e-4
OPT_TOL = 1e-5
B, PROMPT, NEW = 2, 10, 6
TOTAL = PROMPT + NEW
NEW_ARCHS = ["musicgen_medium", "command_r_plus_104b", "minitron_8b",
             "deepseek_moe_16b", "grok1_314b", "llava_next_34b"]
OPT = dict(total_steps=10, warmup_steps=2)


def to_numpy(tree) -> dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in jser.flatten_state(tree).items()}


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x).astype(np.float32)


def assert_trees_close(got, want, tol=LOGIT_TOL):
    g, w = tser.flatten_state(got), to_numpy(want)
    assert list(g) == list(w)
    for name, arr in w.items():
        assert tuple(g[name].shape) == arr.shape, name
        np.testing.assert_allclose(f32(g[name]), f32(arr), atol=tol,
                                   err_msg=name)


def smoke_pair(arch):
    jc = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
    tc = dataclasses.replace(tconfigs.get_smoke_config(arch), dtype="float32")
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def make_inputs(cfg, rng, shape):
    """Token ids, or frontend embeddings for archs without token
    embeddings."""
    if cfg.embed_inputs:
        return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    return rng.standard_normal((*shape, cfg.d_model)).astype(np.float32)


class Ref:
    """The reference's results for one SMOKE model, computed once."""

    def __init__(self, arch):
        self.jc, self.tc = smoke_pair(arch)
        jc = self.jc
        self.jparams = jax_init_params(jc, jax.random.key(0))
        self.tparams = state_from_numpy(to_numpy(self.jparams), device="cpu")
        self.inputs = make_inputs(jc, np.random.default_rng(1), (B, TOTAL))
        self.logits, self.aux, _ = jax.jit(lambda p, x: jax_forward(p, jc, x))(
            self.jparams, self.inputs)
        self.last, self.caches, _ = jax.jit(
            lambda p, x: jax_prefill(p, jc, x, cache_len=TOTAL))(
            self.jparams, self.inputs[:, :PROMPT])
        self.jdecode = jax.jit(
            lambda p, x, c, pos: jax_decode_step(p, jc, x, c, pos))


@pytest.fixture(scope="module", params=NEW_ARCHS)
def ref(request):
    return Ref(request.param)


def test_registry_holds_every_reference_arch():
    assert tconfigs.ARCH_IDS == JAX_ARCH_IDS
    for arch in JAX_ARCH_IDS:
        jc, tc = jax_get_config(arch), tconfigs.get_config(arch)
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc), arch
    for alias in ("grok-1-314b", "command-r-plus-104b", "phi3-mini-3.8b"):
        assert tconfigs.get_config(alias).name == jax_get_config(alias).name
    for shape in ("train_4k", "long_500k"):
        for arch, cfg in tconfigs.all_configs().items():
            from repro.configs import cell_is_runnable as jax_runnable
            assert tconfigs.cell_is_runnable(cfg, shape) == \
                jax_runnable(jax_get_config(arch), shape)


def test_params_carry_across_by_name(ref):
    """Every leaf of the reference's parameters has the port's name and
    shape: the MoE leaves (router, stacked experts, shared MLP, the dense
    prelude's MLP), and no embed leaf without token embeddings."""
    mine = init_params(ref.tc, seed=0, device="cpu")
    want = to_numpy(ref.jparams)
    got = tser.flatten_state(mine)
    assert list(got) == list(want)
    for name, arr in want.items():
        assert tuple(got[name].shape) == arr.shape, name
        assert tser.dtype_to_name(got[name].dtype) == arr.dtype.name, name
    assert ("embed" in mine) == ref.tc.embed_inputs
    assert "lm_head" in mine or ref.tc.tie_embeddings


def test_forward_logits_and_aux_match(ref):
    logits, aux = forward(ref.tparams, ref.tc, torch.from_numpy(ref.inputs))
    assert tuple(logits.shape) == (B, TOTAL, ref.tc.vocab_size)
    np.testing.assert_allclose(f32(logits), f32(ref.logits), atol=LOGIT_TOL)
    np.testing.assert_allclose(float(aux), float(ref.aux), rtol=STEP_TOL,
                               atol=1e-7)
    assert (float(aux) > 0) == (ref.tc.moe is not None)


def test_one_train_step_matches(ref):
    """Loss (ce + aux_w * aux), ce, aux, gradient norm and every gradient
    leaf of one AdamW step against the reference's make_train_step."""
    jc, tc = ref.jc, ref.tc
    jstate = jax_init_state(jc, JaxAdamW(**OPT), seed=3)
    tstate = state_from_numpy(to_numpy(jstate), device="cpu")
    rng = np.random.default_rng(2)
    batch = {"inputs": make_inputs(jc, rng, (B, TOTAL)),
             "labels": rng.integers(0, jc.vocab_size, (B, TOTAL)).astype(np.int32)}
    jnew, jm = jax.jit(jax_make_step(jc, JaxAdamW(**OPT)))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tnew, tm = make_train_step(tc, AdamWConfig(**OPT))(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("loss", "ce", "aux", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=STEP_TOL, atol=1e-7, err_msg=key)
    if tc.moe is not None:
        assert float(tm["aux"]) > 0
        np.testing.assert_allclose(
            float(tm["loss"]),
            float(tm["ce"]) + tc.moe.aux_loss_weight * float(tm["aux"]),
            rtol=1e-6)
    jn, tn = to_numpy(jnew), tser.flatten_state(tnew)
    assert list(tn) == list(jn)
    moments = [k for k in jn if k.startswith("opt/mu/")]
    assert len(moments) == len(tser.flatten_state(tstate["params"]))
    for k in moments:
        want = f32(jn[k])
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(f32(tn[k]) - want).max()) / scale
        assert err <= LEAF_TOL, (k, err)


def test_prefill_then_decode_matches_reference(ref):
    """The port's prefill against the reference's (last logits, every cache
    leaf), then each decode step from the port's own caches against the
    reference's from its own, fed the same next inputs."""
    pre = make_prefill(ref.tc, cache_len=TOTAL, device="cpu")
    step = make_decode_step(ref.tc, device="cpu")
    _tok, caches, pos = pre(ref.tparams, ref.inputs[:, :PROMPT])
    assert pos == PROMPT
    last, _, _ = prefill(ref.tparams, ref.tc,
                         torch.from_numpy(ref.inputs[:, :PROMPT]),
                         cache_len=TOTAL)
    np.testing.assert_allclose(f32(last), f32(ref.last), atol=LOGIT_TOL)
    assert_trees_close(caches, ref.caches)
    jcaches = ref.caches
    for t in range(PROMPT, TOTAL):
        x = ref.inputs[:, t:t + 1]
        _tok, logits, caches = step(ref.tparams, x, caches, t)
        jlogits, jcaches = ref.jdecode(ref.jparams, x, jcaches, t)
        np.testing.assert_allclose(f32(logits), f32(jlogits), atol=LOGIT_TOL,
                                   err_msg=f"step {t}")
    assert_trees_close(caches, jcaches)


def test_decode_matches_teacher_forcing(ref):
    tc = ref.tc
    x = torch.from_numpy(ref.inputs)
    tf, _ = forward(ref.tparams, tc, x)
    caches = init_cache(tc, B, TOTAL, device="cpu")
    errs = []
    for t in range(TOTAL):
        lg, caches = decode_step(ref.tparams, tc, x[:, t:t + 1], caches, t)
        errs.append(float((lg - tf[:, t]).abs().max()))
    assert max(errs) < LOGIT_TOL, max(errs)


@pytest.mark.parametrize("arch", ["musicgen_medium", "deepseek_moe_16b"])
def test_spot_trainer_runs_the_arch(arch, tmp_path):
    """SpotTrainer's loop on the CPU: frontend embeddings from the pipeline
    for musicgen, the MoE aux-weighted loss for deepseek, through periodic
    saves with the factored second moment."""
    _jc, tc = smoke_pair(arch)
    clock = VirtualClock()
    pool = ScaleSet(clock=clock, schedule=NoEviction(),
                    accountant=CostAccountant(AZURE_D8S_V3),
                    provisioning_delay_s=10.0, notice_s=30.0)
    store = CheckpointStore(str(tmp_path), time_fn=clock.now)
    coord = SpotOnCoordinator(store, CheckpointPolicy.transparent(20.0), clock,
                              time_model=TimeModel())
    job = TrainJob(cfg=tc, opt=AdamWConfig(factored_second_moment=True, **OPT),
                   total_steps=4, n_stages=2, batch=2, seq_len=8)
    trainer = SpotTrainer(job, coord, pool, clock, step_time_s=10.0,
                          device="cpu")
    batch = trainer.pipeline.batch_at(0)
    assert batch["inputs"].ndim == (2 if tc.embed_inputs else 3)
    rep = trainer.run()
    coord.close()
    assert rep.completed and rep.lost_steps == 0
    assert math.isfinite(rep.final_loss)
    assert rep.coordinator["periodic_ckpts"] >= 1
    last = rep.extra["final_metrics"]          # the last step's, apart
    assert last["loss"] == rep.final_loss
    assert (last["aux"] > 0) == (tc.moe is not None)
    assert last["loss"] == pytest.approx(
        last["ce"] + (tc.moe.aux_loss_weight if tc.moe else 0.0) * last["aux"],
        rel=1e-6)


# ---------------------------------------------------------------------------
# the factored second moment (reference optim/adamw.py:86-93)
# ---------------------------------------------------------------------------

def test_factored_opt_state_has_the_reference_leaves():
    jc, tc = smoke_pair("deepseek_moe_16b")
    jparams = jax_init_params(jc, jax.random.key(0))
    want = to_numpy(jax_init_opt(jparams, factored=True))
    got = tser.flatten_state(init_opt_state(
        state_from_numpy(to_numpy(jparams), device="cpu"), factored=True))
    assert list(got) == list(want)
    for name, arr in want.items():
        assert tuple(got[name].shape) == arr.shape, name
        assert tser.dtype_to_name(got[name].dtype) == arr.dtype.name, name
    assert "nu/segments/1/pos0/moe/experts/up/row" in got
    assert "nu/segments/1/pos0/attn/wq/col" in got
    assert "nu/final_norm" in got     # a vector stays dense


@pytest.mark.parametrize("cfg_kw", [{}, {"clip_norm": 0.05}])
def test_three_factored_updates_match(cfg_kw):
    rng = np.random.default_rng(11)
    shapes = {"a": (3, 64, 80), "b": (64,), "c": (128, 16), "d": (2, 4, 64, 96),
              "e": (96, 64)}
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(factored_second_moment=True, warmup_steps=1, total_steps=5,
              **cfg_kw)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    jo, to = jax_init_opt(jp, factored=True), init_opt_state(tp, factored=True)
    for it in range(3):
        g = {k: (rng.standard_normal(s) * 0.3).astype(np.float32)
             for k, s in shapes.items()}
        jp, jo, jm = jax_adamw({k: jnp.asarray(v) for k, v in g.items()}, jo,
                               jp, JaxAdamW(**kw))
        tp, to, tm = adamw_update({k: torch.from_numpy(v) for k, v in g.items()},
                                  to, tp, AdamWConfig(**kw))
        want = to_numpy({"params": jp, "opt": jo})
        got = tser.flatten_state({"params": tp, "opt": to})
        assert list(got) == list(want)
        for name, arr in want.items():
            np.testing.assert_allclose(f32(got[name]), f32(arr), rtol=OPT_TOL,
                                       atol=OPT_TOL, err_msg=f"{it} {name}")
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=OPT_TOL)
    assert set(to["nu"]["a"]) == {"row", "col"}
    assert isinstance(to["nu"]["b"], torch.Tensor)
    assert isinstance(to["nu"]["c"], torch.Tensor)    # 16 < 64: dense


def _factored_moe_states():
    """A factored deepseek SMOKE train state one step in, in each
    package: the reference's, and the port's from the same start."""
    jc, tc = smoke_pair("deepseek_moe_16b")
    opt = dict(factored_second_moment=True, **OPT)
    jstate = jax_init_state(jc, JaxAdamW(**opt), seed=5)
    tstate = state_from_numpy(to_numpy(jstate), device="cpu")
    rng = np.random.default_rng(4)
    tok = rng.integers(0, jc.vocab_size, (B, TOTAL + 1)).astype(np.int32)
    batch = {"inputs": tok[:, :-1], "labels": tok[:, 1:]}
    jstate, _ = jax.jit(jax_make_step(jc, JaxAdamW(**opt)))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tstate, _ = make_train_step(tc, AdamWConfig(**opt))(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    return jstate, tstate


def test_factored_state_saved_by_the_port_restores_in_the_reference(tmp_path):
    jstate, tstate = _factored_moe_states()
    CheckpointStore(str(tmp_path)).save(1, tstate, kind="transparent")
    restored, man = JaxStore(str(tmp_path)).restore(jstate)
    assert man.step == 1
    got, want = to_numpy(restored), tser.flatten_state(tstate)
    assert list(got) == list(want)
    assert any(n.endswith("/row") for n in got)
    for name, arr in got.items():
        np.testing.assert_array_equal(
            arr.reshape(-1).view(np.uint8),
            tser.to_host(want[name]).reshape(-1).view(np.uint8), err_msg=name)


def test_factored_state_saved_by_the_reference_restores_in_the_port(tmp_path):
    jstate, tstate = _factored_moe_states()
    JaxStore(str(tmp_path)).save(1, jstate, kind="transparent")
    restored, man = CheckpointStore(str(tmp_path)).restore(
        state_template_on_device(tstate, "cpu"))
    assert man.step == 1
    got, want = tser.flatten_state(restored), to_numpy(jstate)
    assert list(got) == list(want)
    for name, arr in want.items():
        np.testing.assert_array_equal(
            tser.to_host(got[name]).reshape(-1).view(np.uint8),
            np.ascontiguousarray(arr).reshape(-1).view(np.uint8), err_msg=name)
    # the restored state trains on
    tc = smoke_pair("deepseek_moe_16b")[1]
    tok = torch.from_numpy(np.random.default_rng(6).integers(
        0, tc.vocab_size, (B, TOTAL + 1)).astype(np.int32))
    _new, m = make_train_step(
        tc, AdamWConfig(factored_second_moment=True, **OPT))(
        restored, {"inputs": tok[:, :-1], "labels": tok[:, 1:]})
    assert math.isfinite(float(m["loss"]))


# ---------------------------------------------------------------------------
# shape specs (models/model.py) of the full published configs
# ---------------------------------------------------------------------------

def assert_specs_equal(got, want):
    g = tser.flatten_state(got)
    w = jser.flatten_state(want)
    assert list(g) == list(w)
    for name, spec in w.items():
        assert g[name].device.type == "meta", name
        assert tuple(g[name].shape) == tuple(spec.shape), name
        assert tser.dtype_to_name(g[name].dtype) == jnp.dtype(spec.dtype).name, name


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_param_and_cache_specs_match_reference(arch):
    jc, tc = jax_get_config(arch), tconfigs.get_config(arch)
    assert_specs_equal(tmodel.param_specs(tc), jax_model.param_specs(jc))
    assert_specs_equal(tmodel.cache_specs(tc, 2, 4096),
                       jax_model.cache_specs(jc, 2, 4096))


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_input_specs_match_reference(arch):
    jc, tc = jax_get_config(arch), tconfigs.get_config(arch)
    for kind in ("train", "prefill", "decode"):
        assert_specs_equal(
            tmodel.input_specs(tc, kind=kind, seq_len=4096, batch=8),
            jax_model.input_specs(jc, kind=kind, seq_len=4096, batch=8))
    with pytest.raises(ValueError):
        tmodel.input_specs(tc, kind="sample", seq_len=1, batch=1)
