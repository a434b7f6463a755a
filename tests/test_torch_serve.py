"""The port's serving path (prefill, decode, greedy generation) for gemma3
(ring + full caches), recurrentgemma (RG-LRU + ring), falcon-mamba (conv
window + float32 SSM state) and phi3-mini (full MHA caches, untied head)
against the JAX package, on the reference's own parameters and caches
(carried across with ``serve.state_from_numpy``), and serving states that
interchange through both packages' checkpoint stores.

Smoke configs in float32: the two packages differ only in the order of
float32 sums, so logits agree to 5e-4 (the reference's own
decode-vs-teacher-forcing tolerance) and greedy tokens are identical."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import CheckpointStore as JaxStore  # noqa: E402
from repro.checkpoint import serialize as jser  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.serve.serve_step import generate as jax_generate  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.checkpoint import serialize as tser  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import decode_step, forward, init_cache, prefill  # noqa: E402
from repro_torch.serve import (generate, make_decode_step,  # noqa: E402
                               make_prefill, state_from_numpy)
from repro_torch.train import state_template_on_device  # noqa: E402

TOL = 5e-4
B, PROMPT, NEW = 2, 12, 8
TOTAL = PROMPT + NEW
ARCHS = ["gemma3_1b", "recurrentgemma_2b", "falcon_mamba_7b", "phi3_mini_3p8b"]
TIED = {"gemma3_1b": True, "recurrentgemma_2b": True, "falcon_mamba_7b": False,
        "phi3_mini_3p8b": False}


def to_numpy(tree) -> dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in jser.flatten_state(tree).items()}


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x).astype(np.float32)


def assert_trees_close(got, want, tol=TOL):
    g, w = tser.flatten_state(got), to_numpy(want)
    assert list(g) == list(w)
    for name, arr in w.items():
        assert tuple(g[name].shape) == arr.shape, name
        np.testing.assert_allclose(f32(g[name]), f32(arr), atol=tol, err_msg=name)


class Ref:
    """The reference's results for one smoke model, computed once."""

    def __init__(self, arch):
        self.arch = arch
        self.jc = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
        self.tc = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        assert dataclasses.asdict(self.jc) == dataclasses.asdict(self.tc)
        self.jparams = jax_init_params(self.jc, jax.random.key(0))
        self.tparams = state_from_numpy(to_numpy(self.jparams), device="cpu")
        rng = np.random.default_rng(1)
        self.tokens = rng.integers(0, self.jc.vocab_size, (B, TOTAL)).astype(np.int32)
        jc = self.jc
        self.jdecode = jax.jit(lambda p, x, c, pos: jax_decode_step(p, jc, x, c, pos))
        self.logits, _, _ = jax.jit(lambda p, x: jax_forward(p, jc, x))(
            self.jparams, self.tokens)
        self.last, self.caches, _ = jax.jit(
            lambda p, x: jax_prefill(p, jc, x, cache_len=TOTAL))(
            self.jparams, self.tokens[:, :PROMPT])
        self.generated = np.asarray(jax_generate(
            self.jparams, jc, jnp.asarray(self.tokens[:, :PROMPT]), NEW,
            cache_len=TOTAL))


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    return Ref(request.param)


def test_smoke_params_carry_across_with_tied_embeddings(ref):
    """Every leaf carries across by name; a tied model (gemma3,
    recurrentgemma) has no lm_head leaf, an untied one (falcon-mamba,
    phi3-mini) has."""
    names = list(tser.flatten_state(ref.tparams))
    assert names == list(to_numpy(ref.jparams))
    assert ("lm_head" in ref.tparams) == (not ref.tc.tie_embeddings)
    assert ref.tc.tie_embeddings == TIED[ref.arch]


def test_forward_logits_match(ref):
    logits, _aux = forward(ref.tparams, ref.tc, torch.from_numpy(ref.tokens))
    assert tuple(logits.shape) == (B, TOTAL, ref.tc.vocab_size)
    np.testing.assert_allclose(f32(logits), f32(ref.logits), atol=TOL)


def test_prefill_last_logits_and_every_cache_leaf_match(ref):
    last, caches, pos = prefill(ref.tparams, ref.tc,
                                torch.from_numpy(ref.tokens[:, :PROMPT]),
                                cache_len=TOTAL)
    assert pos == PROMPT
    np.testing.assert_allclose(f32(last), f32(ref.last), atol=TOL)
    assert_trees_close(caches, ref.caches)


def test_decode_step_from_carried_caches_matches(ref):
    caches = state_from_numpy(to_numpy(ref.caches), device="cpu")
    tok = ref.tokens[:, PROMPT:PROMPT + 1]
    logits, new = decode_step(ref.tparams, ref.tc, torch.from_numpy(tok),
                              caches, PROMPT)
    jlogits, jnew = ref.jdecode(ref.jparams, tok, ref.caches, PROMPT)
    np.testing.assert_allclose(f32(logits), f32(jlogits), atol=TOL)
    assert_trees_close(new, jnew)
    # functional: the caches handed in are unchanged
    assert_trees_close(caches, ref.caches, tol=0.0)


def test_decode_matches_teacher_forcing(ref):
    tc = ref.tc
    x = torch.from_numpy(ref.tokens)
    tf, _ = forward(ref.tparams, tc, x)
    caches = init_cache(tc, B, TOTAL, device="cpu")
    errs = []
    for t in range(TOTAL):
        lg, caches = decode_step(ref.tparams, tc, x[:, t:t + 1], caches, t)
        errs.append(float((lg - tf[:, t]).abs().max()))
    assert max(errs) < TOL, max(errs)
    half = TOTAL // 2
    _last, caches_p, _ = prefill(ref.tparams, tc, x[:, :half], cache_len=TOTAL)
    lg, _ = decode_step(ref.tparams, tc, x[:, half:half + 1], caches_p, half)
    assert float((lg - tf[:, half]).abs().max()) < TOL


def test_generate_tokens_identical(ref):
    out = generate(ref.tparams, ref.tc, ref.tokens[:, :PROMPT], NEW,
                   cache_len=TOTAL, device="cpu")
    assert out.dtype == torch.int32 and tuple(out.shape) == (B, NEW)
    np.testing.assert_array_equal(out.numpy(), ref.generated)


MID = 3     # decode steps taken before the mid-generation save


def _port_session(ref):
    """Prefill, then MID decode steps: the serving state at the save."""
    pre = make_prefill(ref.tc, cache_len=TOTAL, device="cpu")
    step = make_decode_step(ref.tc, device="cpu")
    tok, caches, pos = pre(ref.tparams, ref.tokens[:, :PROMPT])
    out = [tok]
    for i in range(MID):
        tok, _, caches = step(ref.tparams, out[-1][:, None], caches, pos + i)
        out.append(tok)
    return {"caches": caches, "cursor": pos + MID,
            "generated": torch.stack(out, dim=1)}, step


def _port_finish(ref, state, step):
    out = list(state["generated"].unbind(1))
    caches, cursor = state["caches"], state["cursor"]
    for i in range(NEW - 1 - MID):
        tok, _, caches = step(ref.tparams, out[-1][:, None], caches, cursor + i)
        out.append(tok)
    return torch.stack(out, dim=1).numpy()


def _jax_finish(ref, state):
    out = [state["generated"][:, i] for i in range(state["generated"].shape[1])]
    caches, cursor = state["caches"], int(state["cursor"])
    for i in range(NEW - 1 - MID):
        logits, caches = ref.jdecode(ref.jparams, out[-1][:, None], caches,
                                     cursor + i)
        out.append(jnp.argmax(logits, axis=-1).astype(jnp.int32))
    return np.asarray(jnp.stack(out, axis=1))


def test_serving_state_saved_by_the_reference_restores_in_the_port(ref, tmp_path):
    tstate, step = _port_session(ref)
    # the reference session at the same point: prefill, then MID steps
    caches, gen = ref.caches, [jnp.asarray(ref.generated[:, 0])]
    for i in range(MID):
        logits, caches = ref.jdecode(ref.jparams, gen[-1][:, None], caches,
                                     PROMPT + i)
        gen.append(jnp.argmax(logits, axis=-1).astype(jnp.int32))
    jstate = {"caches": caches, "cursor": PROMPT + MID,
              "generated": jnp.stack(gen, axis=1)}
    JaxStore(str(tmp_path)).save(MID, jstate, kind="transparent")
    restored, man = CheckpointStore(str(tmp_path)).restore(
        state_template_on_device(tstate, "cpu"))
    assert man.step == MID and restored["cursor"] == PROMPT + MID
    assert_trees_close(restored["caches"], jstate["caches"], tol=0.0)
    np.testing.assert_array_equal(_port_finish(ref, restored, step),
                                  ref.generated)


def test_serving_state_saved_by_the_port_restores_in_the_reference(ref, tmp_path):
    tstate, step = _port_session(ref)
    CheckpointStore(str(tmp_path)).save(MID, tstate, kind="transparent")
    template = {"caches": ref.caches, "cursor": 0,
                "generated": jnp.zeros((B, MID + 1), jnp.int32)}
    restored, man = JaxStore(str(tmp_path)).restore(template)
    assert man.step == MID and int(restored["cursor"]) == PROMPT + MID
    for name, arr in to_numpy(restored["caches"]).items():
        np.testing.assert_array_equal(
            arr, tser.to_host(tser.flatten_state(tstate["caches"])[name]))
    want = _port_finish(ref, tstate, step)
    np.testing.assert_array_equal(want, ref.generated)
    np.testing.assert_array_equal(_jax_finish(ref, restored), want)
