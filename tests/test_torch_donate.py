"""The donating decode step (``make_decode_step(donate_caches=True)``,
``decode_step(donate=True)``) against the default, functional one, on the
CPU at smoke sizes: the same tokens and logits bit for bit over several
steps (the local layers' ring of 16 slots wraps), the very cache tensors
returned that were given, written in place; and the functional step still
never writes a state handed to it, the promise a save relies on."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import serialize as ser  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serve import make_decode_step, make_prefill  # noqa: E402

ARCHS = ("gemma3_1b", "phi3_mini_3p8b", "recurrentgemma_2b")
PROMPT, STEPS = 10, 12      # positions 10..21: a ring of 16 wraps at 16


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads: the test workers share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _leaves(tree) -> list:
    return list(ser.flatten_state(tree).values())


def _clone(tree):
    return ser.unflatten_like(tree, {n: t.clone() for n, t in
                                     ser.flatten_state(tree).items()})


def _start(arch):
    cfg = get_smoke_config(arch)
    params = init_params(cfg, seed=0, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, PROMPT)))
    pre = make_prefill(cfg, cache_len=PROMPT + STEPS, device="cpu")
    tok, caches, pos = pre(params, prompt)
    return cfg, params, tok, caches, pos


@pytest.mark.parametrize("arch", ARCHS)
def test_donating_decode_equals_the_functional_step_bitwise(arch):
    cfg, params, tok, caches, pos = _start(arch)
    functional = make_decode_step(cfg, device="cpu")
    donating = make_decode_step(cfg, device="cpu", donate_caches=True)
    c_f, c_d = caches, _clone(caches)
    t_f = t_d = tok
    for i in range(STEPS):
        given = _leaves(c_d)
        t_f, l_f, c_f = functional(params, t_f[:, None], c_f, pos + i)
        t_d, l_d, out = donating(params, t_d[:, None], c_d, pos + i)
        assert torch.equal(l_f, l_d), (arch, i)
        assert torch.equal(t_f, t_d), (arch, i)
        # the very tensors (and storages) it took
        assert out is c_d
        assert all(a is b for a, b in zip(_leaves(out), given))
        c_d = out
    for a, b in zip(_leaves(c_f), _leaves(c_d)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_donating_decode_writes_its_caches_in_place(arch):
    cfg, params, tok, caches, pos = _start(arch)
    ptrs = [t.data_ptr() for t in _leaves(caches)]
    before = _clone(caches)
    step = make_decode_step(cfg, device="cpu", donate_caches=True)
    _, _, out = step(params, tok[:, None], caches, pos)
    assert [t.data_ptr() for t in _leaves(out)] == ptrs
    # the row at pos (or its ring slot) was written into the caches given
    assert any(not torch.equal(a, b)
               for a, b in zip(_leaves(caches), _leaves(before)))


@pytest.mark.parametrize("arch", ARCHS)
def test_functional_decode_never_writes_the_state_it_was_given(arch):
    cfg, params, tok, caches, pos = _start(arch)
    before = _clone(caches)
    step = make_decode_step(cfg, device="cpu")
    _, _, out = step(params, tok[:, None], caches, pos)
    for a, b in zip(_leaves(caches), _leaves(before)):
        assert torch.equal(a, b)
    assert all(a.data_ptr() != b.data_ptr()
               for a, b in zip(_leaves(out), _leaves(caches)))
