"""The port's Mixture-of-Experts layer (``repro_torch.models.moe``) against
the JAX package's, on the same inputs made with numpy.

Routing is held exactly: the same expert for every (token, k) pair, the
same kept pairs and slots (the reference's one-hot dispatch tensor rebuilt
from the port's slot table), including rows whose probabilities tie (the
lower expert index wins, as ``jax.lax.top_k`` breaks ties) and experts
that overflow their capacity. Values in float32 differ only in the order
of float32 sums: gates, the aux loss and the blocks' outputs agree to 1e-5
(relative and absolute)."""

import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import moe as JM  # noqa: E402
from repro.models.config import MoEConfig as JaxMoEConfig  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models.config import MoEConfig  # noqa: E402

TOL = 1e-5


def cfgs(**kw):
    return JaxMoEConfig(**kw), MoEConfig(**kw)


def port_dispatch(slot, gate, E, C):
    """The reference's (T, E, C) dispatch and combine from the port's slot
    table of one group."""
    T, K = slot.shape
    dispatch = np.zeros((T, E * C + 1), np.float32)
    combine = np.zeros((T, E * C + 1), np.float32)
    for t in range(T):
        for k in range(K):
            dispatch[t, slot[t, k]] += 1.0
            combine[t, slot[t, k]] += gate[t, k]
    return (dispatch[:, :E * C].reshape(T, E, C),
            combine[:, :E * C].reshape(T, E, C))


def logits_case(name, rng, T, E):
    if name == "random":
        return rng.standard_normal((T, E)).astype(np.float32)
    if name == "ties":        # few distinct values: exact ties in each row
        return rng.integers(0, 3, (T, E)).astype(np.float32)
    if name == "uniform":     # every expert tied in every row
        return np.zeros((T, E), np.float32)
    # skewed: most pairs want experts 0 and 1, which overflow
    x = rng.standard_normal((T, E)).astype(np.float32)
    x[:, :2] += 4.0
    return x


@pytest.mark.parametrize("case", ["random", "ties", "uniform", "skewed"])
@pytest.mark.parametrize("E,K,cf", [(8, 2, 1.25), (64, 6, 1.25), (4, 2, 0.5)])
def test_top_k_routing_matches_reference(case, E, K, cf):
    T = 24
    jc, tc = cfgs(n_experts=E, top_k=K, d_expert=8, capacity_factor=cf)
    logits = logits_case(case, np.random.default_rng(E + K), T, E)
    jd, jcomb, jaux = JM.top_k_routing(jnp.asarray(logits), jc)
    slot, gate, aux, C = TM.top_k_routing(torch.from_numpy(logits)[None], tc)
    assert C == JM.router_capacity(T, jc) == TM.router_capacity(T, tc)
    slot, gate = slot[0].numpy(), gate[0].numpy()
    # the same expert for every (token, k), ties to the lower index
    want_idx = np.asarray(jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits)),
                                        K)[1])
    kept = slot < E * C
    np.testing.assert_array_equal(np.where(kept, slot // C, -1),
                                  np.where(kept, want_idx, -1))
    # the same kept pairs at the same slots, the same gates
    d, comb = port_dispatch(slot, gate, E, C)
    np.testing.assert_array_equal(d, np.asarray(jd))
    np.testing.assert_allclose(comb, np.asarray(jcomb), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(aux[0]), float(jaux), rtol=TOL)
    if case == "skewed":
        assert not kept.all(), "the skewed case must overflow an expert"
    if case == "uniform":
        np.testing.assert_array_equal(want_idx, np.tile(np.arange(K), (T, 1)))


def moe_weights(rng, D, E, F, n_shared, gated, router_scale=1.0):
    def w(*shape, fan_in):
        return (rng.standard_normal(shape) / math.sqrt(fan_in)).astype(np.float32)
    out = {"router": w(D, E, fan_in=D) * router_scale,
           "experts": {"up": w(E, D, F, fan_in=D), "down": w(E, F, D, fan_in=F)}}
    if gated:
        out["experts"]["gate"] = w(E, D, F, fan_in=D)
    if n_shared:
        out["shared"] = {"up": w(D, n_shared * F, fan_in=D),
                         "down": w(n_shared * F, D, fan_in=n_shared * F)}
        if gated:
            out["shared"]["gate"] = w(D, n_shared * F, fan_in=D)
    return out


def as_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def as_torch(tree):
    if isinstance(tree, dict):
        return {k: as_torch(v) for k, v in tree.items()}
    return torch.from_numpy(tree)


BLOCKS = [  # (E, K, n_shared, act, gated, capacity_factor, router_scale)
    (8, 2, 1, "silu", True, 1.25, 1.0),     # deepseek-like, drops at 1.25
    (4, 2, 0, "gelu", True, 2.0, 1.0),      # grok-like
    (6, 3, 0, "relu", False, 1.0, 1.0),     # ungated, tight capacity
    (8, 2, 2, "silu", True, 1.25, 0.0),     # a zero router: every row tied
]


@pytest.mark.parametrize("E,K,n_shared,act,gated,cf,rs", BLOCKS)
@pytest.mark.parametrize("n_groups", [None, 2])
def test_moe_block_matches_reference(E, K, n_shared, act, gated, cf, rs,
                                     n_groups):
    B, S, D, F = 2, 12, 16, 24
    rng = np.random.default_rng(E * 10 + K)
    jc, tc = cfgs(n_experts=E, top_k=K, d_expert=F, n_shared=n_shared,
                  capacity_factor=cf)
    w = moe_weights(rng, D, E, F, n_shared, gated, rs)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    jy, jaux = JM.moe_block(jnp.asarray(x), as_jax(w), jc, act=act,
                            gated=gated, n_groups=n_groups)
    ty, taux = TM.moe_block(torch.from_numpy(x), as_torch(w), tc, act=act,
                            gated=gated, n_groups=n_groups)
    assert ty.dtype == torch.float32 and tuple(ty.shape) == (B, S, D)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=TOL)


@pytest.mark.parametrize("E,K,n_shared,act,gated,cf,rs", BLOCKS)
def test_moe_block_dense_matches_reference(E, K, n_shared, act, gated, cf, rs):
    B, S, D, F = 3, 1, 16, 24
    rng = np.random.default_rng(E * 7 + K)
    jc, tc = cfgs(n_experts=E, top_k=K, d_expert=F, n_shared=n_shared,
                  capacity_factor=cf)
    w = moe_weights(rng, D, E, F, n_shared, gated, rs)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    jy = JM.moe_block_dense(jnp.asarray(x), as_jax(w), jc, act=act, gated=gated)
    ty = TM.moe_block_dense(torch.from_numpy(x), as_torch(w), tc, act=act,
                            gated=gated)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)


def test_dense_block_is_the_routed_block_when_nothing_drops():
    """With a capacity of every group's token count no pair drops, and the
    routed block computes what the dropless decode block computes."""
    E, K, D, F = 8, 2, 16, 24
    rng = np.random.default_rng(3)
    _jc, tc = cfgs(n_experts=E, top_k=K, d_expert=F, n_shared=1,
                   capacity_factor=E / K)
    w = as_torch(moe_weights(rng, D, E, F, 1, True))
    x = torch.from_numpy(rng.standard_normal((2, 10, D)).astype(np.float32))
    y, _aux = TM.moe_block(x, w, tc, act="silu", gated=True)
    yd = TM.moe_block_dense(x, w, tc, act="silu", gated=True)
    np.testing.assert_allclose(y.numpy(), yd.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("T", [1, 12, 4096, 4097, 7936, 8192, 12288, 65536])
def test_group_count_matches_reference_on_one_device(T):
    assert TM._n_groups(T) == JM._n_groups(T)


def test_moe_block_gradients_match_reference():
    """x, router and expert gradients of a routed block with drops."""
    E, K, D, F = 8, 2, 16, 24
    rng = np.random.default_rng(5)
    jc, tc = cfgs(n_experts=E, top_k=K, d_expert=F, n_shared=1,
                  capacity_factor=1.0)
    w = moe_weights(rng, D, E, F, 1, True)
    x = rng.standard_normal((2, 12, D)).astype(np.float32)
    dy = rng.standard_normal((2, 12, D)).astype(np.float32)

    def jloss(x, w):
        y, aux = JM.moe_block(x, w, jc, act="silu", gated=True)
        return jnp.sum(y * dy) + 0.5 * aux
    jgx, jgw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), as_jax(w))

    tx = torch.from_numpy(x).requires_grad_(True)
    tw = as_torch(w)
    leaves = [tw["router"], *tw["experts"].values(), *tw["shared"].values()]
    for t in leaves:
        t.requires_grad_(True)
    y, aux = TM.moe_block(tx, tw, tc, act="silu", gated=True)
    (torch.sum(y * torch.from_numpy(dy)) + 0.5 * aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tw["router"].grad.numpy(),
                               np.asarray(jgw["router"]), rtol=1e-4, atol=TOL)
    for group in ("experts", "shared"):
        for k, t in tw[group].items():
            want = np.asarray(jgw[group][k])
            scale = max(float(np.abs(want).max()), 1e-30)
            np.testing.assert_allclose(t.grad.numpy() / scale, want / scale,
                                       atol=TOL, err_msg=f"{group}/{k}")
