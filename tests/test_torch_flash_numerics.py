"""The numerical scheme of the bfloat16 tensor-core flash-attention kernels
(``csrc/flash_attention.cu``'s forward, ``csrc/flash_attention_bwd.cu``'s
dkv pass), emulated in plain float32 on the CPU and held to the port's
unchanged tolerances against its plain versions and the JAX package.

The emulation repeats the kernels' arithmetic, not their code: QK^T (and
dO V^T) of bf16 operands summed in float32 and scaled afterwards; the
forward's online softmax over 64-key tiles; P and dS carried as bf16
hi + lo pairs (``hi = bf16(x)``, ``lo = bf16(x - hi)``) into the float32
products P V, P^T dO and dS^T Q; dK scaled once at the end. bf16 x bf16
products are exact in float32, so only the summation order differs from
the card.

Tolerances, as ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold the
kernels: a bf16 forward output within one bf16 ulp (2**-7 relative) plus
2e-5 of each element, its log-sum-exp within 2e-5; dK and dV (float32)
within 2e-4 * max(1, max|plain|). One more check records why the kernels
split: the split's error is at most 1/16 of the error of P and dS rounded
once to bf16."""

import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import attention_ref as jax_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import (attention_dkv_ref,  # noqa: E402
                                                 attention_ref)

NEG_INF = -2.0 ** 30
ATT_ATOL, BF16_ULP = 2e-5, 2 ** -7
GRAD_TOL = 2e-4
TILE = 64                                     # the kernels' key / q tile
bf16, f32 = torch.bfloat16, torch.float32

CASES = [
    # B, S, H, KV, hd, window
    (1, 192, 4, 1, 64, 0),
    (1, 192, 4, 2, 96, 0),                    # phi3-mini's head dim (GQA)
    (1, 192, 4, 1, 128, 48),
    (1, 192, 4, 1, 256, 0),                   # gemma3's heads
    (1, 256, 4, 2, 256, 100),                 # window, GQA
]
IDS = [f"hd{c[4]}-w{c[5]}-kv{c[3]}" for c in CASES]


def inputs(B, S, H, KV, hd, seed):
    """bf16 q, k, v, dO from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(bf16)
            for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd),
                      (B, S, H, hd))]


def mask(Sq, Skv, window, k0=0, width=None):
    qpos = torch.arange(Sq)[:, None]
    kpos = torch.arange(k0, k0 + (width or Skv))[None, :]
    m = kpos <= qpos
    if window:
        m &= kpos > qpos - window
    return m


def split(x, parts):
    """x as the kernels feed it to a bf16 product: hi + lo (parts 2) or
    rounded once (parts 1), each term widened back to float32."""
    hi = x.to(bf16).to(f32)
    return [hi] if parts == 1 else [hi, (x - hi).to(bf16).to(f32)]


def emulate_fwd(q, k, v, window, parts=2):
    """The tensor-core forward's arithmetic: (o float32, lse)."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qf = q.to(f32).reshape(B, Sq, KV, G, hd)
    kf, vf = k.to(f32), v.to(f32)
    m = torch.full((B, KV, G, Sq), NEG_INF)
    l = torch.zeros((B, KV, G, Sq))
    acc = torch.zeros((B, KV, G, Sq, hd))
    for k0 in range(0, Skv, TILE):
        s = torch.einsum("bqkgh,bskh->bkgqs", qf, kf[:, k0:k0 + TILE]) * scale
        s = torch.where(mask(Sq, Skv, window, k0, TILE), s,
                        torch.tensor(NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None]
        for term in split(p, parts):
            acc = acc + torch.einsum("bkgqs,bskh->bkgqh", term,
                                     vf[:, k0:k0 + TILE])
        m = m_new
    lsum = torch.where(l == 0, torch.ones(()), l)
    o = (acc / lsum[..., None]).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
    return o, (m + torch.log(lsum)).reshape(B, H, Sq)


def emulate_dkv(q, k, v, do, lse, dsum, window, parts=2):
    """The tensor-core dkv pass's arithmetic: (dk, dv) per query head,
    float32 (B, Skv, H, hd)."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qf = q.to(f32).reshape(B, Sq, KV, G, hd)
    dof = do.to(f32).reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bskh,bqkgh->bkgsq", k.to(f32), qf) * scale   # S^T
    lse_t = lse.reshape(B, KV, G, 1, Sq)
    p = torch.where(mask(Sq, Skv, window).T, torch.exp(s - lse_t),
                    torch.zeros(()))
    dp = torch.einsum("bskh,bqkgh->bkgsq", v.to(f32), dof)
    ds = p * (dp - dsum.reshape(B, KV, G, 1, Sq))
    dv = sum(torch.einsum("bkgsq,bqkgh->bskgh", t, dof) for t in split(p, parts))
    dk = sum(torch.einsum("bkgsq,bqkgh->bskgh", t, qf) for t in split(ds, parts))
    return (dk * scale).reshape(B, Skv, H, hd), dv.reshape(B, Skv, H, hd)


def assert_att_close(got, want):
    """bf16 output rule: one ulp of each element plus 2e-5."""
    torch.testing.assert_close(got.to(f32), want.to(f32), atol=ATT_ATOL,
                               rtol=BF16_ULP)


def assert_grad_close(got, want):
    lim = GRAD_TOL * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= lim


def fwd_stats(q, k, v, window):
    """lse and D = rowsum(dO * O) from the plain float32 forward on the bf16
    values widened (what the kernels receive, up to the forward's own
    rounding)."""
    o, lse = attention_ref(q.to(f32), k.to(f32), v.to(f32), window=window)
    return o, lse


@pytest.mark.parametrize("B,S,H,KV,hd,window", CASES, ids=IDS)
def test_emulated_forward_holds_the_bf16_tolerance(B, S, H, KV, hd, window):
    q, k, v, _ = inputs(B, S, H, KV, hd, seed=hd + window)
    o, lse = emulate_fwd(q, k, v, window)
    want, want_lse = attention_ref(q, k, v, window=window)   # port, bf16 out
    assert_att_close(o.to(bf16), want)
    torch.testing.assert_close(lse, want_lse, atol=ATT_ATOL, rtol=ATT_ATOL)
    jax_o = jax.jit(jax_attention_ref, static_argnames=("causal", "window"))(
        *(jnp.asarray(t.to(f32).numpy()).astype(jnp.bfloat16)
          for t in (q, k, v)), causal=True, window=window)
    assert_att_close(o.to(bf16),
                     torch.from_numpy(np.array(jax_o.astype(jnp.float32))))


@pytest.mark.parametrize("B,S,H,KV,hd,window", CASES, ids=IDS)
def test_emulated_dkv_holds_the_gradient_tolerance(B, S, H, KV, hd, window):
    q, k, v, do = inputs(B, S, H, KV, hd, seed=3 * hd + window)
    o, lse = fwd_stats(q, k, v, window)
    dsum = (do.to(f32) * o).sum(-1).transpose(1, 2)
    dk, dv = emulate_dkv(q, k, v, do, lse, dsum, window)
    wk, wv = attention_dkv_ref(q, k, v, do, lse, dsum, window=window)
    assert_grad_close(dk, wk)
    assert_grad_close(dv, wv)
    # the JAX package: jax.vjp of its attention_ref on the same values; the
    # per-query-head passes summed over each KV head's group
    jq, jk, jv, jdo = (jnp.asarray(t.to(f32).numpy()) for t in (q, k, v, do))
    _, vjp = jax.vjp(lambda a, b, c: jax_attention_ref(a, b, c, causal=True,
                                                       window=window),
                     jq, jk, jv)
    _, jdk, jdv = (torch.from_numpy(np.array(g)) for g in vjp(jdo))
    G = H // KV
    assert_grad_close(dk.reshape(B, S, KV, G, hd).sum(3), jdk)
    assert_grad_close(dv.reshape(B, S, KV, G, hd).sum(3), jdv)


@pytest.mark.parametrize("B,S,H,KV,hd,window", CASES, ids=IDS)
def test_split_error_is_a_sixteenth_of_one_bf16_rounding(B, S, H, KV, hd,
                                                         window):
    """Against the plain float32 versions on the same values: P (and dS)
    split into hi + lo err at most 1/16 as much as P (and dS) rounded once
    to bf16, in the forward's output and in dK and dV."""
    q, k, v, do = inputs(B, S, H, KV, hd, seed=5 * hd + window)
    want, _ = fwd_stats(q, k, v, window)
    errs = [float((emulate_fwd(q, k, v, window, parts)[0] - want).abs().max())
            for parts in (2, 1)]
    assert errs[0] * 16 <= errs[1], errs
    dsum = (do.to(f32) * want).sum(-1).transpose(1, 2)
    _, lse = fwd_stats(q, k, v, window)
    plain = attention_dkv_ref(q, k, v, do, lse, dsum, window=window)
    for i in range(2):                                  # dk, dv
        errs = [float((emulate_dkv(q, k, v, do, lse, dsum, window, parts)[i]
                       - plain[i]).abs().max()) for parts in (2, 1)]
        assert errs[0] * 16 <= errs[1], (("dk", "dv")[i], errs)


def test_single_rounding_misses_the_tolerances():
    """What the split repairs, at gemma3's head dim: P rounded once to bf16
    puts forward outputs outside one bf16 ulp and dK, dV outside the
    gradient tolerance."""
    q, k, v, do = inputs(1, 256, 4, 1, 256, seed=11)
    o, _ = emulate_fwd(q, k, v, 0, parts=1)
    want, _ = attention_ref(q, k, v)
    miss = ~torch.isclose(o.to(bf16).to(f32), want.to(f32), atol=ATT_ATOL,
                          rtol=BF16_ULP)
    assert float(miss.to(f32).mean()) > 0.01
    ow, lse = fwd_stats(q, k, v, 0)
    dsum = (do.to(f32) * ow).sum(-1).transpose(1, 2)
    plain = attention_dkv_ref(q, k, v, do, lse, dsum)
    for got, w in zip(emulate_dkv(q, k, v, do, lse, dsum, 0, parts=1), plain):
        lim = GRAD_TOL * max(1.0, float(w.abs().max()))
        assert float((got - w).abs().max()) > lim
