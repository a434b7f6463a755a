"""The numerical scheme of the bfloat16 tensor-core flash-attention kernels
(``csrc/flash_attention.cu``'s forward, ``csrc/flash_attention_bwd.cu``'s
dkv and dq passes), emulated in plain float32 on the CPU and held to the
port's unchanged tolerances against its plain versions and the JAX package.

The emulation repeats the kernels' arithmetic, not their code: QK^T (and
dO V^T) of bf16 operands summed in float32 and scaled afterwards; the
forward's online softmax over 64-key tiles in base 2 (``exp2`` of
``s * (scale * log2 e) - m``, one fused multiply-add; the log-sum-exp
returned as a natural log); P and dS carried as bf16 hi + lo pairs
(``hi = bf16(x)``, ``lo = bf16(x - hi)``) into the float32 products P V,
P^T dO, dS^T Q and dS K; dK and dQ scaled once at the end, dQ then rounded
to bf16. bf16 x bf16 products are exact in float32, so only the summation
order differs from the card.

Tolerances, as ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold the
kernels: a bf16 forward output within one bf16 ulp (2**-7 relative) plus
2e-5 of each element, its log-sum-exp within 2e-5; dK and dV (float32)
within 2e-4 * max(1, max|plain|); dQ (bf16) within that plus two bf16 ulps
of each element. More checks record why the kernels split: the split's
error is at most 1/16 of the error of P and dS rounded once to bf16, and
dS rounded once misses dQ's tolerance.

The float32 kernels (3xTF32 on mma.sync: the forward, dkv and dq) are
emulated the same way: every operand of their products rounded to TF32 as
``cvt.rna`` does (nearest, ties away from zero, 10 explicit mantissa bits,
on the float32 bits), split into hi = tf32(x) and lo = tf32(x - hi), every
product taken as hi lo + lo hi + hi hi (each term exact in float32) with
float32 sums; q scaled before its split, dQ scaled once at the end. The
forward keeps two partial softmaxes, one over each half of every key tile
(as the two warps that share a row block keep them), in base 2, and merges
them at the end.
Held to the unchanged float32 tolerances (2e-5 for the forward's output
and log-sum-exp, the gradient tolerance for dK, dV, dQ), against float64
beside plain float32, and against one TF32 rounding."""

import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import attention_ref as jax_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import (attention_dkv_ref,  # noqa: E402
                                                 attention_dq_ref,
                                                 attention_ref)

NEG_INF = -2.0 ** 30
LOG2E = 1.4426950408889634
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
    """The tensor-core forward's arithmetic: (o float32, lse). Scores stay
    unscaled; the running max m is kept in base-2 units (the tile's max
    unscaled score times c = scale * log2 e, both float32), and
    P = exp2(fma(s, c, -m)), the fma emulated in float64 and rounded once."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    c = torch.tensor(1.0 / math.sqrt(hd), dtype=f32) * torch.tensor(LOG2E,
                                                                    dtype=f32)
    qf = q.to(f32).reshape(B, Sq, KV, G, hd)
    kf, vf = k.to(f32), v.to(f32)
    m = torch.full((B, KV, G, Sq), NEG_INF)
    l = torch.zeros((B, KV, G, Sq))
    acc = torch.zeros((B, KV, G, Sq, hd))
    for k0 in range(0, Skv, TILE):
        s = torch.einsum("bqkgh,bskh->bkgqs", qf, kf[:, k0:k0 + TILE])
        s = torch.where(mask(Sq, Skv, window, k0, TILE), s,
                        torch.tensor(NEG_INF))
        m_new = torch.maximum(m, s.amax(-1) * c)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2((s.double() * c.double()
                        - m_new[..., None].double()).to(f32))
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None]
        for term in split(p, parts):
            acc = acc + torch.einsum("bkgqs,bskh->bkgqh", term,
                                     vf[:, k0:k0 + TILE])
        m = m_new
    lsum = torch.where(l == 0, torch.ones(()), l)
    o = (acc / lsum[..., None]).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
    return o, (m * math.log(2.0) + torch.log(lsum)).reshape(B, H, Sq)


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


def emulate_dq(q, k, v, do, lse, dsum, window, parts=2, rounded=True):
    """The tensor-core dq pass's arithmetic: dq (B, Sq, H, hd) in bf16 (or,
    with ``rounded`` False, in float32 before the last rounding)."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qf = q.to(f32).reshape(B, Sq, KV, G, hd)
    dof = do.to(f32).reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, k.to(f32)) * scale
    p = torch.where(mask(Sq, Skv, window),
                    torch.exp(s - lse.reshape(B, KV, G, Sq, 1)), torch.zeros(()))
    dp = torch.einsum("bqkgh,bskh->bkgqs", dof, v.to(f32))
    ds = p * (dp - dsum.reshape(B, KV, G, Sq, 1))
    dq = sum(torch.einsum("bkgqs,bskh->bqkgh", t, k.to(f32))
             for t in split(ds, parts))
    dq = (dq * scale).reshape(B, Sq, H, hd)
    return dq.to(bf16) if rounded else dq


def bf16_grad_limit(want):
    """The bf16 gradient rule, per element: 2e-4 * max(1, max|want|) plus
    two bf16 ulps of the element."""
    w = want.to(torch.float64)
    return GRAD_TOL * max(1.0, float(w.abs().max())) + 2 * BF16_ULP * w.abs()


def assert_bf16_grad_close(got, want):
    err = (got.to(torch.float64) - want.to(torch.float64)).abs()
    lim = bf16_grad_limit(want)
    assert bool((err <= lim).all()), float((err / lim).max())


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
def test_emulated_dq_holds_the_bf16_gradient_tolerance(B, S, H, KV, hd,
                                                       window):
    q, k, v, do = inputs(B, S, H, KV, hd, seed=7 * hd + window)
    o, lse = fwd_stats(q, k, v, window)
    dsum = (do.to(f32) * o).sum(-1).transpose(1, 2)
    dq = emulate_dq(q, k, v, do, lse, dsum, window)
    assert dq.dtype == bf16 and dq.shape == q.shape
    assert_bf16_grad_close(dq, attention_dq_ref(q, k, v, do, lse, dsum,
                                                window=window))
    # the JAX package: jax.vjp of its attention_ref on the same values
    jq, jk, jv, jdo = (jnp.asarray(t.to(f32).numpy()) for t in (q, k, v, do))
    _, vjp = jax.vjp(lambda a, b, c: jax_attention_ref(a, b, c, causal=True,
                                                       window=window),
                     jq, jk, jv)
    assert_bf16_grad_close(dq, torch.from_numpy(np.array(vjp(jdo)[0])))


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
    # dq before its final bf16 rounding, against the plain float32 dq
    want = attention_dq_ref(q.to(f32), k.to(f32), v.to(f32), do.to(f32),
                            lse, dsum, window=window)
    errs = [float((emulate_dq(q, k, v, do, lse, dsum, window, parts,
                              rounded=False) - want).abs().max())
            for parts in (2, 1)]
    assert errs[0] * 16 <= errs[1], ("dq", errs)


@pytest.mark.parametrize("B,S,H,KV,hd,window", CASES, ids=IDS)
def test_single_rounding_of_ds_misses_the_dq_tolerance(B, S, H, KV, hd,
                                                       window):
    """Why the dq kernel keeps the hi + lo split: one rounding of dS would
    save a quarter of its tensor work, but it has to hold dq's bf16
    tolerance with a 4x margin, and it misses the tolerance itself (by 3.4
    to 5.9x on these cases) while the split stays under half of it."""
    q, k, v, do = inputs(B, S, H, KV, hd, seed=7 * hd + window)
    o, lse = fwd_stats(q, k, v, window)
    dsum = (do.to(f32) * o).sum(-1).transpose(1, 2)
    want = attention_dq_ref(q, k, v, do, lse, dsum, window=window)
    lim = bf16_grad_limit(want)
    use = [float(((emulate_dq(q, k, v, do, lse, dsum, window, parts)
                   .to(torch.float64) - want.to(torch.float64)).abs()
                  / lim).max()) for parts in (2, 1)]
    assert use[0] <= 0.5 and use[1] > 1.0, use


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


# ---------------------------------------------------------------------------
# float32 dkv and dq: 3xTF32
# ---------------------------------------------------------------------------

CASES32 = [
    # B, S, H, KV, hd, window
    (1, 256, 4, 1, 256, 0),                   # gemma3's heads (GQA 4:1)
    (1, 256, 4, 1, 256, 100),                 # and a window
    (1, 192, 4, 4, 96, 0),                    # phi3-mini's head dim
    (1, 192, 4, 4, 96, 48),
]
IDS32 = [f"hd{c[4]}-w{c[5]}-kv{c[3]}" for c in CASES32]
# measured on CASES32: 3xTF32 errs 0.85-1.67x as much as plain float32
# against float64 (dk, dv, dq), and uses at most 0.73% of the gradient
# tolerance against plain float32; one TF32 rounding lands at 1.46-4.70x
# the tolerance (2.25x, 3.53x, 1.46x for dk, dv, dq at gemma3's hd 256)
TF32X3_ERR_RATIO = 2.0


def tf32(x):
    """cvt.rna.tf32.f32: round float32 to 10 explicit mantissa bits, to
    nearest with ties away from zero, on the bits (the low 13 cleared)."""
    b = x.to(f32).contiguous().numpy().view(np.uint32)
    r = (b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return torch.from_numpy(r.view(np.float32).copy())


def product(eq, a, b, scheme):
    """One product as a kernel takes it: "f64", plain "f32", "tf32x3"
    (hi lo + lo hi + hi hi, float32 sums) or "tf32" (hi hi)."""
    if scheme == "f64":
        return torch.einsum(eq, a.double(), b.double())
    if scheme == "f32":
        return torch.einsum(eq, a, b)
    ah, bh = tf32(a), tf32(b)
    if scheme == "tf32":
        return torch.einsum(eq, ah, bh)
    al, bl = tf32(a - ah), tf32(b - bh)
    return (torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh)
            + torch.einsum(eq, ah, bh))


def emulate_bwd32(q, k, v, do, lse, dsum, window, scheme="tf32x3"):
    """The float32 dkv and dq kernels' arithmetic under ``scheme``: (dk, dv
    per query head (B, Skv, H, hd), dq (B, Sq, H, hd)), float32 (float64 for
    "f64", on the same float32 inputs)."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    dt = torch.float64 if scheme == "f64" else f32
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=dt)
    qs = (q.to(dt) * scale).reshape(B, Sq, KV, G, hd)      # q widened, scaled
    dog = do.to(dt).reshape(B, Sq, KV, G, hd)
    kf, vf = k.to(dt), v.to(dt)
    s = product("bqkgh,bskh->bkgqs", qs, kf, scheme).to(dt)
    p = torch.where(mask(Sq, Skv, window),
                    torch.exp(s - lse.to(dt).reshape(B, KV, G, Sq, 1)),
                    torch.zeros((), dtype=dt))
    dp = product("bqkgh,bskh->bkgqs", dog, vf, scheme).to(dt)
    ds = p * (dp - dsum.to(dt).reshape(B, KV, G, Sq, 1))
    dk = product("bkgqs,bqkgh->bskgh", ds, qs, scheme).reshape(B, Skv, H, hd)
    dv = product("bkgqs,bqkgh->bskgh", p, dog, scheme).reshape(B, Skv, H, hd)
    dq = (product("bkgqs,bskh->bqkgh", ds, kf, scheme) * scale).reshape(
        B, Sq, H, hd)
    return dk, dv, dq


def inputs32(B, S, H, KV, hd, window):
    """float32 q, k, v, dO from a seeded numpy generator, and lse and D from
    the plain float32 forward."""
    rng = np.random.default_rng(hd + window)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd),
                             (B, S, H, hd)))
    o, lse = attention_ref(q, k, v, window=window)
    dsum = (do * o).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, dsum


def plain32(q, k, v, do, lse, dsum, window):
    return (*attention_dkv_ref(q, k, v, do, lse, dsum, window=window),
            attention_dq_ref(q, k, v, do, lse, dsum, window=window))


@pytest.mark.parametrize("B,S,H,KV,hd,window", CASES32, ids=IDS32)
def test_emulated_tf32x3_holds_the_float32_gradient_tolerance(B, S, H, KV, hd,
                                                              window):
    args = inputs32(B, S, H, KV, hd, window)
    got = emulate_bwd32(*args, window)
    for g, w in zip(got, plain32(*args, window)):
        assert_grad_close(g, w)
    # the JAX package: jax.vjp of its attention_ref on the same values; the
    # per-query-head dK and dV summed over each KV head's group
    q, k, v, do = args[:4]
    jq, jk, jv, jdo = (jnp.asarray(t.numpy()) for t in (q, k, v, do))
    _, vjp = jax.vjp(lambda a, b, c: jax_attention_ref(a, b, c, causal=True,
                                                       window=window),
                     jq, jk, jv)
    jdq, jdk, jdv = (torch.from_numpy(np.array(x)) for x in vjp(jdo))
    G = H // KV
    assert_grad_close(got[0].reshape(B, S, KV, G, hd).sum(3), jdk)
    assert_grad_close(got[1].reshape(B, S, KV, G, hd).sum(3), jdv)
    assert_grad_close(got[2], jdq)


@pytest.mark.parametrize("B,S,H,KV,hd,window", CASES32, ids=IDS32)
def test_tf32x3_errs_about_as_much_as_float32(B, S, H, KV, hd, window):
    """Against float64 on the same inputs, 3xTF32's dK, dV and dQ err at
    most TF32X3_ERR_RATIO times as much as plain float32's."""
    args = inputs32(B, S, H, KV, hd, window)
    exact = emulate_bwd32(*args, window, scheme="f64")
    for name, x3, x, e in zip(("dk", "dv", "dq"), emulate_bwd32(*args, window),
                              plain32(*args, window), exact):
        err3 = float((x3.double() - e).abs().max())
        err = float((x.double() - e).abs().max())
        assert err3 <= TF32X3_ERR_RATIO * err, (name, err3, err)


def test_single_tf32_rounding_misses_the_gradient_tolerance():
    """Why every product is split: each operand rounded once to TF32 (about
    2**-11 relative) puts dK, dV and dQ outside the float32 gradient
    tolerance at gemma3's head dim."""
    args = inputs32(1, 256, 4, 1, 256, 0)
    for name, x1, w in zip(("dk", "dv", "dq"),
                           emulate_bwd32(*args, 0, scheme="tf32"),
                           plain32(*args, 0)):
        lim = GRAD_TOL * max(1.0, float(w.abs().max()))
        assert float((x1 - w).abs().max()) > lim, name


# ---------------------------------------------------------------------------
# float32 forward: 3xTF32
# ---------------------------------------------------------------------------

FWD32_CASES = CASES32 + [
    (1, 192, 4, 4, 64, 0),                    # hd 64 (musicgen's heads)
    (1, 192, 4, 2, 128, 64),                  # GQA 2, a window
]
FWD32_IDS = [f"hd{c[4]}-w{c[5]}-kv{c[3]}" for c in FWD32_CASES]
# measured on FWD32_CASES: 3xTF32's output differs from plain float32's
# by at most 1.43e-6 (7% of ATT_ATOL); against float64 it errs 0.86-1.39x
# as much as plain float32 in the output, 1.01-1.51x in the log-sum-exp;
# one TF32 rounding differs from plain float32 by 9.5e-4 to 1.5e-3, 47-77x
# ATT_ATOL (54x at gemma3's hd 256 without a window)


def emulate_fwd32(q, k, v, window, scheme="tf32x3"):
    """The float32 forward kernel's arithmetic under ``scheme``: (o, lse),
    float32 (float64 for "f64", on the same float32 inputs). S = (q scale)
    K^T; each half of every key tile (32 keys of 64, 16 of 32 at hd 256)
    feeds its own running max m (base 2: max(s) * log2 e) and sum l, P =
    exp2(fma(s, log2 e, -m)) (the fma emulated in float64 and rounded once),
    O += P V; the two halves merge at the end, M = max(m0, m1), O and l
    each scaled by exp2(m - M)."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    dt = torch.float64 if scheme == "f64" else f32
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=dt)
    log2e = torch.tensor(LOG2E, dtype=dt)
    qs = (q.to(dt) * scale).reshape(B, Sq, KV, G, hd)      # q widened, scaled
    s = product("bqkgh,bskh->bkgqs", qs, k.to(dt), scheme).to(dt)
    s = torch.where(mask(Sq, Skv, window), s, torch.tensor(NEG_INF, dtype=dt))
    bk = 32 if hd > 128 else 64
    parts = []
    for half in range(2):
        m = torch.full((B, KV, G, Sq), NEG_INF, dtype=dt)
        l = torch.zeros((B, KV, G, Sq), dtype=dt)
        acc = torch.zeros((B, KV, G, Sq, hd), dtype=dt)
        for k0 in range(half * bk // 2, Skv, bk):
            keys = slice(k0, k0 + bk // 2)
            st = s[..., keys]
            m_new = torch.maximum(m, st.amax(-1) * log2e)
            alpha = torch.exp2(m - m_new)
            p = torch.exp2((st.double() * log2e.double()
                            - m_new[..., None].double()).to(dt))
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + product(
                "bkgqs,bskh->bkgqh", p, v[:, keys].to(dt), scheme).to(dt)
            m = m_new
        parts.append((m, l, acc))
    (m0, l0, a0), (m1, l1, a1) = parts
    mm = torch.maximum(m0, m1)
    f0, f1 = torch.exp2(m0 - mm), torch.exp2(m1 - mm)
    lsum = l0 * f0 + l1 * f1
    lsum = torch.where(lsum == 0, torch.ones((), dtype=dt), lsum)
    o = (a0 * f0[..., None] + a1 * f1[..., None]) / lsum[..., None]
    lse = mm * math.log(2.0) + torch.log(lsum)
    return (o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd),
            lse.reshape(B, H, Sq))


def inputs_fwd32(B, S, H, KV, hd, window):
    """float32 q, k, v from a seeded numpy generator."""
    rng = np.random.default_rng(2 * hd + window + KV)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]


@pytest.mark.parametrize("B,S,H,KV,hd,window", FWD32_CASES, ids=FWD32_IDS)
def test_emulated_tf32x3_forward_holds_the_float32_tolerance(B, S, H, KV, hd,
                                                             window):
    """Output and log-sum-exp within ATT_ATOL (abs; the log-sum-exp also
    rel) of the port's plain float32 forward, and the output within
    ATT_ATOL of the JAX package's attention_ref on the same values."""
    q, k, v = inputs_fwd32(B, S, H, KV, hd, window)
    o, lse = emulate_fwd32(q, k, v, window)
    want, want_lse = attention_ref(q, k, v, window=window)
    torch.testing.assert_close(o, want, atol=ATT_ATOL, rtol=0.0)
    torch.testing.assert_close(lse, want_lse, atol=ATT_ATOL, rtol=ATT_ATOL)
    jax_o = jax.jit(jax_attention_ref, static_argnames=("causal", "window"))(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)), causal=True,
        window=window)
    torch.testing.assert_close(o, torch.from_numpy(np.array(jax_o)),
                               atol=ATT_ATOL, rtol=0.0)


@pytest.mark.parametrize("B,S,H,KV,hd,window", FWD32_CASES, ids=FWD32_IDS)
def test_tf32x3_forward_errs_about_as_much_as_float32(B, S, H, KV, hd,
                                                      window):
    """Against float64 on the same inputs, the 3xTF32 forward's output and
    log-sum-exp err at most TF32X3_ERR_RATIO times as much as the plain
    float32 forward's."""
    q, k, v = inputs_fwd32(B, S, H, KV, hd, window)
    exact = emulate_fwd32(q, k, v, window, scheme="f64")
    for name, x3, x, e in zip(("o", "lse"), emulate_fwd32(q, k, v, window),
                              attention_ref(q, k, v, window=window), exact):
        err3 = float((x3.double() - e).abs().max())
        err = float((x.double() - e).abs().max())
        assert err3 <= TF32X3_ERR_RATIO * err, (name, err3, err)


def test_single_tf32_rounding_misses_the_forward_tolerance():
    """Why every product of the forward is split: each operand rounded once
    to TF32 puts the output outside ATT_ATOL of the plain float32 forward
    at gemma3's head dim."""
    q, k, v = inputs_fwd32(1, 256, 4, 1, 256, 0)
    o, _ = emulate_fwd32(q, k, v, 0, scheme="tf32")
    want, _ = attention_ref(q, k, v)
    assert float((o - want).abs().max()) > ATT_ATOL
