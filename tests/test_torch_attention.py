"""The port's serving kernels' plain versions (flash-attention forward, flash
decode, RG-LRU scan) and its cache layers against the JAX package, on the
same inputs made with numpy.

Tolerances: in float32 only the order of summation differs, 2e-5 for
attention (as the reference's own kernel tests) and 1e-4 for the scan, whose
reference is a log-depth associative scan; in bfloat16 the outputs are
rounded to 8 bits of mantissa, 2e-2 for attention and 5e-2 for the scan,
as ``tests/test_kernels.py`` holds the Pallas kernels."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.decode_attention import decode_attention_ref as jax_decode_ref  # noqa: E402
from repro.kernels.flash_attention import attention_ref as jax_attention_ref  # noqa: E402
from repro.kernels.flash_attention.flash_attention import flash_attention_fwd as jax_flash_fwd  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan as jax_rglru_scan  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan_ref as jax_rglru_ref  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels.decode_attention import (decode_attention_ref,  # noqa: E402
                                                  flash_decode)
from repro_torch.kernels.flash_attention import (attention_ref,  # noqa: E402
                                                 flash_attention,
                                                 flash_attention_fwd)
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_ref  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

NP_DT = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def pair(rng, shape, dtype, *, fn=None):
    """The same values as a numpy array for JAX and a tensor for the port
    (bfloat16 by round-to-nearest-even on both sides)."""
    x = rng.standard_normal(shape).astype(np.float32)
    if fn is not None:
        x = fn(x).astype(np.float32)
    return x.astype(NP_DT[dtype]), torch.from_numpy(x).to(T_DT[dtype])


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x).astype(np.float32)


# one compile per shape, not one per operation
jit_attention_ref = jax.jit(jax_attention_ref, static_argnames=("causal", "window"))
jit_decode_ref = jax.jit(jax_decode_ref)
jit_rglru_ref = jax.jit(jax_rglru_ref)


def lse_of(q, k, *, window) -> np.ndarray:
    """The log-sum-exp of each row of the reference kernel's masked scores,
    in float64 numpy."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qg = f32(q).astype(np.float64).reshape(B, Sq, KV, H // KV, hd) / np.sqrt(hd)
    s = np.einsum("bqkgh,bskh->bkgqs", qg, f32(k).astype(np.float64))
    qpos, kpos = np.arange(Sq)[:, None], np.arange(k.shape[1])[None, :]
    mask = kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = np.where(mask, s, JL.NEG_INF)
    m = s.max(-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0].reshape(B, H, Sq)


FLASH_CASES = [
    # B, S, H, KV, hd, window, bq, bk, dtype, tol (tests/test_kernels.py)
    (2, 256, 4, 2, 64, 0, 128, 128, "float32", 2e-5),
    (1, 256, 4, 1, 64, 64, 64, 64, "float32", 2e-5),
    (2, 192, 2, 2, 32, 0, 128, 128, "float32", 2e-5),  # padding path
    (1, 128, 8, 4, 128, 0, 128, 128, "float32", 2e-5),
    (1, 256, 4, 4, 64, 0, 128, 128, "bfloat16", 2e-2),
    (1, 384, 2, 1, 64, 128, 128, 128, "float32", 2e-5),
]


@pytest.mark.parametrize("B,S,H,KV,hd,window,bq,bk,dtype,tol", FLASH_CASES)
def test_flash_forward_plain_matches_reference(B, S, H, KV, hd, window, bq,
                                               bk, dtype, tol):
    rng = np.random.default_rng(S + H)
    (jq, q), (jk, k), (jv, v) = (pair(rng, (B, S, n, hd), dtype)
                                 for n in (H, KV, KV))
    o, lse = flash_attention_fwd(q, k, v, True, window)
    want = jit_attention_ref(jq, jk, jv, causal=True, window=window)
    assert o.dtype == q.dtype and lse.dtype == torch.float32
    np.testing.assert_allclose(f32(o), f32(want), atol=tol)
    np.testing.assert_allclose(lse.numpy(), lse_of(jq, jk, window=window),
                               atol=tol, rtol=tol)
    np.testing.assert_array_equal(f32(flash_attention(q, k, v, True, window)),
                                  f32(o))


@pytest.mark.parametrize("case", [FLASH_CASES[1], FLASH_CASES[2]],
                         ids=["window", "padding"])
def test_flash_forward_plain_matches_pallas_interpret(case):
    B, S, H, KV, hd, window, bq, bk, dtype, tol = case
    rng = np.random.default_rng(7 * S)
    (jq, q), (jk, k), (jv, v) = (pair(rng, (B, S, n, hd), dtype)
                                 for n in (H, KV, KV))
    Sp = -(-S // bq) * bq
    pad = ((0, 0), (0, Sp - S), (0, 0), (0, 0))
    jo, jlse = jax_flash_fwd(*(jnp.pad(jnp.asarray(a), pad) for a in (jq, jk, jv)),
                             causal=True, window=window, block_q=bq,
                             block_k=bk, interpret=True)
    o, lse = flash_attention_fwd(q, k, v, True, window)
    np.testing.assert_allclose(f32(o), f32(jo)[:, :S], atol=tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., :S],
                               atol=tol, rtol=tol)


def test_flash_forward_padding_rule():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 70, 2, 32)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 70, 1, 32)).astype(np.float32))
    o, lse = flash_attention_fwd(q, k, k, True, 0)          # causal self: padded
    assert o.shape == q.shape and lse.shape == (1, 2, 70)
    want, want_lse = attention_ref(q, k, k)
    np.testing.assert_allclose(o.numpy(), want.numpy(), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=2e-5)
    with pytest.raises(ValueError, match="causal self-attention"):
        flash_attention_fwd(q, k, k, False, 0)
    with pytest.raises(ValueError, match="causal self-attention"):
        flash_attention_fwd(q[:, :64], k, k, True, 0)


DECODE_CASES = [
    # B, H, KV, hd, S, valid_len, dtype, tol (tests/test_kernels.py)
    (2, 4, 2, 64, 256, 200, "float32", 2e-5),
    (1, 8, 1, 128, 512, 512, "float32", 2e-5),
    (3, 4, 4, 32, 128, 1, "float32", 2e-5),
    (2, 8, 2, 64, 256, 77, "bfloat16", 2e-2),
]


@pytest.mark.parametrize("B,H,KV,hd,S,vl,dtype,tol", DECODE_CASES)
def test_flash_decode_plain_matches_reference(B, H, KV, hd, S, vl, dtype, tol):
    rng = np.random.default_rng(S + vl)
    jq, q = pair(rng, (B, H, hd), dtype)
    (jk, k), (jv, v) = (pair(rng, (B, S, KV, hd), dtype) for _ in range(2))
    o = flash_decode(q, k, v, vl)
    np.testing.assert_allclose(f32(o), f32(jit_decode_ref(jq, jk, jv, vl)),
                               atol=tol)
    o4 = flash_decode(q[:, None], k, v, vl)        # (B,1,H,hd) form
    assert o4.shape == (B, 1, H, hd)
    np.testing.assert_array_equal(f32(o4[:, 0]), f32(o))
    np.testing.assert_array_equal(f32(decode_attention_ref(q, k, v, vl)), f32(o))


def test_flash_decode_refuses_bad_valid_len():
    q, k = torch.zeros(1, 2, 32), torch.zeros(1, 8, 1, 32)
    for vl in (0, 9):
        with pytest.raises(ValueError, match="valid_len"):
            flash_decode(q, k, k, vl)


W_RING = 16


@pytest.mark.parametrize("pos", [0, W_RING - 2, W_RING - 1, W_RING,
                                 3 * W_RING + 5])
def test_ring_decode_through_flash_decode_matches_reference(pos):
    """A ring of size W read through flash decode with valid_len =
    min(pos + 1, W) is the reference's decode_attention_ring: slots not yet
    filled hold noise here and must be ignored."""
    B, H, KV, hd = 2, 4, 1, 32
    rng = np.random.default_rng(pos)
    jq, q = pair(rng, (B, 1, H, hd), "float32")
    (jk, k), (jv, v) = (pair(rng, (B, W_RING, KV, hd), "float32")
                        for _ in range(2))
    want = JL.decode_attention_ring(jq, {"k": jk, "v": jv}, pos, window=W_RING)
    got = flash_decode(q, k, v, L.ring_valid_len(pos, W_RING))
    np.testing.assert_allclose(f32(got), f32(want), atol=2e-5)
    plain = L.decode_attention_ring(q, {"k": k, "v": v}, pos, window=W_RING)
    np.testing.assert_allclose(f32(plain), f32(want), atol=2e-5)


def test_cache_layers_match_reference():
    rng = np.random.default_rng(3)
    B, KV, hd, W = 2, 1, 8, 6
    for S in (4, W, 11):
        jk, k = pair(rng, (B, S, KV, hd), "float32")
        jv, v = pair(rng, (B, S, KV, hd), "float32")
        want = JL.ring_fill_from_prefill(jk, jv, W)
        got = L.ring_fill_from_prefill(k, v, W)
        for n in ("k", "v"):
            np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))
    for pos in (0, 5, 6, 13):
        np.testing.assert_array_equal(L.ring_positions(pos, W).numpy(),
                                      np.asarray(JL.ring_positions(pos, W)))
        assert L.ring_valid_len(pos, W) == int(
            np.sum(np.asarray(JL.ring_positions(pos, W)) >= 0))
    cache = {"k": torch.zeros(B, W, KV, hd), "v": torch.zeros(B, W, KV, hd)}
    jcache = {"k": jnp.zeros((B, W, KV, hd)), "v": jnp.zeros((B, W, KV, hd))}
    jk1, k1 = pair(rng, (B, 1, KV, hd), "float32")
    for upd, jupd, p in ((L.cache_update_ring, JL.cache_update_ring, 9),
                         (L.cache_update_full, JL.cache_update_full, 4)):
        new = upd(cache, k1, k1, p)
        jnew = jupd(jcache, jk1, jk1, p)
        np.testing.assert_array_equal(new["k"].numpy(), np.asarray(jnew["k"]))
        assert not cache["k"].any()             # functional: input unchanged
    jx, x = pair(rng, (B, 7, 5), "float32")
    jw, w = pair(rng, (5, 4), "float32")
    np.testing.assert_allclose(L.causal_conv1d(x, w).numpy(),
                               np.asarray(JL.causal_conv1d(jx, jw)), atol=1e-6)
    js, st = pair(rng, (B, 3, 5), "float32")
    y, s2 = L.conv_state_update(st, x[:, :1], w)
    jy, js2 = JL.conv_state_update(js, jx[:, :1], jw)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-6)
    np.testing.assert_array_equal(s2.numpy(), np.asarray(js2))


def test_windowed_plain_attention_matches_reference():
    rng = np.random.default_rng(5)
    jq, q = pair(rng, (2, 12, 4, 8), "float32")
    jk, k = pair(rng, (2, 20, 2, 8), "float32")
    jv, v = pair(rng, (2, 20, 2, 8), "float32")
    for kw in ({"window": 5}, {"q_offset": 8, "kv_valid_len": 17},
               {"q_offset": 8, "window": 4, "kv_valid_len": 20}):
        np.testing.assert_allclose(
            L.attention(q, k, v, **kw).numpy(),
            np.asarray(JL.attention(jq, jk, jv, **kw)), atol=2e-5)
    jx, x = pair(rng, (1, 1, 4, 16), "float32")
    np.testing.assert_allclose(
        L.rope(x, 37, theta=1e4).numpy(),
        np.asarray(JL.rope(jx, jnp.asarray([37]), theta=1e4)), atol=1e-6)


RGLRU_CASES = [
    # B, S, W, bw, ch, dtype, tol (tests/test_kernels.py); bw None: shapes
    # the Pallas kernel's S % chunk and W % block_w asserts refuse, held
    # against the jitted reference alone
    (2, 128, 256, 128, 32, "float32", 1e-4),
    (3, 64, 128, 64, 64, "float32", 1e-4),
    (1, 128, 256, 128, 32, "bfloat16", 5e-2),
    (2, 1, 256, 128, 32, "float32", 1e-4),           # one step
    (2, 1, 200, None, None, "float32", 1e-4),
    (3, 65, 200, None, None, "float32", 1e-4),       # W % 128, S % 64
    (2, 77, 201, None, None, "float32", 1e-4),       # rows off 16 bytes
    (1, 65, 201, None, None, "bfloat16", 5e-2),
]


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


@pytest.mark.parametrize("B,S,W,bw,ch,dtype,tol", RGLRU_CASES)
def test_rglru_plain_matches_reference_and_interpret(B, S, W, bw, ch, dtype,
                                                     tol):
    rng = np.random.default_rng(S * W)
    ja, a = pair(rng, (B, S, W), dtype, fn=_sigmoid)
    jb, b = pair(rng, (B, S, W), dtype)
    h, h_last = rglru_scan(a, b)
    assert h.dtype == a.dtype and h_last.dtype == torch.float32
    outs = [jit_rglru_ref(ja, jb)]
    if bw is not None:
        outs.append(jax_rglru_scan(ja, jb, block_w=bw, chunk=ch, interpret=True))
    for jh, jlast in outs:
        np.testing.assert_allclose(f32(h), f32(jh), atol=tol)
        np.testing.assert_allclose(h_last.numpy(), np.asarray(jlast), atol=tol)
    np.testing.assert_array_equal(f32(rglru_scan_ref(a, b)[0]), f32(h))


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    _lib.reset_launches()
    q = torch.randn(1, 64, 2, 32)
    flash_attention(q, q[:, :, :1], q[:, :, :1])
    flash_decode(q[:, 0], q[:, :, :1], q[:, :, :1], 10)
    rglru_scan(torch.rand(1, 5, 8), torch.randn(1, 5, 8))
    assert all(v == 0 for v in _lib.LAUNCHES.values())


def test_decode_and_scan_refuse_inputs_that_require_grad():
    q = torch.randn(1, 64, 2, 32, requires_grad=True)
    k = torch.randn(1, 64, 1, 32)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_decode(q[:, 0], k, k, 3)
    with pytest.raises(RuntimeError, match="no backward"):
        rglru_scan(torch.rand(1, 4, 8, requires_grad=True), torch.randn(1, 4, 8))
    with torch.no_grad():                   # no graph can record here
        assert flash_attention(q, k, k).shape == q.shape
