"""The flash-decode kernels' algorithm (split over the cache, one
online-softmax rescale per key tile in the log2 domain, the partials merged
in split order), emulated in plain PyTorch (``decode_partials_ref``,
``decode_merge_ref``, reached through the ``decode_partials`` /
``decode_merge`` wrappers on CPU tensors), against the JAX package's
``decode_attention_ref`` and its Pallas kernel in interpret mode, on the
same inputs made with numpy; and the split function itself.

Tolerances: float32 2e-5 abs (only the order of summation differs, as
``tests/test_kernels.py`` holds the Pallas kernel); bfloat16 within one
bf16 ulp of each output (2**-7 relative) plus 2e-5: both sides round
nearly equal float32 values to bf16."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.decode_attention import decode_attention_ref as jax_decode_ref  # noqa: E402
from repro.kernels.decode_attention.decode_attention import decode_attention as jax_pallas_decode  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels.decode_attention import (decode_attention_ref,  # noqa: E402
                                                  decode_merge,
                                                  decode_partials,
                                                  decode_splits, decode_tile,
                                                  flash_decode)
from repro_torch.kernels.decode_attention.ops import (DECODE_CTAS,  # noqa: E402
                                                      MAX_SPLITS)
from repro_torch.models import layers as L  # noqa: E402

NP_DT = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ATOL, BF16_RTOL = 2e-5, 2 ** -7

jit_decode_ref = jax.jit(jax_decode_ref)


def inputs(seed, B, H, KV, hd, S, dtype):
    """q (B,H,hd), k, v (B,S,KV,hd): numpy arrays for JAX and tensors for
    the port with the same values (bf16 by round-to-nearest-even)."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in ((B, H, hd), (B, S, KV, hd), (B, S, KV, hd)):
        x = rng.standard_normal(shape).astype(np.float32)
        out.append((x.astype(NP_DT[dtype]), torch.from_numpy(x).to(T_DT[dtype])))
    return out


def emulated(q, k, v, valid_len):
    """The kernels' algorithm on CPU tensors, through the wrappers."""
    return decode_merge(decode_partials(q, k, v, valid_len), q.dtype)


def assert_close(got, want, dtype):
    got = got.to(torch.float32).numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got).astype(np.float32)
    want = np.asarray(want).astype(np.float32)
    rtol = BF16_RTOL if dtype == "bfloat16" else 0.0
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=rtol)


def last_split_keys(B, KV, hd, valid_len):
    splits, per = decode_splits(B, KV, hd, valid_len)
    return valid_len - (splits - 1) * per, per


SPLIT_CASES = [
    # B, H, KV, hd, S, valid_len, dtype
    # G = 1 at phi3-mini's head dim (tile 64), 64 (batch, KV head) pairs:
    # splits of several tiles; 767 / 768 / 769 leave the last split one
    # key short, full, and holding one key (asserted below); S = 1000 is a
    # multiple of no tile
    *[(2, 32, 32, 96, 1000, vl, "float32")
      for vl in (1, 63, 64, 65, 767, 768, 769, 1000)],
    # G = 4 at gemma3's head dim (tile 32): one tile a split at 2 pairs,
    # so every tile boundary is a split boundary
    *[(2, 4, 1, 256, 300, vl, "float32") for vl in (1, 31, 32, 33, 300)],
    # G = 4, two tiles a split at 4 pairs: 2175 / 2176 / 2177 around the
    # last split's boundary
    *[(4, 4, 1, 256, 2200, vl, "float32") for vl in (2175, 2176, 2177, 2200)],
    # G = 10 (recurrentgemma's group) at hd 64 and 128
    *[(1, 10, 1, 64, 200, vl, "float32") for vl in (1, 63, 64, 65, 200)],
    (2, 20, 2, 128, 130, 130, "float32"),
    (2, 20, 2, 128, 300, 129, "float32"),
    # bfloat16
    (2, 32, 32, 96, 1000, 769, "bfloat16"),
    (4, 4, 1, 256, 2200, 2177, "bfloat16"),
    (1, 10, 1, 64, 200, 65, "bfloat16"),
    (2, 10, 1, 256, 100, 100, "bfloat16"),
    (2, 8, 2, 128, 333, 257, "bfloat16"),
]


@pytest.mark.parametrize("B,H,KV,hd,S,vl,dtype", SPLIT_CASES)
def test_split_and_merge_match_reference(B, H, KV, hd, S, vl, dtype):
    (jq, q), (jk, k), (jv, v) = inputs(S + vl + hd, B, H, KV, hd, S, dtype)
    got = emulated(q, k, v, vl)
    assert got.shape == (B, H, hd) and got.dtype == T_DT[dtype]
    assert_close(got, jit_decode_ref(jq, jk, jv, vl), dtype)


def test_split_cases_reach_the_boundaries():
    """The cases above really put valid_len at a split boundary +-1 with
    splits of several tiles, and at tile - 1, tile, tile + 1."""
    assert decode_tile(96) == decode_tile(64) == 64 and decode_tile(256) == 32
    assert last_split_keys(2, 32, 96, 767) == (191, 192)
    assert last_split_keys(2, 32, 96, 768) == (192, 192)
    assert last_split_keys(2, 32, 96, 769) == (1, 256)
    assert last_split_keys(4, 1, 256, 2175) == (63, 64)
    assert last_split_keys(4, 1, 256, 2176) == (64, 64)
    assert last_split_keys(4, 1, 256, 2177) == (1, 64)


PALLAS_CASES = [
    # B, H, KV, hd, S, valid_len, block_k, dtype: S a multiple of block_k
    (2, 4, 1, 256, 256, 33, 64, "float32"),
    (1, 10, 1, 64, 128, 65, 32, "float32"),
    (2, 8, 8, 96, 256, 200, 128, "float32"),
    (1, 4, 2, 128, 128, 128, 64, "bfloat16"),
]


@pytest.mark.parametrize("B,H,KV,hd,S,vl,bk,dtype", PALLAS_CASES)
def test_split_and_merge_match_pallas_interpret(B, H, KV, hd, S, vl, bk, dtype):
    (jq, q), (jk, k), (jv, v) = inputs(S * vl, B, H, KV, hd, S, dtype)
    want = jax_pallas_decode(jq, jk, jv, vl, block_k=bk, interpret=True)
    assert_close(emulated(q, k, v, vl), want, dtype)


W_RING = 64


@pytest.mark.parametrize("pos", [0, W_RING - 2, W_RING - 1, W_RING,
                                 3 * W_RING + 5])
def test_split_and_merge_read_a_ring(pos):
    """A ring of W slots at position pos is read with valid_len =
    min(pos + 1, W): the reference's decode_attention_ring, unfilled slots
    (noise here) ignored."""
    B, H, KV, hd = 2, 8, 2, 64
    (jq, q), (jk, k), (jv, v) = inputs(pos, B, H, KV, hd, W_RING, "float32")
    want = JL.decode_attention_ring(jq[:, None], {"k": jk, "v": jv}, pos,
                                    window=W_RING)[:, 0]
    assert_close(emulated(q, k, v, L.ring_valid_len(pos, W_RING)), want,
                 "float32")


def test_split_never_reads_past_valid_len():
    """Rows at or past valid_len hold NaN: the output stays finite and
    equal to the same call on a cache cut at valid_len."""
    B, H, KV, hd, S, vl = 2, 4, 1, 256, 200, 97
    (_, q), (_, k), (_, v) = inputs(5, B, H, KV, hd, S, "float32")
    k[:, vl:], v[:, vl:] = float("nan"), float("nan")
    got = emulated(q, k, v, vl)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, emulated(q, k[:, :vl], v[:, :vl], vl),
                               atol=0, rtol=0)


def test_flash_decode_on_cpu_stays_the_plain_reference():
    (_, q), (_, k), (_, v) = inputs(9, 2, 4, 1, 64, 100, "float32")
    _lib.reset_launches()
    o = flash_decode(q, k, v, 77)
    assert torch.equal(o, decode_attention_ref(q, k, v, 77))
    assert all(n == 0 for n in _lib.LAUNCHES.values())


@pytest.mark.parametrize("hd", _lib.DECODE_HEAD_DIMS)
def test_decode_splits_cover_the_cache_without_an_empty_split(hd):
    tile = decode_tile(hd)
    for pairs in (1, 2, 4, 8, 64, 128, 264, 300):
        for vl in (*range(1, 3 * tile + 2), *range(3 * tile + 2, 9000, 37)):
            splits, per = decode_splits(pairs, 1, hd, vl)
            assert decode_splits(pairs, 1, hd, vl) == (splits, per)
            assert per % tile == 0 and 1 <= splits <= MAX_SPLITS
            assert (splits - 1) * per < vl <= splits * per      # none empty
            # no more CTAs than the target, unless one split each
            assert splits == 1 or splits * pairs <= DECODE_CTAS


def test_partials_fit_their_workspace():
    """decode_partials returns the (B, H, splits, hd + 2) float32 workspace
    the kernel writes, with a finite max and a positive sum in every
    split."""
    B, H, KV, hd, S, vl = 2, 8, 2, 128, 700, 650
    (_, q), (_, k), (_, v) = inputs(11, B, H, KV, hd, S, "float32")
    splits, _ = decode_splits(B, KV, hd, vl)
    ws = decode_partials(q, k, v, vl)
    assert ws.shape == (B, H, splits, hd + 2) and ws.dtype == torch.float32
    assert torch.isfinite(ws).all() and (ws[..., hd + 1] >= 1).all()
