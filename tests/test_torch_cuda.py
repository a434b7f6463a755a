"""The port's CUDA kernels against their plain PyTorch versions on a GPU: the
checkpoint kernels and the RG-LRU scan bit for bit, the attention kernels
within float32 summation-order tolerances: 2e-5 in float32; in bfloat16 one
bfloat16 ulp of each output (both sides round nearly equal float32 values,
so they differ by at most one ulp: 2**-7 relative) plus 2e-5. Imports no
JAX, so it runs on a machine that has only the port's dependencies:

    python -m pytest -m cuda tests/test_torch_cuda.py

Without a GPU every test skips: the kernels have no CPU mode."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.checkpoint import serialize as ser  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels import fingerprint as fp  # noqa: E402
from repro_torch.kernels import quantize as qz  # noqa: E402
from repro_torch.kernels.decode_attention import (decode_attention_ref,  # noqa: E402
                                                  flash_decode)
from repro_torch.kernels.flash_attention import (attention_ref,  # noqa: E402
                                                 flash_attention_fwd)
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_ref  # noqa: E402

CHUNK = 64 * 1024

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def payload(dtype: torch.dtype, n: int, seed: int = 0) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed + n)
    if dtype.is_floating_point:
        return (torch.randn(n, generator=g) * 3).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(max(info.min, -2**40), min(info.max, 2**40), (n,),
                         generator=g, dtype=dtype)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.detach().cpu().contiguous(), b.detach().cpu().contiguous()
    return (a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        ser.tensor_to_numpy(a).reshape(-1).view(np.uint8),
        ser.tensor_to_numpy(b).reshape(-1).view(np.uint8)))


FP_CASES = [
    (torch.float32, 3 * CHUNK // 4 + 17),       # partial last block
    (torch.bfloat16, 2 * CHUNK + 1),
    (torch.int8, 5 * CHUNK + 333),
    (torch.int32, CHUNK // 4),
    (torch.float32, 7),
    (torch.uint8, 13),
    (torch.int64, 3 * CHUNK // 8 + 5),
    (torch.float64, CHUNK // 8 + 1),
]


@pytest.mark.parametrize("dtype,n", FP_CASES)
@pytest.mark.parametrize("misaligned", [False, True], ids=["aligned", "misaligned"])
def test_fingerprint_and_diff_match_plain(cuda, dtype, n, misaligned):
    # a view that starts 4 (or 8) bytes into its buffer is not 16-byte
    # aligned, so the kernel takes its 4-byte load path
    skip = max(1, 4 // torch.empty(0, dtype=dtype).element_size()) if misaligned else 0
    full = payload(dtype, n + skip)
    x, xc = full[skip:], full.to(cuda)[skip:]
    assert (xc.data_ptr() % 16 != 0) == misaligned
    before = _lib.LAUNCHES["fingerprint"]
    got = fp.fingerprint_blocks(xc, block_bytes=CHUNK)
    assert _lib.LAUNCHES["fingerprint"] == before + 1
    assert same_bits(got, fp.fingerprint_blocks(x.contiguous(), block_bytes=CHUNK))
    old = got.clone()
    old[::2] ^= 1
    new, diff = fp.fingerprint_diff(xc, old, block_bytes=CHUNK)
    want, wdiff = fp.fingerprint_diff(x.contiguous(), old.cpu(), block_bytes=CHUNK)
    assert same_bits(new, want) and torch.equal(diff.cpu(), wdiff)


def ties(dtype):
    return torch.tensor([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, -126.5, 3.0]).to(dtype)


Q_CASES = [
    ("f32", lambda: payload(torch.float32, 100_003)),
    ("bf16", lambda: payload(torch.bfloat16, 100_001)),
    ("f16", lambda: payload(torch.float16, 4099)),
    ("f32_ties", lambda: ties(torch.float32)),
    ("bf16_ties", lambda: ties(torch.bfloat16)),
    ("f32_subnormal", lambda: torch.tensor([1e-40, -3e-39, 2e-45])),
    ("f32_2d", lambda: payload(torch.float32, 6 * 130).reshape(6, 130)),
]


@pytest.mark.parametrize("name,make", Q_CASES, ids=[c[0] for c in Q_CASES])
def test_absmax_quantize_dequantize_match_plain(cuda, name, make):
    x = make()
    assert same_bits(qz.absmax(x.to(cuda))[0], qz.absmax_ref(x))
    q, scale = qz.quantize_int8(x.to(cuda))
    qr, sr = qz.quantize_int8_ref(x)
    assert scale == sr and same_bits(q, qr)
    if x.dtype != torch.float16:
        hq, hs = ser.quantize(ser.to_host(x), "int8", ser.dtype_to_name(x.dtype))
        assert hs == scale and np.array_equal(hq, q.cpu().numpy())
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        assert same_bits(qz.dequantize_int8(q, scale, dtype=dt),
                         qz.dequantize_int8_ref(qr, sr, dtype=dt))


def test_absmax_propagates_nan(cuda):
    x = payload(torch.float32, 70_000)
    x[12_345] = float("nan")
    assert torch.isnan(qz.absmax(x.to(cuda))).all()


def test_wrappers_refuse_bad_operands(cuda):
    with pytest.raises(TypeError):
        qz.absmax(torch.zeros(8, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        fp.fingerprint_blocks(torch.zeros(8, 8, device=cuda).t(), block_bytes=64)
    with pytest.raises(TypeError):
        qz.dequantize_int8(torch.zeros(8, dtype=torch.int8, device=cuda), 1.0,
                           dtype=torch.int32)


def test_quantize_kernels_on_misaligned_views(cuda):
    # views 4 bytes into their buffers: the kernels' scalar load path
    x = payload(torch.float32, 50_001)
    xc = x.to(cuda)[1:]
    assert xc.data_ptr() % 16 != 0
    q, scale = qz.quantize_int8(xc)
    qr, sr = qz.quantize_int8_ref(x[1:].contiguous())
    assert scale == sr and same_bits(q, qr)
    qv = q[4:]
    assert qv.data_ptr() % 16 != 0
    assert same_bits(qz.dequantize_int8(qv, scale, dtype=torch.float32),
                     qz.dequantize_int8_ref(qr[4:], sr, dtype=torch.float32))


# (atol, rtol) of an attention output against its plain version
ATT_TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (2e-5, 2 ** -7)}


def randn(shape, dtype, seed, device):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype).to(device)


FLASH_GPU_CASES = [
    # B, S, H, KV, hd, window, dtype
    (2, 256, 4, 2, 64, 0, torch.float32),
    (1, 256, 4, 1, 64, 64, torch.float32),
    (1, 192, 4, 1, 256, 0, torch.float32),
    (2, 320, 4, 1, 256, 100, torch.bfloat16),
    (1, 200, 2, 1, 64, 0, torch.bfloat16),        # padding path: 200 -> 256
    (1, 77, 4, 2, 256, 16, torch.float32),        # padding path, window
    (1, 128, 8, 4, 128, 0, torch.bfloat16),
    (2, 64, 2, 2, 64, 0, torch.float32),         # one block, KV = H
]


@pytest.mark.parametrize("B,S,H,KV,hd,window,dtype", FLASH_GPU_CASES)
def test_flash_attention_kernel_matches_plain(cuda, B, S, H, KV, hd, window,
                                              dtype):
    q = randn((B, S, H, hd), dtype, S + hd, cuda)
    k = randn((B, S, KV, hd), dtype, S + hd + 1, cuda)
    v = randn((B, S, KV, hd), dtype, S + hd + 2, cuda)
    before = _lib.LAUNCHES["flash_attention_fwd"]
    o, lse = flash_attention_fwd(q, k, v, True, window)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["flash_attention_fwd"] == before + 1
    want, want_lse = attention_ref(q, k, v, causal=True, window=window)
    assert o.dtype == dtype and o.shape == q.shape and lse.shape == (B, H, S)
    atol, rtol = ATT_TOL[dtype]
    torch.testing.assert_close(o.float(), want.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=2e-5)


def test_flash_attention_kernel_non_causal_aligned(cuda):
    q = randn((1, 128, 2, 64), torch.float32, 1, cuda)
    k = randn((1, 192, 1, 64), torch.float32, 2, cuda)
    o, lse = flash_attention_fwd(q, k, k, False, 0)
    want, want_lse = attention_ref(q, k, k, causal=False)
    torch.testing.assert_close(o, want, atol=2e-5, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=2e-5)


DECODE_GPU_CASES = [
    # B, H, KV, hd, S, valid_len, dtype
    (2, 4, 1, 256, 2048, 1, torch.bfloat16),
    (2, 4, 1, 256, 2048, 1000, torch.bfloat16),
    (2, 4, 1, 256, 2048, 2048, torch.bfloat16),
    (3, 4, 2, 64, 333, 1, torch.float32),         # S a multiple of no block
    (3, 4, 2, 64, 333, 170, torch.float32),
    (3, 4, 2, 64, 333, 333, torch.float32),
    (1, 10, 1, 256, 2048, 77, torch.float32),
    (2, 8, 8, 128, 100, 33, torch.bfloat16),
]


@pytest.mark.parametrize("B,H,KV,hd,S,vl,dtype", DECODE_GPU_CASES)
def test_flash_decode_kernel_matches_plain(cuda, B, H, KV, hd, S, vl, dtype):
    q = randn((B, H, hd), dtype, S + vl, cuda)
    k = randn((B, S, KV, hd), dtype, S + vl + 1, cuda)
    v = randn((B, S, KV, hd), dtype, S + vl + 2, cuda)
    before = _lib.LAUNCHES["decode_attention"]
    o = flash_decode(q[:, None], k, v, vl)[:, 0]
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["decode_attention"] == before + 1
    atol, rtol = ATT_TOL[dtype]
    torch.testing.assert_close(o.float(), decode_attention_ref(q, k, v, vl).float(),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("pos", [0, 510, 511, 512, 3 * 512 + 5])
def test_flash_decode_kernel_reads_a_ring(cuda, pos):
    from repro_torch.models import layers as L
    W = 512
    q = randn((2, 1, 4, 256), torch.float32, pos, cuda)
    k = randn((2, W, 1, 256), torch.float32, pos + 1, cuda)
    v = randn((2, W, 1, 256), torch.float32, pos + 2, cuda)
    o = flash_decode(q, k, v, L.ring_valid_len(pos, W))
    want = L.decode_attention_ring(q, {"k": k, "v": v}, pos, window=W)
    torch.testing.assert_close(o, want, atol=2e-5, rtol=0)


RGLRU_GPU_CASES = [
    # B, S, W, dtype
    (2, 128, 256, torch.float32),
    (4, 1984, 2560, torch.float32),
    (3, 77, 200, torch.float32),                  # W a multiple of no block
    (1, 128, 256, torch.bfloat16),
]


@pytest.mark.parametrize("B,S,W,dtype", RGLRU_GPU_CASES)
def test_rglru_scan_kernel_matches_plain_bit_for_bit(cuda, B, S, W, dtype):
    a = torch.sigmoid(randn((B, S, W), torch.float32, S, cuda)).to(dtype)
    b = randn((B, S, W), dtype, S + 1, cuda)
    before = _lib.LAUNCHES["rglru_scan"]
    h, h_last = rglru_scan(a, b)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["rglru_scan"] == before + 1
    hr, lr = rglru_scan_ref(a, b)
    assert same_bits(h, hr) and same_bits(h_last, lr)


def test_serving_kernels_refuse_bad_operands(cuda):
    q = torch.zeros(1, 64, 2, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_fwd(q, q[:, :, :1], q[:, :, :1])
    with pytest.raises(ValueError, match="valid_len"):
        flash_decode(q[:, 0, :, :32].contiguous(), q[:, :, :1, :32], q[:, :, :1, :32], 65)
    with pytest.raises(ValueError):
        rglru_scan(torch.zeros(1, 4, 8, device=cuda),
                   torch.zeros(1, 4, 8, device=cuda, dtype=torch.bfloat16))
    h = q.to(torch.float16)                # no float16 instance is built
    with pytest.raises(TypeError, match="dtype"):
        flash_decode(h[:, 0, :, :32].contiguous(), h[:, :, :1, :32], h[:, :, :1, :32], 4)
    with pytest.raises(TypeError, match="dtype"):
        rglru_scan(h[:, :, 0], h[:, :, 0])
