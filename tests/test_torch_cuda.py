"""The port's CUDA kernels against their plain PyTorch versions on a GPU: the
checkpoint kernels and the RG-LRU scan bit for bit, the attention kernels
within float32 summation-order tolerances: 2e-5 in float32; in bfloat16 one
bfloat16 ulp of each output (both sides round nearly equal float32 values,
so they differ by at most one ulp: 2**-7 relative) plus 2e-5. The backward
kernels' gradients: in float32 max|err| <= 2e-4 * max(1, max|plain|) (the
reference's gradient tolerance, 10 x 2e-5); in bfloat16 two bf16 ulps of
each element (2 * 2**-7 relative) plus that float32 limit. The selective
scan: in float32 within 1e-4 (the reference's tolerance); in bfloat16 y
within one ulp (2**-7 relative) plus 1e-4, h_last within 1e-4 of its
largest. Imports no JAX, so it runs on a machine that has only the port's
dependencies:

    python -m pytest -m cuda tests/test_torch_cuda.py

Without a GPU every test skips: the kernels have no CPU mode."""

import shutil

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.checkpoint import serialize as ser  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels import fingerprint as fp  # noqa: E402
from repro_torch.kernels import quantize as qz  # noqa: E402
from repro_torch.kernels.decode_attention import (decode_attention_ref,  # noqa: E402
                                                  decode_merge,
                                                  decode_merge_ref,
                                                  decode_partials,
                                                  decode_splits, flash_decode)
from repro_torch.kernels.flash_attention import (VARIANTS,  # noqa: E402
                                                 attention_bwd_ref,
                                                 attention_dkv_ref,
                                                 attention_dq_ref,
                                                 attention_ref,
                                                 flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_dkv,
                                                 flash_attention_dq,
                                                 flash_attention_fwd)
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_ref  # noqa: E402
from repro_torch.kernels.ssm_scan import (selective_scan, ssm_scan,  # noqa: E402
                                          ssm_scan_ref)

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
    before = dict(_lib.LAUNCHES)
    got = fp.fingerprint_blocks(xc, block_bytes=CHUNK)
    for name in ("fingerprint", "fingerprint_final"):
        assert _lib.LAUNCHES[name] == before[name] + 1
    assert same_bits(got, fp.fingerprint_blocks(x.contiguous(), block_bytes=CHUNK))
    old = got.clone()
    old[::2] ^= 1
    new, diff = fp.fingerprint_diff(xc, old, block_bytes=CHUNK)
    want, wdiff = fp.fingerprint_diff(x.contiguous(), old.cpu(), block_bytes=CHUNK)
    assert same_bits(new, want) and torch.equal(diff.cpu(), wdiff)


# (dtype, elements, block_bytes): blocks that are not a multiple of the
# first launch's 64 KiB slice (4 B, 4 KiB, 1 MiB + 16), a tensor of one
# word, 4096 small blocks, a tensor that ends inside its last slice
FP_SLICE_CASES = [
    (torch.float32, 1001, 4),
    (torch.int8, 4099, 4),
    (torch.bfloat16, 3 * 2048 + 5, 4096),
    (torch.int64, 1000, 4096),
    (torch.bfloat16, (2 * (2 ** 20 + 16) + 40_000) // 2, 2 ** 20 + 16),
    (torch.int8, 2 ** 20 + 16 + 3, 2 ** 20 + 16),
    (torch.int32, 1, 2 ** 20),
    (torch.uint8, 1, 64),
    (torch.bfloat16, 4096 * 2048, 4096),
    (torch.float32, (2 ** 20 + 3 * 2 ** 16 + 1000) // 4, 2 ** 20),
    (torch.bfloat16, (2 ** 20 + 3 * 2 ** 16 + 1002) // 2, 2 ** 20),
    (torch.int8, 2 ** 20 + 3 * 2 ** 16 + 1001, 2 ** 20),
]


@pytest.mark.parametrize("dtype,n,block", FP_SLICE_CASES)
@pytest.mark.parametrize("misaligned", [False, True], ids=["aligned", "misaligned"])
def test_fingerprint_launches_match_their_plain_versions(cuda, dtype, n, block,
                                                         misaligned):
    skip = max(1, 4 // torch.empty(0, dtype=dtype).element_size()) if misaligned else 0
    full = payload(dtype, n + skip, seed=3)
    x, xc = full[skip:].contiguous(), full.to(cuda)[skip:]
    assert (xc.data_ptr() % 16 != 0) == misaligned
    parts = fp.fingerprint_partials(xc, block_bytes=block)
    assert same_bits(parts, fp.fingerprint_partials_ref(x, block, fp.SLICE_BYTES))
    old = fp.fingerprint_blocks(x, block_bytes=block)
    old[1::2] ^= 1
    got, diff = fp.fingerprint_final(parts, old.to(cuda))
    want, wdiff = fp.fingerprint_final_ref(parts.cpu(), old)
    assert same_bits(got, want) and torch.equal(diff.cpu(), wdiff)
    new, diff = fp.fingerprint_diff(xc, old.to(cuda), block_bytes=block)
    assert same_bits(new, want) and torch.equal(diff.cpu(), wdiff)
    assert same_bits(new, fp.fingerprint_blocks_ref(x, block))


def test_fingerprint_counts_both_launches_each_call(cuda):
    x = payload(torch.bfloat16, 3 * 2 ** 19 + 7).to(cuda)
    before = dict(_lib.LAUNCHES)
    fp.fingerprint_blocks(x, block_bytes=2 ** 20)
    old = fp.fingerprint_blocks(x, block_bytes=2 ** 20)
    fp.fingerprint_diff(x, old, block_bytes=2 ** 20)
    for name in ("fingerprint", "fingerprint_final"):
        assert _lib.LAUNCHES[name] == before[name] + 3, name
    assert fp.fingerprint_grid() >= 132
    # an empty tensor launches nothing
    empty = torch.zeros(0, device=cuda)
    got, diff = fp.fingerprint_diff(empty, torch.zeros(0, dtype=torch.int32,
                                                       device=cuda), block_bytes=64)
    assert got.numel() == 0 and diff.numel() == 0
    assert _lib.LAUNCHES["fingerprint"] == before["fingerprint"] + 3


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


def _absmax_edges():
    """(name, tensor on the CPU) at the first pass's edges: tiny tensors,
    one element either side of a whole trip of the resident grid, a view
    off the 16-byte boundary (the scalar path), a NaN in the scalar tail,
    an all-subnormal tensor."""
    grid, trip = qz.absmax_grid(torch.float32)
    _, trip16 = qz.absmax_grid(torch.bfloat16)
    assert grid >= 132 and trip == grid * 1024 * 4 * 4 and trip16 == 2 * trip
    big = payload(torch.float32, trip + 1)
    tail = payload(torch.float32, trip + 3)
    tail[-2] = float("nan")
    return [("n1", payload(torch.float32, 1)), ("n3", payload(torch.float32, 3)),
            ("trip_minus_1", big[:trip - 1]), ("trip", big[:trip]),
            ("trip_plus_1", big), ("bf16_trip_plus_1", payload(torch.bfloat16, trip16 + 1)),
            ("misaligned", big[1:]), ("nan_in_tail", tail),
            ("subnormal", torch.tensor([1e-40, -3e-39, 2e-45] * 1000))]


def test_absmax_at_the_grid_and_unroll_edges(cuda):
    for name, x in _absmax_edges():
        xc = x.to(cuda)
        if name == "misaligned":
            xc = xc.new_empty(x.numel() + 1)[1:].copy_(xc)
            assert xc.data_ptr() % 16
        got = qz.absmax(xc)[0]
        if name == "nan_in_tail":
            assert torch.isnan(got), name
            continue
        assert same_bits(got, qz.absmax_ref(x)), name
    x = torch.tensor([1e-40, -3e-39, 2e-45] * 1000)
    q, scale = qz.quantize_int8(x.to(cuda))
    hq, hscale = ser.quantize(x.numpy(), "int8", "float32")
    assert scale == hscale and scale != 1.0     # no flush of subnormals
    assert np.array_equal(q.cpu().numpy(), hq)


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


def _dequantize_edges(dtype):
    """(name, int8 payload on the CPU) at dequantize's edges: fewer values
    than one load, one either side of a 16-value row, one either side of a
    whole trip of the resident grid."""
    trip = qz.dequantize_layout(dtype)["values_per_trip"]
    big = payload(torch.int8, trip + 1).clamp_(-127, 127)
    return [(f"n{n}", big[:n]) for n in (1, 15, 16, 17)] + [
        ("trip_minus_1", big[:trip - 1]), ("trip", big[:trip]),
        ("trip_plus_1", big)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_dequantize_at_the_grid_and_load_edges(cuda, dtype):
    lay = qz.dequantize_layout(dtype)
    assert lay["ctas"] >= 132 and lay["values_per_load"] == 16 // dtype.itemsize
    scale = float(np.float32(0.0123))
    for name, q in _dequantize_edges(dtype):
        before = _lib.LAUNCHES["dequantize"]
        got = qz.dequantize_int8(q.to(cuda), scale, dtype=dtype)
        assert _lib.LAUNCHES["dequantize"] == before + 1, name
        assert same_bits(got, qz.dequantize_int8_ref(q, scale, dtype=dtype)), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_dequantize_misaligned_input_and_output(cuda, dtype):
    # the input a view 4 bytes into its buffer; the output written through
    # the library at one value past a 16-byte boundary (the wrapper always
    # allocates its output, so only a direct call reaches that path)
    scale = float(np.float32(0.37))
    q = payload(torch.int8, 70_001).clamp_(-127, 127)
    want = qz.dequantize_int8_ref(q, scale, dtype=dtype)
    qc = q.to(cuda)
    qv = qc.new_empty(q.numel() + 4)[4:].copy_(qc)
    assert qv.data_ptr() % 16 != 0
    assert same_bits(qz.dequantize_int8(qv, scale, dtype=dtype), want)
    buf = torch.empty(q.numel() + 1, dtype=dtype, device=cuda)
    out = buf[1:]
    assert out.data_ptr() % 16 != 0
    err = _lib.library().spot_dequantize(
        qc.data_ptr(), q.numel(), scale, _lib.DTYPE_CODES[dtype], out.data_ptr(),
        _lib.stream_ptr(cuda))
    _lib.check(err, "dequantize")
    torch.cuda.synchronize()
    assert same_bits(out, want)


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
    # Sq a multiple of 64 but not of 128: the tensor-core forward's last
    # 128-row tile is half filled
    (1, 192, 4, 1, 256, 0, torch.bfloat16),
    (2, 448, 32, 32, 96, 0, torch.bfloat16),      # phi3-mini's heads
    (1, 320, 4, 2, 64, 64, torch.bfloat16),
    # the TMA feed's zero fill: a padded sequence at hd 96 (columns 96-127
    # of each box arrive as zeros), a last 128-row tile whose second half
    # lies past the sequence (136 -> 192), and windows whose lower edge
    # falls inside a key tile
    (1, 200, 4, 2, 96, 0, torch.bfloat16),
    (2, 136, 4, 1, 128, 0, torch.bfloat16),
    (2, 320, 4, 2, 96, 100, torch.bfloat16),
    (1, 448, 2, 1, 256, 200, torch.bfloat16),
    # the zoo's head layouts: GQA groups of 6 (grok-1), 7 (llava-next) and
    # 12 (command-r-plus) at hd 128, and musicgen's 24 heads of 64 (MHA)
    *[(1, 256, H, 8, 128, 0, dt) for H in (48, 56, 96)
      for dt in (torch.bfloat16, torch.float32)],
    *[(2, 256, 24, 24, 64, 0, dt) for dt in (torch.bfloat16, torch.float32)],
    # the 3xTF32 float32 forward at every head dim: hd 96 (phi3-mini's heads,
    # a padded length, a window), hd 128 (GQA 4:1 with a window, a padded
    # length), hd 256 (gemma3's GQA 4:1 with its window, a window edge
    # inside a 32-key tile), hd 64 (a padded length, a window)
    (2, 448, 32, 32, 96, 0, torch.float32),
    (1, 200, 4, 2, 96, 0, torch.float32),
    (2, 320, 4, 2, 96, 100, torch.float32),
    (1, 320, 8, 2, 128, 64, torch.float32),
    (2, 136, 4, 1, 128, 0, torch.float32),
    (1, 1024, 4, 1, 256, 512, torch.float32),
    (1, 448, 2, 1, 256, 200, torch.float32),
    (1, 333, 4, 4, 64, 100, torch.float32),
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


@pytest.mark.parametrize("Sq,Skv,hd,dtype", [
    (128, 192, 64, torch.float32), (192, 128, 256, torch.bfloat16),
    (64, 320, 96, torch.bfloat16), (192, 128, 256, torch.float32),
    (64, 320, 96, torch.float32), (320, 64, 128, torch.float32)])
def test_flash_attention_kernel_non_causal_aligned(cuda, Sq, Skv, hd, dtype):
    q = randn((1, Sq, 2, hd), dtype, 1, cuda)
    k = randn((1, Skv, 1, hd), dtype, 2, cuda)
    o, lse = flash_attention_fwd(q, k, k, False, 0)
    want, want_lse = attention_ref(q, k, k, causal=False)
    atol, rtol = ATT_TOL[dtype]
    torch.testing.assert_close(o.float(), want.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=2e-5)


def test_bf16_forward_takes_views_off_a_16_byte_boundary(cuda):
    """The bf16 forward reads q, k and v through TMA tensor maps, whose base
    must be 16-byte aligned: views that start 4 bytes past a boundary (as
    the 4-byte operand check allows) are copied first."""
    B, S, H, KV, hd = 1, 192, 4, 2, 96
    n = B * S * H * hd
    q = randn((n + 2,), torch.bfloat16, 31, cuda)[2:].view(B, S, H, hd)
    kv = randn((2 * B * S * KV * hd + 2,), torch.bfloat16, 32, cuda)[2:]
    k, v = kv.view(2, B, S, KV, hd).unbind(0)
    assert q.data_ptr() % 16 and k.data_ptr() % 16 and q.is_contiguous()
    o, lse = flash_attention_fwd(q, k, v, True, 0)
    want, want_lse = attention_ref(q, k, v, causal=True)
    atol, rtol = ATT_TOL[torch.bfloat16]
    torch.testing.assert_close(o.float(), want.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=2e-5)


def test_float32_forward_takes_views_off_a_16_byte_boundary(cuda):
    """The float32 forward copies its q, k and v tiles 16 bytes at a time
    (cp.async): views that start 4 bytes past a boundary are copied
    first."""
    B, S, H, KV, hd = 1, 192, 4, 2, 128
    n = B * S * H * hd
    q = randn((n + 1,), torch.float32, 33, cuda)[1:].view(B, S, H, hd)
    kv = randn((2 * B * S * KV * hd + 1,), torch.float32, 34, cuda)[1:]
    k, v = kv.view(2, B, S, KV, hd).unbind(0)
    assert q.data_ptr() % 16 and k.data_ptr() % 16 and q.is_contiguous()
    o, lse = flash_attention_fwd(q, k, v, True, 64)
    want, want_lse = attention_ref(q, k, v, causal=True, window=64)
    torch.testing.assert_close(o, want, atol=2e-5, rtol=0.0)
    torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_forward_is_deterministic(cuda, dtype):
    q = randn((2, 320, 4, 256), dtype, 5, cuda)
    k, v = (randn((2, 320, 1, 256), dtype, s, cuda) for s in (6, 7))
    first = flash_attention_fwd(q, k, v, True, 0)
    again = flash_attention_fwd(q, k, v, True, 0)
    assert all(same_bits(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernels_route_by_dtype(cuda, dtype):
    """bf16 runs the forward, the dkv and the dq pass on the tensor cores
    through wgmma; float32 runs all three on the tensor cores in 3xTF32;
    every launch also counts under its pass."""
    q, do = (randn((1, 128, 4, 128), dtype, s, cuda) for s in (1, 2))
    k, v = (randn((1, 128, 1, 128), dtype, s, cuda) for s in (3, 4))
    before = dict(_lib.LAUNCHES)
    o, lse = flash_attention_fwd(q, k, v, True, 0)
    flash_attention_bwd(q, k, v, o, lse, do, True, 0)
    torch.cuda.synchronize()
    other_dtype = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    for p, variant in VARIANTS[dtype].items():
        other = VARIANTS[other_dtype][p]
        name = f"flash_attention_{p}"
        assert _lib.LAUNCHES[name] == before[name] + 1
        assert _lib.LAUNCHES[f"{name}_{variant}"] == before[f"{name}_{variant}"] + 1
        assert _lib.LAUNCHES[f"{name}_{other}"] == before[f"{name}_{other}"]


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
    # phi3-mini's heads: 32 of 96 (three columns a lane), MHA
    (2, 32, 32, 96, 2048, 1, torch.bfloat16),
    (2, 32, 32, 96, 2048, 1000, torch.bfloat16),
    (2, 32, 32, 96, 2048, 2048, torch.bfloat16),
    (2, 32, 32, 96, 333, 1, torch.float32),
    (2, 32, 32, 96, 333, 170, torch.float32),
    (2, 32, 32, 96, 333, 333, torch.float32),
    # the split kernel's edges at the served shapes (batch 4): valid_len
    # at 1, tile - 1, tile, tile + 1 (32 keys at hd 256, 64 at hd 96); at
    # gemma3's and recurrentgemma's shapes every tile is a split up to
    # 2112 rows, past that splits of two tiles: 2175 / 2176 / 2177 leave
    # the last split one key short, full, and one key; at phi3-mini's,
    # 129 (splits of 128 keys) leaves one key in the last split, 2047 /
    # 2048 (splits of 1024) one short and full; S a multiple of no tile
    *[(4, 4, 1, 256, 2048, vl, torch.bfloat16) for vl in (1, 31, 32, 33, 2000)],
    *[(4, 4, 1, 256, 2048, vl, torch.float32) for vl in (33, 2000)],
    *[(4, 4, 1, 256, 2200, vl, torch.bfloat16) for vl in (2175, 2176, 2177)],
    (4, 4, 1, 256, 2200, 2177, torch.float32),
    (4, 4, 1, 256, 2001, 2001, torch.bfloat16),
    *[(4, 10, 1, 256, 2048, vl, torch.bfloat16) for vl in (1, 33, 1985, 2048)],
    (4, 10, 1, 256, 2048, 1985, torch.float32),
    (4, 10, 1, 256, 2200, 2177, torch.bfloat16),
    *[(4, 32, 32, 96, 2048, vl, torch.bfloat16)
      for vl in (1, 63, 64, 65, 129, 2047, 2048)],
    *[(4, 32, 32, 96, 2048, vl, torch.float32) for vl in (65, 129, 2047)],
    (4, 32, 32, 96, 2001, 2001, torch.float32),
    # the zoo's head layouts at the served shapes: GQA groups of 6, 7 and
    # 12 at hd 128, and 24 heads of 64 (MHA)
    *[(4, H, 8, 128, 2048, vl, torch.bfloat16) for H in (48, 56, 96)
      for vl in (1, 65, 1985, 2048)],
    *[(4, H, 8, 128, 2001, 2001, torch.float32) for H in (48, 56, 96)],
    *[(4, 24, 24, 64, 2048, vl, torch.bfloat16) for vl in (1, 65, 1985, 2048)],
    (4, 24, 24, 64, 2001, 2001, torch.float32),
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


def test_flash_decode_repeats_bit_for_bit(cuda):
    """The split count depends on the shapes and valid_len alone and the
    merge sums the splits in order: two calls give the same bits."""
    for B, H, KV, hd, S, vl, dtype in ((4, 4, 1, 256, 2048, 2000, torch.bfloat16),
                                       (4, 10, 1, 256, 2048, 1985, torch.bfloat16),
                                       (4, 32, 32, 96, 2048, 2048, torch.bfloat16),
                                       (4, 32, 32, 96, 2048, 1000, torch.float32)):
        q = randn((B, H, hd), dtype, 1, cuda)
        k, v = (randn((B, S, KV, hd), dtype, s, cuda) for s in (2, 3))
        assert same_bits(flash_decode(q, k, v, vl), flash_decode(q, k, v, vl))


def test_flash_decode_counts_its_split_and_merge_launches(cuda):
    q = randn((4, 4, 256), torch.bfloat16, 1, cuda)
    k, v = (randn((4, 512, 1, 256), torch.bfloat16, s, cuda) for s in (2, 3))
    before = dict(_lib.LAUNCHES)
    flash_decode(q, k, v, 500)
    assert _lib.LAUNCHES["decode_attention"] == before["decode_attention"] + 1
    assert (_lib.LAUNCHES["decode_attention_merge"]
            == before["decode_attention_merge"] + 1)
    ws = decode_partials(q, k, v, 500)
    assert _lib.LAUNCHES["decode_attention"] == before["decode_attention"] + 2
    assert (_lib.LAUNCHES["decode_attention_merge"]
            == before["decode_attention_merge"] + 1)
    decode_merge(ws, torch.bfloat16)
    assert (_lib.LAUNCHES["decode_attention_merge"]
            == before["decode_attention_merge"] + 2)


@pytest.mark.parametrize("B,H,KV,hd,S,vl", [(4, 4, 1, 256, 2048, 2000),
                                             (4, 10, 1, 256, 2048, 1985),
                                             (4, 32, 32, 96, 2048, 2048),
                                             (2, 8, 2, 128, 333, 257)])
def test_decode_merge_kernel_matches_plain(cuda, B, H, KV, hd, S, vl):
    """The merge kernel alone, on the split kernel's partials, against
    decode_merge_ref: the same sums in the same order, to 2e-5 in float32
    and one bf16 ulp (+ 2e-5) in bfloat16."""
    q = randn((B, H, hd), torch.bfloat16, 1, cuda)
    k, v = (randn((B, S, KV, hd), torch.bfloat16, s, cuda) for s in (2, 3))
    ws = decode_partials(q, k, v, vl)
    assert ws.shape == (B, H, decode_splits(B, KV, hd, vl)[0], hd + 2)
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = ATT_TOL[dtype]
        torch.testing.assert_close(decode_merge(ws, dtype).float(),
                                   decode_merge_ref(ws, dtype).float(),
                                   atol=atol, rtol=rtol)


def test_flash_decode_refuses_a_group_over_sixteen_heads(cuda):
    q = torch.zeros(1, 17, 64, device=cuda)
    k = torch.zeros(1, 8, 1, 64, device=cuda)
    with pytest.raises(ValueError, match="query heads per KV head"):
        flash_decode(q, k, k, 8)


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
    # B, S, W, dtype, offset: the view starts `offset` values into its
    # buffer (4 bytes: contiguous, off the 16-byte boundary). The kernel
    # stages 64 steps a chunk, 32 float32 or 64 bf16 channels a CTA.
    (2, 128, 256, torch.float32, 0),
    (4, 1984, 2560, torch.float32, 0),
    (3, 77, 200, torch.float32, 0),               # W a multiple of no block
    (1, 128, 256, torch.bfloat16, 0),
    (2, 1, 256, torch.float32, 0),                # one step
    (2, 63, 256, torch.float32, 0),               # a chunk less one step
    (2, 64, 256, torch.float32, 0),               # one whole chunk
    (2, 65, 256, torch.float32, 0),               # a chunk and one step
    (2, 65, 256, torch.bfloat16, 0),
    (2, 130, 201, torch.float32, 0),              # rows off 16-byte copies
    (2, 130, 201, torch.bfloat16, 0),
    (3, 70, 20, torch.float32, 0),                # W under one CTA's channels
    (3, 70, 40, torch.bfloat16, 0),
    (1, 1984, 2560, torch.float32, 0),            # B = 1 at recurrentgemma's
    (4, 1984, 2560, torch.bfloat16, 0),           # bf16 at recurrentgemma's
    (2, 100, 256, torch.float32, 1),              # misaligned contiguous views
    (2, 100, 256, torch.bfloat16, 2),
]


@pytest.mark.parametrize("B,S,W,dtype,offset", RGLRU_GPU_CASES)
def test_rglru_scan_kernel_matches_plain_bit_for_bit(cuda, B, S, W, dtype, offset):
    n = B * S * W

    def view(x):
        buf = torch.empty(n + offset, dtype=dtype, device=cuda)
        out = buf[offset:].view(B, S, W).copy_(x)
        assert out.is_contiguous() and (out.data_ptr() % 16 != 0) == (offset > 0)
        return out

    a = view(torch.sigmoid(randn((B, S, W), torch.float32, S, cuda)).to(dtype))
    b = view(randn((B, S, W), dtype, S + 1, cuda))
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


GRAD_TOL = 2e-4          # of max(1, max|plain|): 10 x the forward's 2e-5
BF16_ULP = 2 ** -7       # one bf16 ulp, relative


def assert_grad_close(got, want, what=""):
    """float32: max|err| <= GRAD_TOL * max(1, max|want|); bfloat16: within
    two bf16 ulps of each element plus that float32 limit."""
    assert got.dtype == want.dtype and got.shape == want.shape, what
    g, w = got.double(), want.double()
    lim = GRAD_TOL * max(1.0, float(w.abs().max()))
    err = (g - w).abs()
    if got.dtype == torch.bfloat16:
        lim = lim + 2 * BF16_ULP * w.abs()
    assert bool((err <= lim).all()), (what, float(err.max()))


FLASH_BWD_GPU_CASES = [
    # B, S, H, KV, hd, window, dtype
    (2, 256, 4, 1, 256, 0, torch.bfloat16),       # gemma3's heads, global
    (2, 320, 4, 1, 256, 100, torch.bfloat16),     # window
    (1, 192, 4, 2, 256, 0, torch.float32),        # GQA, 32-row tiles
    (2, 128, 32, 32, 96, 0, torch.bfloat16),      # phi3-mini's heads
    (1, 200, 4, 4, 96, 0, torch.float32),         # padding path: 200 -> 256
    (1, 77, 4, 2, 128, 16, torch.float32),        # padding path, window
    (2, 256, 8, 2, 64, 64, torch.float32),        # GQA, window
    (1, 128, 8, 4, 128, 0, torch.bfloat16),
    (1, 1024, 4, 1, 256, 512, torch.float32),     # gemma3's local layers
]


@pytest.mark.parametrize("B,S,H,KV,hd,window,dtype", FLASH_BWD_GPU_CASES)
def test_flash_attention_backward_kernels_match_plain(cuda, B, S, H, KV, hd,
                                                      window, dtype):
    q = randn((B, S, H, hd), dtype, 3 * S + hd, cuda)
    k = randn((B, S, KV, hd), dtype, 3 * S + hd + 1, cuda)
    v = randn((B, S, KV, hd), dtype, 3 * S + hd + 2, cuda)
    do = randn((B, S, H, hd), dtype, 3 * S + hd + 3, cuda)
    o, lse = flash_attention_fwd(q, k, v, True, window)
    before = dict(_lib.LAUNCHES)
    got = flash_attention_bwd(q, k, v, o, lse, do, True, window)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["flash_attention_dkv"] == before["flash_attention_dkv"] + 1
    assert _lib.LAUNCHES["flash_attention_dq"] == before["flash_attention_dq"] + 1
    want = attention_bwd_ref(q, k, v, o, lse, do, causal=True, window=window)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert_grad_close(g, w, name)


@pytest.mark.parametrize("hd,window,dtype", [
    (256, 0, torch.float32), (96, 0, torch.float32), (64, 32, torch.float32),
    # the tensor-core dkv pass on its own
    (64, 0, torch.bfloat16), (96, 0, torch.bfloat16), (128, 0, torch.bfloat16),
    (256, 0, torch.bfloat16), (64, 32, torch.bfloat16),
    (96, 100, torch.bfloat16), (128, 64, torch.bfloat16),
    (256, 100, torch.bfloat16), (96, 32, torch.bfloat16),
    (256, 64, torch.bfloat16)])
def test_flash_attention_backward_passes_match_their_plain_versions(cuda, hd,
                                                                    window,
                                                                    dtype):
    """Each pass alone on block-aligned operands: dk, dv per query head in
    float32, dq in q's dtype."""
    B, S, H, KV = 2, 192, 4, 2
    q = randn((B, S, H, hd), dtype, hd, cuda)
    k = randn((B, S, KV, hd), dtype, hd + 1, cuda)
    v = randn((B, S, KV, hd), dtype, hd + 2, cuda)
    do = randn((B, S, H, hd), dtype, hd + 3, cuda)
    o, lse = flash_attention_fwd(q, k, v, True, window)
    dsum = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dk, dv = flash_attention_dkv(q, k, v, do, lse, dsum, True, window)
    wk, wv = attention_dkv_ref(q, k, v, do, lse, dsum, causal=True,
                               window=window)
    assert dk.shape == (B, S, H, hd) and dk.dtype == torch.float32
    assert_grad_close(dk, wk, "dk")
    assert_grad_close(dv, wv, "dv")
    assert_grad_close(flash_attention_dq(q, k, v, do, lse, dsum, True, window),
                      attention_dq_ref(q, k, v, do, lse, dsum, causal=True,
                                       window=window), "dq")


def test_flash_attention_backward_is_deterministic(cuda):
    B, S, H, KV, hd = 2, 256, 4, 1, 256
    q, k, v = (randn((B, S, n, hd), torch.bfloat16, n, cuda) for n in (H, KV, KV))
    do = randn((B, S, H, hd), torch.bfloat16, 9, cuda)
    o, lse = flash_attention_fwd(q, k, v, True, 64)
    first = flash_attention_bwd(q, k, v, o, lse, do, True, 64)
    again = flash_attention_bwd(q, k, v, o, lse, do, True, 64)
    assert all(same_bits(a, b) for a, b in zip(first, again))


def test_bf16_forward_and_dq_repeat_bit_for_bit(cuda):
    """The TMA-fed forward and the tensor-core dq pass, 20 runs each: a
    stage read before its loads landed, or refilled while a warpgroup still
    read it, would show as a rare wrong tile."""
    B, S, H, KV, hd = 2, 448, 4, 1, 256
    q, do = (randn((B, S, H, hd), torch.bfloat16, s, cuda) for s in (21, 22))
    k, v = (randn((B, S, KV, hd), torch.bfloat16, s, cuda) for s in (23, 24))
    for window in (0, 200):
        o, lse = flash_attention_fwd(q, k, v, True, window)
        dsum = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        dq = flash_attention_dq(q, k, v, do, lse, dsum, True, window)
        for _ in range(20):
            o2, lse2 = flash_attention_fwd(q, k, v, True, window)
            dq2 = flash_attention_dq(q, k, v, do, lse, dsum, True, window)
            assert same_bits(o, o2) and same_bits(lse, lse2), window
            assert same_bits(dq, dq2), window


def test_float32_dkv_and_dq_repeat_bit_for_bit(cuda):
    """The 3xTF32 dkv and dq passes, 20 runs each: a stage of the cp.async
    ring read before its copies landed, or refilled while a warp still read
    it, or P / dS read before the warps that share the rows wrote them,
    would show as a rare wrong tile."""
    B, S, H, KV, hd = 2, 448, 4, 1, 256
    q, do = (randn((B, S, H, hd), torch.float32, s, cuda) for s in (25, 26))
    k, v = (randn((B, S, KV, hd), torch.float32, s, cuda) for s in (27, 28))
    for window in (0, 200):
        o, lse = flash_attention_fwd(q, k, v, True, window)
        dsum = (do * o).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, lse, dsum, True, window)
        dk, dv = flash_attention_dkv(*args)
        dq = flash_attention_dq(*args)
        for _ in range(20):
            dk2, dv2 = flash_attention_dkv(*args)
            assert same_bits(dk, dk2) and same_bits(dv, dv2), window
            assert same_bits(dq, flash_attention_dq(*args)), window


@pytest.mark.parametrize("Sq,Skv,hd", [(128, 192, 64), (192, 128, 256),
                                       (64, 320, 96)])
def test_float32_backward_non_causal_aligned(cuda, Sq, Skv, hd):
    """Cross attention (no mask, Sq != Skv): every q tile sees every key
    tile."""
    q, do = (randn((1, Sq, 4, hd), torch.float32, s, cuda) for s in (1, 2))
    k, v = (randn((1, Skv, 2, hd), torch.float32, s, cuda) for s in (3, 4))
    o, lse = flash_attention_fwd(q, k, v, False, 0)
    got = flash_attention_bwd(q, k, v, o, lse, do, False, 0)
    want = attention_bwd_ref(q, k, v, o, lse, do, causal=False)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert_grad_close(g, w, name)


def test_float32_backward_takes_views_off_a_16_byte_boundary(cuda):
    """The backward passes copy their tiles 16 bytes at a time: views that
    start 4 bytes past a boundary (as the 4-byte operand check allows) are
    copied first."""
    B, S, H, KV, hd = 1, 192, 4, 2, 96
    n, m = B * S * H * hd, B * S * KV * hd
    qo = randn((2 * n + 1,), torch.float32, 41, cuda)[1:]
    q, do = qo.view(2, B, S, H, hd).unbind(0)
    kv = randn((2 * m + 1,), torch.float32, 42, cuda)[1:]
    k, v = kv.view(2, B, S, KV, hd).unbind(0)
    assert q.data_ptr() % 16 and k.data_ptr() % 16 and q.is_contiguous()
    o, lse = flash_attention_fwd(q, k, v, True, 0)
    got = flash_attention_bwd(q, k, v, o, lse, do, True, 0)
    want = attention_bwd_ref(q, k, v, o, lse, do, causal=True)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert_grad_close(g, w, name)


def test_flash_attention_grads_run_through_the_kernels(cuda):
    B, S, H, KV, hd = 1, 128, 4, 1, 256
    q = randn((B, S, H, hd), torch.float32, 1, cuda).requires_grad_(True)
    k = randn((B, S, KV, hd), torch.float32, 2, cuda).requires_grad_(True)
    v = randn((B, S, KV, hd), torch.float32, 3, cuda).requires_grad_(True)
    before = dict(_lib.LAUNCHES)
    out = flash_attention(q, k, v, True, 32)
    grads = torch.autograd.grad(torch.sin(out).sum(), (q, k, v))
    for name in ("flash_attention_fwd", "flash_attention_dkv",
                 "flash_attention_dq"):
        assert _lib.LAUNCHES[name] == before[name] + 1, name
    q2, k2, v2 = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    want = torch.autograd.grad(
        torch.sin(attention_ref(q2, k2, v2, causal=True, window=32)[0]).sum(),
        (q2, k2, v2))
    for g, w, name in zip(grads, want, ("dq", "dk", "dv")):
        assert_grad_close(g, w, name)


SSM_GPU_CASES = [
    # B, S, DI, dtype; a staged chunk is 64 steps in bf16, 32 in float32,
    # a CTA 64 channels
    (2, 128, 256, torch.float32),
    (1, 200, 96, torch.float32),                  # DI a multiple of no CTA
    (4, 1984, 8192, torch.bfloat16),              # falcon-mamba's prefill
    (2, 65, 128, torch.bfloat16),                 # one step past a chunk
    (1, 1, 256, torch.float32),                   # S = 1
    (3, 1, 64, torch.bfloat16),
    (2, 10, 128, torch.bfloat16),                 # shorter than a chunk
    (2, 33, 96, torch.float32),                   # one step past a chunk
    (1, 200, 8192, torch.bfloat16),               # B = 1 at falcon-mamba's width
    (2, 70, 104, torch.bfloat16),                 # a CTA of 40 channels at the edge
    (1, 50, 100, torch.float32),                  # 36 channels at the edge
    (1, 40, 72, torch.float32),                   # 8 channels at the edge
    (2, 40, 36, torch.bfloat16),                  # rows off a 16-byte boundary
]


def ssm_inputs(B, S, DI, dtype, device, N=16, a_scale=1.0):
    g = torch.Generator().manual_seed(S * DI + B)
    u = torch.randn((B, S, DI), generator=g).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((B, S, DI), generator=g) - 2.0).to(dtype)
    A = -torch.exp(torch.randn((DI, N), generator=g) * 0.3) * a_scale
    Bm = torch.randn((B, S, N), generator=g).to(dtype)
    Cm = torch.randn((B, S, N), generator=g).to(dtype)
    D = torch.full((DI,), 0.5)
    return [t.to(device) for t in (u, dt, A, Bm, Cm, D)]


def assert_scan_close(y, h, yr, hr, dtype):
    assert y.dtype == dtype and h.dtype == torch.float32
    if dtype == torch.float32:
        torch.testing.assert_close(y, yr, atol=1e-4, rtol=0)
        torch.testing.assert_close(h, hr, atol=1e-4, rtol=0)
    else:
        torch.testing.assert_close(y.float(), yr.float(), atol=1e-4,
                                   rtol=BF16_ULP)
        assert float((h - hr).abs().max()) <= 1e-4 * max(1.0, float(hr.abs().max()))


@pytest.mark.parametrize("B,S,DI,dtype", SSM_GPU_CASES)
def test_ssm_scan_kernel_matches_plain(cuda, B, S, DI, dtype):
    args = ssm_inputs(B, S, DI, dtype, cuda)
    before = dict(_lib.LAUNCHES)
    y, h = ssm_scan(*args)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["ssm_scan"] == before["ssm_scan"] + 1
    name = "ssm_scan_bf16" if dtype == torch.bfloat16 else "ssm_scan_f32"
    assert _lib.LAUNCHES[name] == before[name] + 1
    assert_scan_close(y, h, *ssm_scan_ref(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_scan_where_exp_underflows(cuda, dtype):
    # A of -1000 and more: exp(dt * A) underflows to 0 on most steps
    args = ssm_inputs(2, 100, 64, dtype, cuda, a_scale=1000.0)
    assert float(torch.exp(args[1].float()[..., None] * args[2]).min()) == 0.0
    assert_scan_close(*ssm_scan(*args), *ssm_scan_ref(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_scan_reads_b_and_c_in_place(cuda, dtype):
    """B and C as views into one projection output (the model's layout,
    rows 2 N + 8 values apart), and float32 B and C beside bf16 u."""
    u, dt, A, Bm, Cm, D = ssm_inputs(2, 150, 256, dtype, cuda)
    for lead in (8, 1):                  # 16-byte copies; element copies
        proj = torch.randn((2, 150, lead + 32), device=cuda).to(dtype)
        Bv, Cv = proj[..., lead:lead + 16], proj[..., lead + 16:]
        assert not Bv.is_contiguous()
        want = ssm_scan_ref(u, dt, A, Bv, Cv, D)
        assert_scan_close(*ssm_scan(u, dt, A, Bv, Cv, D), *want, dtype)
    assert_scan_close(*ssm_scan(u, dt, A, Bm.float(), Cm.float(), D),
                      *ssm_scan_ref(u, dt, A, Bm.float(), Cm.float(), D), dtype)


def test_ssm_scan_repeats_bit_for_bit(cuda):
    args = ssm_inputs(2, 300, 512, torch.bfloat16, cuda)
    y1, h1 = ssm_scan(*args)
    y2, h2 = ssm_scan(*args)
    assert same_bits(y1, y2) and same_bits(h1, h2)


def test_selective_scan_grads_through_the_plain_version(cuda):
    args = [t.requires_grad_(True) for t in ssm_inputs(1, 32, 64, torch.float32, cuda)]
    before = _lib.LAUNCHES["ssm_scan"]
    y = selective_scan(*args)
    assert _lib.LAUNCHES["ssm_scan"] == before + 1
    grads = torch.autograd.grad(y.sum(), args)
    ref = [t.detach().clone().requires_grad_(True) for t in args]
    want = torch.autograd.grad(ssm_scan_ref(*ref)[0].sum(), ref)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


def test_backward_and_scan_kernels_refuse_bad_operands(cuda):
    q = torch.zeros(1, 64, 2, 48, device=cuda)
    lse = torch.zeros(1, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_dkv(q, q[:, :, :1], q[:, :, :1], q, lse, lse)
    q = torch.zeros(1, 40, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="multiples"):
        flash_attention_dq(q, q[:, :, :1].contiguous(), q[:, :, :1].contiguous(),
                           q, lse[..., :40].contiguous(), lse[..., :40].contiguous())
    args = ssm_inputs(1, 8, 32, torch.float32, cuda, N=8)
    with pytest.raises(ValueError, match="d_state"):
        ssm_scan(*args)
    args = ssm_inputs(1, 8, 32, torch.float16, cuda)
    with pytest.raises(TypeError, match="dtype"):
        ssm_scan(*args)


# ---------------------------------------------------------------------------
# the MoE layer on the card (plain PyTorch around the attention kernels)
# ---------------------------------------------------------------------------

@pytest.fixture
def deterministic(cuda):
    """set_deterministic() for one test, the previous settings restored."""
    from repro_torch.device import set_deterministic
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    set_deterministic()
    try:
        yield cuda
    finally:
        torch.use_deterministic_algorithms(before[0])
        torch.backends.cuda.matmul.allow_tf32 = before[1]
        torch.backends.cudnn.allow_tf32 = before[2]


def test_moe_blocks_on_the_card_match_the_host(deterministic):
    """moe_block (routed, with capacity drops) and moe_block_dense at
    deepseek-moe-16b's width (d_model 2048, 64 experts of 1408, top-6, 2
    shared), a few tokens, float32: the card against the same function on
    the host, to 1e-4 of the output's largest element (float32 sums of
    2048 and 1408 terms in another order); the aux loss to 1e-5
    relative."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config("deepseek_moe_16b")
    m, D, E, Fe = cfg.moe, cfg.d_model, cfg.moe.n_experts, cfg.moe.d_expert
    g = torch.Generator(device=deterministic).manual_seed(0)

    def w(*shape, fan_in):
        return torch.randn(shape, generator=g, device=deterministic) / fan_in ** 0.5
    wd = {"router": w(D, E, fan_in=D),
          "experts": {"up": w(E, D, Fe, fan_in=D), "gate": w(E, D, Fe, fan_in=D),
                      "down": w(E, Fe, D, fan_in=Fe)},
          "shared": {"up": w(D, 2 * Fe, fan_in=D), "gate": w(D, 2 * Fe, fan_in=D),
                     "down": w(2 * Fe, D, fan_in=2 * Fe)}}
    wh = {k: ({n: t.cpu() for n, t in v.items()} if isinstance(v, dict)
              else v.cpu()) for k, v in wd.items()}
    x = w(2, 6, D, fan_in=1)
    y, aux = moe.moe_block(x, wd, m, act="silu", gated=True)
    yh, auxh = moe.moe_block(x.cpu(), wh, m, act="silu", gated=True)
    slot, _, _, C = moe.top_k_routing(
        (x.cpu().reshape(1, 12, D) @ wh["router"]), m)
    assert bool((slot == E * C).any()), "no pair overflowed: no drop tested"
    scale = float(yh.abs().max())
    assert float((y.cpu() - yh).abs().max()) <= 1e-4 * scale
    torch.testing.assert_close(aux.cpu(), auxh, rtol=1e-5, atol=0)
    yd = moe.moe_block_dense(x[:, :1], wd, m, act="silu", gated=True)
    ydh = moe.moe_block_dense(x[:, :1].cpu(), wh, m, act="silu", gated=True)
    assert float((yd.cpu() - ydh).abs().max()) <= 1e-4 * float(ydh.abs().max())


def test_moe_train_steps_repeat_bit_for_bit(deterministic):
    """Two bf16 train steps of a small deepseek-shaped MoE model (a dense
    prelude, one MoE layer, hd 64 through the flash kernels, the factored
    second moment) give the same state and metrics, bit for bit, when run
    again from the same state: the routing's sort, gathers and their
    scatter-add backward are deterministic on the card."""
    from repro_torch.checkpoint import serialize as ser
    from repro_torch.configs import get_config
    from repro_torch.models import MoEConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_train_state, make_train_step
    cfg = get_config("deepseek_moe_16b").scaled(
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
        vocab_size=1024,
        moe=MoEConfig(n_experts=16, top_k=4, d_expert=128, n_shared=1,
                      dense_prelude_layers=1, d_ff_prelude=512))
    opt = AdamWConfig(factored_second_moment=True, total_steps=4,
                      warmup_steps=1)
    step = make_train_step(cfg, opt)
    g = torch.Generator(device=deterministic).manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (2, 2, 257), generator=g,
                        device=deterministic, dtype=torch.int32)

    def run():
        state = init_train_state(cfg, opt, seed=0, device=deterministic)
        before = _lib.LAUNCHES["flash_attention_dq"]
        out = []
        for i in range(2):
            state, metrics = step(state, {"inputs": tok[i, :, :-1],
                                          "labels": tok[i, :, 1:]})
            out.append(metrics)
        assert _lib.LAUNCHES["flash_attention_dq"] == before + 4
        return state, out
    s1, m1 = run()
    s2, m2 = run()
    assert float(m1[-1]["aux"]) > 0
    for a, b in zip(m1, m2):
        for k in ("loss", "ce", "aux", "grad_norm"):
            assert same_bits(a[k], b[k]), k
    f1, f2 = ser.flatten_state(s1), ser.flatten_state(s2)
    assert any(n.endswith("/row") for n in f1)
    for n in f1:
        assert same_bits(f1[n], f2[n]), n


# -- the urgent save on the card: device chunk digests, legs ----------------

DIGEST_GPU_CASES = [
    (torch.float32, 3 * CHUNK // 4 + 17, 1 << 20),
    (torch.bfloat16, 2 * CHUNK + 1, 4096),
    (torch.int8, 5 * CHUNK + 333, 64),
    (torch.int32, 1, 64),
    (torch.float32, 0, 4096),
    (torch.float32, (1 << 18) + 3, 1 << 20),    # a short last chunk
]


@pytest.mark.parametrize("dtype,n,chunk", DIGEST_GPU_CASES)
def test_chunk_digest_kernel_matches_hashlib_and_zlib(cuda, dtype, n, chunk):
    from repro_torch.kernels.chunk_digest import (chunk_digests,
                                                  chunk_digests_ref)
    x = payload(dtype, n)
    before = _lib.LAUNCHES["chunk_digest"]
    got = chunk_digests([x.to(cuda)], chunk).result()
    assert got == [chunk_digests_ref(x, chunk)]
    assert _lib.LAUNCHES["chunk_digest"] == before + (1 if n else 0)


def test_chunk_digest_kernel_one_launch_for_many_leaves(cuda):
    from repro_torch.kernels.chunk_digest import (chunk_digests,
                                                  chunk_digests_ref)
    xs = [payload(dt, n, seed=i) for i, (dt, n, _c) in enumerate(DIGEST_GPU_CASES)]
    before = _lib.LAUNCHES["chunk_digest"]
    got = chunk_digests([x.to(cuda) for x in xs], 4096).result()
    assert got == [chunk_digests_ref(x, 4096) for x in xs]
    assert _lib.LAUNCHES["chunk_digest"] == before + 1


def test_chunk_digest_refuses_a_misaligned_view(cuda):
    from repro_torch.kernels.chunk_digest import chunk_digests
    x = torch.zeros(1025, dtype=torch.int8, device=cuda)[1:]
    with pytest.raises(ValueError):
        chunk_digests([x], 64)


def _card_state(cuda, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(1536, 1024, generator=g).to(
                           torch.bfloat16).to(cuda),
                       "b": torch.randn(4099, generator=g).to(cuda)},
            "opt": {"mu": {"w": torch.randn(1536, 1024, generator=g).to(cuda)}},
            "step": 3}


def _flat(state):
    return ser.flatten_state(state)


def test_urgent_save_digests_on_the_card_and_its_legs_sum(cuda, tmp_path):
    """An urgent save of a card state: its chunks' addresses come from the
    digest kernel, the pool's files hash to them, the restore is bitwise,
    and the legs partition the save's wall time."""
    import hashlib
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.core import (CheckpointPolicy, Signal,
                                  SimulatedMetadataService, SpotOnCoordinator,
                                  TimeModel, VirtualClock)
    from repro_torch.core.coordinator import URGENT_WALL_LEGS
    from repro_torch.train import state_template_on_device
    clock = VirtualClock()
    store = CheckpointStore(str(tmp_path), time_fn=clock.now, compress=False)
    coord = SpotOnCoordinator(store, CheckpointPolicy.transparent(1e9), clock,
                              time_model=TimeModel())
    md = SimulatedMetadataService(clock, "vm-0")
    coord.attach_instance(md, "vm-0")
    state = _card_state(cuda)
    md.simulate_eviction()
    clock.advance(1.0)
    before = _lib.LAUNCHES["chunk_digest"]
    assert coord.on_step_end(3, lambda: state) is Signal.PREEMPTING
    assert _lib.LAUNCHES["chunk_digest"] == before + 1
    legs = coord.last_urgent_legs
    coord.close()
    assert legs["other_s"] >= 0
    assert sum(legs[k] for k in URGENT_WALL_LEGS) + legs["other_s"] == \
        pytest.approx(legs["wall_s"], rel=1e-9, abs=1e-9)
    assert legs["hash_busy_s"] < legs["chunks_s"]
    for h, path in store.pool.all_chunks():
        with open(path, "rb") as f:
            assert hashlib.sha1(f.read()).hexdigest() == h
    got, man = store.restore(state_template_on_device(state, cuda))
    assert man.kind == "termination"
    for n, t in _flat(state).items():
        assert same_bits(_flat(got)[n], t) if isinstance(t, torch.Tensor) \
            else _flat(got)[n] == t


def test_urgent_save_digests_every_card_leaf_it_keeps_raw(cuda, tmp_path):
    """A transposed and a misaligned leaf are digested by the kernel too
    (from the contiguous tensor the copy reads; the misaligned one cloned),
    the moments a quantize-moments store compresses are not, the staging
    set is the leaves' copy sizes, and every pool file hashes to its name."""
    import hashlib
    from repro_torch.checkpoint import CheckpointStore, sharded
    store = CheckpointStore(str(tmp_path), chunk_size=CHUNK,
                            quantize_moments=True)
    g = torch.Generator().manual_seed(5)
    base = torch.randn(3 * CHUNK + 1, generator=g).to(torch.bfloat16)
    state = {"params": {"t": torch.randn(384, 256, generator=g).to(cuda).t(),
                        "m": base.to(cuda)[1:]},     # 2 bytes off the 4
             "opt": {"mu": {"w": torch.randn(256, 512, generator=g).to(cuda)}},
             "step": 1}
    assert state["params"]["m"].data_ptr() % 4 == 2
    assert sorted(sharded.urgent_staging_sizes(state, quantize_moments=True)) \
        == sorted([384 * 256 * 4, 3 * CHUNK * 2, 256 * 512])
    before = _lib.LAUNCHES["chunk_digest"]
    snap = sharded.extract_snapshot(
        sharded.prestage(state, skip=ser.is_moment_name), step=1,
        on_device_quantize=ser.is_moment_name,
        digest_chunk=store.urgent_digest_chunk)
    assert _lib.LAUNCHES["chunk_digest"] == before + 1
    for n, lp in snap.leaves.items():
        t = _flat(state)[n]
        if lp.prequant:                 # the copy read the int8 payload
            t = torch.empty(t.shape, dtype=torch.int8, device=cuda)
        raw = isinstance(t, torch.Tensor) and \
            store.urgent_digest_chunk(n, t) is not None
        assert (lp.digests is not None) == raw, n
    if not ser.HAVE_ZSTD:       # float payloads stay raw, int8 ones zlib
        assert snap.leaves["params/t"].digests
        assert snap.leaves["params/m"].digests
        assert snap.leaves["opt/mu/w"].digests is None
    store.save_snapshot(snap, kind="termination")
    for h, path in store.pool.all_chunks():
        with open(path, "rb") as f:
            assert hashlib.sha1(f.read()).hexdigest() == h
    from repro_torch.train import state_template_on_device
    got, _man = store.restore(state_template_on_device(state, cuda))
    for n in ("params/t", "params/m"):
        assert same_bits(_flat(got)[n], _flat(state)[n]), n


def test_delta_save_after_a_2_3_2_rescale_launches_the_fingerprint(cuda,
                                                                   tmp_path):
    from repro_torch.checkpoint import CheckpointStore, DeviceDeltaTracker
    from repro_torch.core.elastic import fleet_mesh_plan, member_addressable
    from repro_torch.train import state_template_on_device
    store = CheckpointStore(str(tmp_path), chunk_size=CHUNK)
    tracker = DeviceDeltaTracker(store.pool, chunk_size=store.chunk_size,
                                 compress=store.compress)
    state = _card_state(cuda, seed=1)
    store.save(0, state, tracker=tracker)
    w = state["opt"]["mu"]["w"].clone()
    w[0, 0] += 1.0
    state["opt"]["mu"]["w"] = w
    store.save(1, state, tracker=tracker)
    # two leaves are tracked: the bf16 and the float32 matrix ("b" is under
    # the tracker's 64 KiB floor and takes the dense path)
    for n in (3, 2):
        res = tracker.rescale(member_addressable(
            fleet_mesh_plan(n, model_parallel=1), 0))
        assert res == {"kept": 2, "dropped": 0}
    w = state["opt"]["mu"]["w"].clone()
    w[7, 9] -= 1.0
    state["opt"]["mu"]["w"] = w
    fp0 = _lib.LAUNCHES["fingerprint"]
    info = store.save(2, state, tracker=tracker)
    full = sum(t.numel() * t.element_size() for t in _flat(state).values()
               if isinstance(t, torch.Tensor))
    assert _lib.LAUNCHES["fingerprint"] - fp0 == 2
    assert info.d2h_bytes_skipped > 0 and info.d2h_bytes < full / 2
    got, man = store.restore(state_template_on_device(state, cuda))
    assert man.step == 2
    for n, t in _flat(state).items():
        if isinstance(t, torch.Tensor):
            assert same_bits(_flat(got)[n], t)


def test_peer_warm_restore_onto_the_card_is_bitwise(cuda, tmp_path):
    from repro_torch.checkpoint import CheckpointStore, FleetPeerExchange
    from repro_torch.train import state_template_on_device
    store = CheckpointStore(str(tmp_path / "store"), chunk_size=CHUNK)
    state = _card_state(cuda, seed=2)
    store.save(1, state)
    man, reader = store.latest_valid()
    reader.close()
    exchange = FleetPeerExchange(str(tmp_path / "fabric"), 3,
                                 budget_bytes=40 * CHUNK)
    try:
        seed = exchange.seed_from(0, store.pool, sorted(man.chunk_hashes()))
        assert 0 < seed["chunks"] < len(man.chunk_hashes())
        template = state_template_on_device(state, cuda)
        want, _ = store.restore(template, streaming=True)
        for down in (False, True):
            if down:
                exchange.members[1][1].close()
            rt = exchange.read_through(0, store.pool)
            got, _ = store.restore(template, streaming=True, chunk_pool=rt)
            for n, t in _flat(want).items():
                if isinstance(t, torch.Tensor):
                    assert _flat(got)[n].device.type == "cuda"
                    assert same_bits(_flat(got)[n], t)
            assert rt.stats["peer_hits"] == seed["chunks"]
            assert rt.stats["store_reads"] > 0
            shutil.rmtree(exchange.members[0][0].root, ignore_errors=True)
    finally:
        exchange.close()


TWO_RANK_CARD = """
import json, sys
import torch, torch.distributed as dist
rank, init, root = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
from repro_torch.checkpoint import AsyncCheckpointer, CheckpointStore, TensorSpec
from repro_torch.checkpoint import serialize as ser
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import _lib
from repro_torch.kernels.quantize.ref import (dequantize_int8_ref,
                                              quantize_int8_ref)
from repro_torch.launch.mesh import make_mesh

g = torch.Generator(device=dev).manual_seed(5)
full = torch.randn(1024, 384, generator=g, device=dev) * 1e-3
# the halves differ in range: a per-shard scale would show
full[512:] *= 7.0
save_mesh = make_mesh((2, 1), ("data", "model"))
sh = shd.Sharding(save_mesh, shd.placements(("data", None), save_mesh))
state = {"opt": {"mu": {"w": shd.distribute(full, sh)}}, "step": 3}
store = CheckpointStore(root, chunk_size=64 * 1024, compress=False,
                        quantize_moments=True)
_lib.reset_launches()
ac = AsyncCheckpointer(store)
ac.save_urgent(3, state)
ac.close()
saved = dict(_lib.LAUNCHES)
q_want, scale_want = quantize_int8_ref(full)
_man, reader = store.latest_valid()
q, _dt, quant, scale = reader.read_region_payload(
    "opt/mu/w", ((0, 1024), (0, 384)))
reader.close()
assert quant == "int8" and scale == scale_want
assert torch.equal(torch.from_numpy(q), q_want.cpu())
# restore the columns onto (1, 2): int8 regions widened on the card
mesh = make_mesh((1, 2), ("data", "model"))
pl = shd.placements((None, "model"), mesh)
_lib.reset_launches()
got, man = store.restore({"opt": {"mu": {"w": TensorSpec(
    (1024, 384), torch.float32, dev, mesh, pl)}}, "step": 0}, streaming=True)
restored = dict(_lib.LAUNCHES)
t = got["opt"]["mu"]["w"]
(region,) = shd.addressable_shard_spans(mesh, pl, (1024, 384))
want = dequantize_int8_ref(q_want, scale_want, dtype=torch.float32)
want = want[tuple(slice(a, b) for a, b in region)]
assert t.to_local().device == dev and got["step"] == 3
assert torch.equal(t.to_local().view(torch.int32), want.contiguous().view(torch.int32))
print(json.dumps({"saved": saved, "restored": restored}))
dist.destroy_process_group()
"""


def test_two_rank_sharded_urgent_save_and_region_restore(cuda, tmp_path):
    """Two gloo ranks on the one card: an urgent save of a row-sharded
    moment quantizes each shard on the card with the all-reduced scale
    (the stored bytes equal the plain quantize of the whole tensor), and a
    restore onto the other mesh axis widens each rank's int8 region on the
    card, bit for bit with the plain dequantize."""
    import json
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    _lib.library()                    # built once, before the ranks start
    init = f"file://{tmp_path / 'rdv'}"
    procs = [subprocess.Popen([sys.executable, "-c", TWO_RANK_CARD, str(r),
                               init, str(tmp_path / "store")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for r in range(2)]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    for out, _err in outs:
        res = json.loads(out.strip().splitlines()[-1])
        assert res["saved"]["absmax"] >= 1 and res["saved"]["quantize"] >= 1
        assert res["restored"]["dequantize"] >= 1
