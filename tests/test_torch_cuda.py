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

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.checkpoint import serialize as ser  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels import fingerprint as fp  # noqa: E402
from repro_torch.kernels import quantize as qz  # noqa: E402
from repro_torch.kernels.decode_attention import (decode_attention_ref,  # noqa: E402
                                                  flash_decode)
from repro_torch.kernels.flash_attention import (attention_bwd_ref,  # noqa: E402
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
    # Sq a multiple of 64 but not of 128: the tensor-core forward's last
    # 128-row tile is half filled
    (1, 192, 4, 1, 256, 0, torch.bfloat16),
    (2, 448, 32, 32, 96, 0, torch.bfloat16),      # phi3-mini's heads
    (1, 320, 4, 2, 64, 64, torch.bfloat16),
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
    (64, 320, 96, torch.bfloat16)])
def test_flash_attention_kernel_non_causal_aligned(cuda, Sq, Skv, hd, dtype):
    q = randn((1, Sq, 2, hd), dtype, 1, cuda)
    k = randn((1, Skv, 1, hd), dtype, 2, cuda)
    o, lse = flash_attention_fwd(q, k, k, False, 0)
    want, want_lse = attention_ref(q, k, k, causal=False)
    atol, rtol = ATT_TOL[dtype]
    torch.testing.assert_close(o.float(), want.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=2e-5)


def test_flash_attention_forward_is_deterministic(cuda):
    q = randn((2, 320, 4, 256), torch.bfloat16, 5, cuda)
    k, v = (randn((2, 320, 1, 256), torch.bfloat16, s, cuda) for s in (6, 7))
    first = flash_attention_fwd(q, k, v, True, 0)
    again = flash_attention_fwd(q, k, v, True, 0)
    assert all(same_bits(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("dtype,variant", [(torch.bfloat16, "wgmma"),
                                           (torch.float32, "cudacore")])
def test_flash_kernels_route_by_dtype(cuda, dtype, variant):
    """bf16 runs the forward and the dkv pass on the tensor cores, float32
    on the CUDA cores; every launch also counts under its pass."""
    q, do = (randn((1, 128, 4, 128), dtype, s, cuda) for s in (1, 2))
    k, v = (randn((1, 128, 1, 128), dtype, s, cuda) for s in (3, 4))
    other = "cudacore" if variant == "wgmma" else "wgmma"
    before = dict(_lib.LAUNCHES)
    o, lse = flash_attention_fwd(q, k, v, True, 0)
    flash_attention_bwd(q, k, v, o, lse, do, True, 0)
    torch.cuda.synchronize()
    for p in ("fwd", "dkv"):
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
    (256, 100, torch.bfloat16)])
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
    # B, S, DI, dtype
    (2, 128, 256, torch.float32),
    (1, 200, 96, torch.float32),                  # DI a multiple of no block
    (4, 1984, 8192, torch.bfloat16),              # falcon-mamba's prefill
    (2, 65, 128, torch.bfloat16),                 # a partial staging chunk
]


def ssm_inputs(B, S, DI, dtype, device, N=16):
    g = torch.Generator().manual_seed(S * DI + B)
    u = torch.randn((B, S, DI), generator=g).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((B, S, DI), generator=g) - 2.0).to(dtype)
    A = -torch.exp(torch.randn((DI, N), generator=g) * 0.3)
    Bm = torch.randn((B, S, N), generator=g).to(dtype)
    Cm = torch.randn((B, S, N), generator=g).to(dtype)
    D = torch.full((DI,), 0.5)
    return [t.to(device) for t in (u, dt, A, Bm, Cm, D)]


@pytest.mark.parametrize("B,S,DI,dtype", SSM_GPU_CASES)
def test_ssm_scan_kernel_matches_plain(cuda, B, S, DI, dtype):
    args = ssm_inputs(B, S, DI, dtype, cuda)
    before = _lib.LAUNCHES["ssm_scan"]
    y, h = ssm_scan(*args)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["ssm_scan"] == before + 1
    yr, hr = ssm_scan_ref(*args)
    assert y.dtype == dtype and h.dtype == torch.float32
    if dtype == torch.float32:
        torch.testing.assert_close(y, yr, atol=1e-4, rtol=0)
        torch.testing.assert_close(h, hr, atol=1e-4, rtol=0)
    else:
        torch.testing.assert_close(y.float(), yr.float(), atol=1e-4,
                                   rtol=BF16_ULP)
        assert float((h - hr).abs().max()) <= 1e-4 * max(1.0, float(hr.abs().max()))


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
