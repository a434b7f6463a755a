"""The port's CUDA kernels against their plain PyTorch versions, bit for bit,
on a GPU. Imports no JAX, so it runs on a machine that has only the port's
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
