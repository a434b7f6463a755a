"""The port's kernel wrappers and plain versions against the JAX package:
fingerprint digests, absmax-int8 quantize and dequantize must agree bit for
bit with the reference's numpy refs, its Pallas kernels in interpret mode
and the host ``serialize`` codec. The CUDA kernels themselves are held
against these plain versions in ``test_torch_cuda.py``, on a GPU."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import serialize as jser  # noqa: E402
from repro.kernels import fingerprint as jfp  # noqa: E402
from repro.kernels import quantize as jq  # noqa: E402
from repro_torch.checkpoint import serialize as tser  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels import fingerprint as tfp  # noqa: E402
from repro_torch.kernels import quantize as tq  # noqa: E402

CHUNK = 64 * 1024
BF16 = ml_dtypes.bfloat16


def to_torch(a: np.ndarray) -> torch.Tensor:
    """numpy (ml_dtypes bfloat16 included) -> CPU tensor with the same bits."""
    return tser.numpy_to_tensor(np.ascontiguousarray(a), a.dtype.name)


def bits(x) -> np.ndarray:
    """Raw bytes of a tensor or array, for bit-for-bit comparisons."""
    if isinstance(x, torch.Tensor):
        x = tser.tensor_to_numpy(x.detach().contiguous())
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def payload(dtype, n, seed=0):
    rng = np.random.default_rng(seed + n)
    dt = np.dtype(dtype)
    if dt.kind in "iu":
        info = np.iinfo(dt)
        return rng.integers(max(info.min, -2**40), min(info.max, 2**40), n,
                            endpoint=True).astype(dt)
    return (rng.standard_normal(n) * 3).astype(dt)


# ---------------------------------------------------------------------------
# fingerprint
# ---------------------------------------------------------------------------

FP_CASES = [
    (np.float32, 3 * CHUNK // 4 + 17),       # partial last block
    (BF16, 2 * CHUNK + 1),
    (np.int8, 5 * CHUNK + 333),
    (np.int32, CHUNK // 4),                  # exactly one block
    (np.float32, 7),                         # one partial block
    (np.uint8, 13),
]
FP8_CASES = [(np.int64, 3 * CHUNK // 8 + 5), (np.float64, CHUNK // 8 + 1)]


@pytest.mark.parametrize("dtype,n", FP_CASES + FP8_CASES)
def test_fingerprint_plain_matches_reference_numpy(dtype, n):
    a = payload(dtype, n)
    want = jfp.fingerprint_blocks_ref(a, CHUNK)
    got = tfp.fingerprint_blocks(to_torch(a), block_bytes=CHUNK)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("dtype,n", FP_CASES)
def test_fingerprint_plain_matches_pallas_interpret(dtype, n):
    a = payload(dtype, n, seed=1)
    want = np.asarray(jfp.fingerprint_blocks(jnp.asarray(a), block_bytes=CHUNK,
                                             interpret=True))
    got = tfp.fingerprint_blocks(to_torch(a), block_bytes=CHUNK)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_fingerprint_diff_flags_exactly_the_changed_block():
    a = payload(np.float32, CHUNK)           # 4 blocks of 64 KiB
    b = a.copy()
    b[CHUNK // 4 + 5] += 1.0                 # dirty block 1 only
    old = tfp.fingerprint_blocks(to_torch(a), block_bytes=CHUNK)
    fp, diff = tfp.fingerprint_diff(to_torch(b), old, block_bytes=CHUNK)
    jold = jfp.fingerprint_blocks(jnp.asarray(a), block_bytes=CHUNK)
    jnew, jdiff = jfp.fingerprint_diff(jnp.asarray(b), jold, block_bytes=CHUNK,
                                       interpret=True)
    np.testing.assert_array_equal(fp.numpy().view(np.uint32), np.asarray(jnew))
    assert diff.tolist() == np.asarray(jdiff).tolist() == [False, True, False, False]


# (dtype, elements, block_bytes): every word width, blocks of 4 B to over a
# slice, tensors that end inside a block's last slice
FP_SPLIT_CASES = [
    (np.uint8, 3 * 4096 + 77, 4096),
    (np.int8, 1001, 4),
    (BF16, 2 * 4096 + 3, 4096 + 16),
    (np.float16, 70_001, 64 * 1024),
    (np.float32, 3 * CHUNK // 4 + 17, CHUNK),
    (np.int32, 1, 1024),
    (np.float64, 3000, 4096),
    (np.int64, 257, 64),
]


@pytest.mark.parametrize("dtype,n,block", FP_SPLIT_CASES)
@pytest.mark.parametrize("slice_bytes", [16, 1024, 4096, 64 * 1024])
def test_fingerprint_partials_and_final_match_the_whole_digest(dtype, n, block,
                                                               slice_bytes):
    """The CUDA kernel's split: per-slice sums with positions counted from
    the block's first word, then fmix32 of each block's sum, give the
    reference's digests for any slice size."""
    a = payload(dtype, n, seed=2)
    x = to_torch(a)
    parts = tfp.fingerprint_partials_ref(x, block, slice_bytes)
    spb = tfp.slices_per_block(block, slice_bytes)
    assert parts.shape == (tfp.n_blocks_of(x.numel() * x.element_size(), block), spb)
    fp, none = tfp.fingerprint_final_ref(parts)
    assert none is None
    np.testing.assert_array_equal(fp.numpy().view(np.uint32),
                                  jfp.fingerprint_blocks_ref(a, block))
    assert torch.equal(fp, tfp.fingerprint_blocks_ref(x, block))
    old = fp.clone()
    old[::2] ^= 1
    fp2, diff = tfp.fingerprint_final_ref(parts, old)
    assert torch.equal(fp2, fp) and torch.equal(diff, fp != old)


def test_fingerprint_split_wrappers_take_the_plain_versions_on_the_cpu():
    x = to_torch(payload(BF16, 5 * CHUNK + 9))
    parts = tfp.fingerprint_partials(x, block_bytes=4 * CHUNK)
    assert parts.shape == (3, 4 * CHUNK // tfp.SLICE_BYTES)
    assert torch.equal(parts, tfp.fingerprint_partials_ref(x, 4 * CHUNK,
                                                           tfp.SLICE_BYTES))
    assert torch.equal(tfp.fingerprint_final(parts)[0],
                       tfp.fingerprint_blocks(x, block_bytes=4 * CHUNK))


def test_fingerprint_rejects_bad_block_and_dtype():
    with pytest.raises(ValueError):
        tfp.fingerprint_blocks(torch.zeros(8), block_bytes=6)
    with pytest.raises(TypeError):
        tfp.fingerprint_blocks(torch.zeros(8, dtype=torch.bool), block_bytes=64)
    assert tfp.fingerprint_blocks(torch.zeros(0), block_bytes=64).numel() == 0


# ---------------------------------------------------------------------------
# absmax / quantize / dequantize
# ---------------------------------------------------------------------------

def ties(dtype):
    """absmax 127 -> scale 1, inv 1: every x.5 is a round-half-even tie."""
    return np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, -126.5, 3.0],
                    dtype=np.float32).astype(dtype)


Q_CASES = [
    ("f32", lambda: payload(np.float32, 4099)),
    ("bf16", lambda: payload(BF16, 1025)),
    ("f32_ties", lambda: ties(np.float32)),
    ("bf16_ties", lambda: ties(BF16)),
    ("f32_subnormal_elems",
     lambda: np.array([1.0, 1e-40, -3e-39, 2e-45], np.float32)),
    ("f32_2d", lambda: payload(np.float32, 6 * 130).reshape(6, 130)),
]


@pytest.mark.parametrize("name,make", Q_CASES, ids=[c[0] for c in Q_CASES])
def test_quantize_matches_interpret_and_host(name, make):
    a = make()
    q, scale = tq.quantize_int8(to_torch(a))
    jqv, jscale = jq.quantize_int8(jnp.asarray(a), interpret=True)
    hq, hscale = jser.quantize(a, "int8")
    assert q.dtype == torch.int8 and tuple(q.shape) == a.shape
    assert np.float32(scale) == np.float32(jscale) == np.float32(hscale)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(q.numpy(), hq)
    # the port's own host codec agrees too (bfloat16 as uint16 bits)
    pq, pscale = tser.quantize(tser.to_host(to_torch(a)), "int8", a.dtype.name)
    np.testing.assert_array_equal(pq, hq)
    assert pscale == hscale


def test_quantize_subnormal_absmax_matches_host():
    """A tensor of subnormals: the host codec keeps them (so must the CUDA
    kernels, built without flush-to-zero). XLA on the CPU flushes them, so
    the interpret-mode path is not the reference here."""
    a = np.array([1e-40, -3e-39, 2e-45], np.float32)
    q, scale = tq.quantize_int8(to_torch(a))
    hq, hscale = jser.quantize(a, "int8")
    assert scale == hscale and scale != 1.0
    np.testing.assert_array_equal(q.numpy(), hq)


def test_quantize_ties_round_half_to_even():
    q, scale = tq.quantize_int8(to_torch(ties(np.float32)))
    assert scale == 1.0
    assert q.tolist() == [127, 2, -4, 0, 0, 2, -126, 3]


def test_absmax_propagates_nan_like_numpy():
    a = payload(np.float32, 300)
    a[17] = np.nan
    got = tq.absmax(to_torch(a))
    assert got.shape == (1,) and torch.isnan(got).all()
    assert np.isnan(np.max(np.abs(a)))
    assert np.isnan(np.asarray(jq.absmax_2d(jnp.asarray(
        np.pad(a, (0, 84)).reshape(3, 128)), interpret=True))[0, 0])
    # a NaN absmax falls back to scale 1, as int8_scale_inv does
    assert tser.int8_scale_inv(got.numpy()[0]) == jser.int8_scale_inv(np.nan)


@pytest.mark.parametrize("absmax", [0.0, 1e-30, 3.0, 1e30])
def test_int8_scale_inv_identical(absmax):
    assert tser.int8_scale_inv(absmax) == jser.int8_scale_inv(absmax)


@pytest.mark.parametrize("dtype", [np.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 1000, 4096 + 3, 15, 16, 17])
def test_dequantize_matches_interpret_and_host(dtype, n):
    rng = np.random.default_rng(n)
    qv = rng.integers(-127, 128, n).astype(np.int8)
    scale = float(np.float32(0.0123))
    got = tq.dequantize_int8(torch.from_numpy(qv), scale,
                             dtype=tser.torch_dtype(np.dtype(dtype).name))
    want = np.asarray(jq.dequantize_int8(jnp.asarray(qv), scale, dtype=dtype,
                                         interpret=True))
    host = jser.finish_payload(qv.copy(), dtype_name=np.dtype(dtype).name,
                               quant="int8", scale=scale)
    np.testing.assert_array_equal(bits(got), bits(want))
    np.testing.assert_array_equal(bits(got), bits(host))
    mine = tser.finish_payload(qv.copy(), dtype_name=np.dtype(dtype).name,
                               quant="int8", scale=scale)
    np.testing.assert_array_equal(bits(mine), bits(host))


def test_dequantize_many_one_result_per_payload():
    qs = [torch.tensor([1, -2, 127], dtype=torch.int8),
          torch.tensor([[5]], dtype=torch.int8)]
    outs = tq.dequantize_int8_many(qs, [0.5, 2.0],
                                   [torch.float32, torch.bfloat16])
    assert outs[0].tolist() == [0.5, -1.0, 63.5]
    assert outs[1].dtype == torch.bfloat16 and outs[1].item() == 10.0


# ---------------------------------------------------------------------------
# wrapper routing
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    _lib.reset_launches()
    x = to_torch(payload(np.float32, 5000))
    tfp.fingerprint_blocks(x, block_bytes=CHUNK)
    q, s = tq.quantize_int8(x)
    tq.dequantize_int8(q, s, dtype=torch.float32)
    assert all(v == 0 for v in _lib.LAUNCHES.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("shape", [(3, 5, 7), (0, 4), (1,)])
def test_kernel_output_is_a_bare_contiguous_tensor(dtype, shape):
    # under deterministic algorithms torch.empty fills with NaN; the kernel
    # outputs are allocated bare, with the shape, dtype and size asked for
    x = _lib.kernel_output(shape, dtype, torch.device("cpu"))
    assert x.shape == shape and x.dtype == dtype and x.is_contiguous()
    assert x.untyped_storage().nbytes() == x.numel() * dtype.itemsize
    assert x.storage_offset() == 0
    x.fill_(1)
    assert x.sum().item() == x.numel()


def test_library_refuses_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_lib, "_lib", None)
    with pytest.raises(RuntimeError, match="GPU"):
        _lib.library()


def test_kernel_operand_checks():
    with pytest.raises(ValueError, match="CUDA"):
        _lib.require_cuda(torch.zeros(4), "op")


def test_sources_carry_their_notes_and_no_fast_math():
    srcs = list(_lib.CSRC.glob("*.cu"))
    assert {p.name for p in srcs} == {
        "chunk_digest.cu", "fingerprint.cu", "quantize.cu",
        "flash_attention.cu", "flash_attention_bwd.cu", "decode_attention.cu",
        "ssm_scan.cu", "rglru_scan.cu"}
    for p in srcs:
        text = p.read_text()
        assert "Replaces" in text and "bound" in text.lower()
    assert not any("fast_math" in f or "ftz" in f for f in _lib.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in _lib.NVCC_FLAGS
