"""Tensor (de)serialization for Spot-on checkpoints (PyTorch port).

A checkpoint shard file is a self-describing container:

    MAGIC | u32 header_len | header JSON (utf-8) | payload

The header lists every tensor stored in the file with its name (state key
path), dtype, local shape, global shape, the global index (slice) this piece
covers, byte offset/length into the payload, a crc32 checksum, and optional
codec ("zstd"/"zlib" per-tensor compression, "int8" absmax quantization for
optimizer moments). The format is byte-for-byte the reference package's, so
either package restores the other's checkpoints.

Host payloads are numpy arrays. numpy has no bfloat16, and this package does
not depend on ``ml_dtypes``: a bfloat16 tensor crosses to the host as its raw
``uint16`` bits and is recorded under the name ``"bfloat16"``. Every function
that needs the *logical* dtype of a host payload (quantize, codec policy,
records) takes it by name; ``name_to_dtype`` returns the numpy *storage*
dtype (``uint16`` for bfloat16), which is all the byte-level layers need.
Widening bfloat16 to float32 on the host is ``u16 << 16`` viewed as float32;
narrowing is round-to-nearest-even on the integer bits — the same bytes
``ml_dtypes`` and the device kernels produce.

The encode path holds a **one-copy invariant**: a tensor's payload is
materialized on the host at most once (the staged array itself for raw
codecs, the int8 array for quantized ones). ``quantize`` returns a contiguous
*array*, not bytes, and everything downstream — chunking, hashing, crc,
compression, file writes — operates on ``memoryview`` windows over that
buffer. Decode is symmetric: ``ShardFileReader`` maps its container once and
decodes tensors from mmap slices straight into caller-preallocated
destination buffers (``read_into``).
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from dataclasses import dataclass
from typing import Any, Iterable

import numpy as np
import torch

from ..faults import inject as faults
from .ioutil import array_bytes_view, mmap_view, release_view

try:  # optional: zstd beats zlib on ratio+speed, but zlib always exists
    import zstandard
    HAVE_ZSTD = True
except ImportError:  # pragma: no cover - environment-dependent
    zstandard = None
    HAVE_ZSTD = False

MAGIC = b"SPOTON1\n"
_U32 = struct.Struct("<I")

# extended float dtypes numpy cannot represent: name -> host storage dtype
_EXTENDED_DTYPES = {
    "bfloat16": np.dtype(np.uint16),
    "float8_e4m3fn": np.dtype(np.uint8),
    "float8_e5m2": np.dtype(np.uint8),
}

_TORCH_BY_NAME = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "uint16": torch.uint16,
    "uint32": torch.uint32, "uint64": torch.uint64, "bool": torch.bool,
    "float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2,
}
_NAME_BY_TORCH = {v: k for k, v in _TORCH_BY_NAME.items()}
# torch dtypes that have no numpy twin travel as same-width integers
_TORCH_HOST_VIEW = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8,
                    torch.float8_e5m2: torch.uint8}


def dtype_to_name(dtype) -> str:
    """Canonical dtype name for a numpy dtype, a torch dtype or a name."""
    if isinstance(dtype, torch.dtype):
        return _NAME_BY_TORCH[dtype]
    if isinstance(dtype, str) and dtype in _EXTENDED_DTYPES:
        return dtype
    return np.dtype(dtype).name


def name_to_dtype(name: str) -> np.dtype:
    """numpy *storage* dtype of a dtype name (bfloat16 -> uint16)."""
    if name in _EXTENDED_DTYPES:
        return _EXTENDED_DTYPES[name]
    return np.dtype(name)


def torch_dtype(name_or_dtype) -> torch.dtype:
    if isinstance(name_or_dtype, torch.dtype):
        return name_or_dtype
    return _TORCH_BY_NAME[dtype_to_name(name_or_dtype)]


@dataclass
class TensorRecord:
    """Metadata for one stored tensor piece."""

    name: str
    dtype: str                    # logical dtype (pre-quantization)
    shape: tuple[int, ...]        # local (stored piece) shape
    global_shape: tuple[int, ...]
    index: tuple[tuple[int, int], ...]  # [start, stop) per dim, global coords
    offset: int = 0
    nbytes: int = 0
    crc32: int = 0
    codec: str = "raw"            # raw | zstd | int8 | int8+zstd
    scale: float | None = None    # absmax scale for int8 codec

    def to_json(self) -> dict:
        d = {
            "name": self.name, "dtype": self.dtype, "shape": list(self.shape),
            "global_shape": list(self.global_shape),
            "index": [list(p) for p in self.index],
            "offset": self.offset, "nbytes": self.nbytes, "crc32": self.crc32,
            "codec": self.codec,
        }
        if self.scale is not None:
            d["scale"] = self.scale
        return d

    @staticmethod
    def from_json(d: dict) -> "TensorRecord":
        return TensorRecord(
            name=d["name"], dtype=d["dtype"], shape=tuple(d["shape"]),
            global_shape=tuple(d["global_shape"]),
            index=tuple(tuple(p) for p in d["index"]),
            offset=d["offset"], nbytes=d["nbytes"], crc32=d["crc32"],
            codec=d.get("codec", "raw"), scale=d.get("scale"),
        )


# ---------------------------------------------------------------------------
# nested state <-> named leaves
# ---------------------------------------------------------------------------

def _walk(tree, prefix: tuple, out: list) -> None:
    # the reference's key-path order: dict keys sorted, sequences in order,
    # None an empty subtree
    if isinstance(tree, dict):
        for k in sorted(tree):
            _walk(tree[k], prefix + (str(k),), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _walk(v, prefix + (str(i),), out)
    elif tree is not None:
        out.append(("/".join(prefix), tree))


def flatten_state(tree) -> dict[str, Any]:
    """Flatten nested dict/list/tuple state into {keypath: leaf}, names and
    order identical to the reference's pytree key paths
    (``params/segments/0/pos0/attn/wq``)."""
    leaves: list = []
    _walk(tree, (), leaves)
    out = {}
    for name, leaf in leaves:
        if name in out:
            raise ValueError(f"duplicate leaf name {name!r}")
        out[name] = leaf
    return out


def unflatten_like(template, named: dict[str, Any]):
    """Rebuild ``template``'s nesting with leaves taken from ``named``."""
    return _build(template, (), named)


def _build(tree, prefix, named):
    # a module-level function, not a closure: a nested recursive function
    # refers to itself through its closure cell, a cycle that would keep
    # ``named`` (every leaf, device tensors included) alive until the next
    # garbage collection
    if isinstance(tree, dict):
        return {k: _build(v, prefix + (str(k),), named) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [_build(v, prefix + (str(i),), named) for i, v in enumerate(tree)]
        return type(tree)(vals) if isinstance(tree, tuple) else vals
    if tree is None:
        return None
    return named["/".join(prefix)]


def structure_repr(tree) -> str:
    """Human-readable nesting of a state (the manifest's debugging aid)."""
    def rep(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {rep(t[k])}" for k in sorted(t)) + "}"
        if isinstance(t, (list, tuple)):
            inner = ", ".join(rep(v) for v in t)
            return f"[{inner}]" if isinstance(t, list) else f"({inner})"
        return "None" if t is None else "*"
    return rep(tree)


def leaf_dtype_name(leaf) -> str:
    """Logical dtype name of a state leaf (tensor, ndarray or scalar)."""
    if isinstance(leaf, torch.Tensor):
        return dtype_to_name(leaf.dtype)
    # the dtype alone is read; no buffer is kept
    return np.asarray(leaf).dtype.name  # spotlint: ignore[SPOT021]


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """CPU tensor -> numpy array sharing its memory; dtypes numpy lacks come
    out as same-width integers (bfloat16 -> uint16 bits)."""
    view = _TORCH_HOST_VIEW.get(t.dtype)
    if view is None:
        return t.numpy()
    arr = t.view(view).numpy()
    return arr.view(name_to_dtype(dtype_to_name(t.dtype)))


def numpy_to_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """Host payload array (storage dtype) -> CPU tensor of ``dtype_name``.
    Copies when ``arr`` is read-only (an mmap view must never back a
    tensor that training may write)."""
    if not arr.flags.writeable or not arr.flags.c_contiguous:
        arr = np.array(arr, copy=True, order="C")
    tdt = torch_dtype(dtype_name)
    view = _TORCH_HOST_VIEW.get(tdt)
    if view is None:
        return torch.from_numpy(arr)
    np_view = np.dtype(str(view).replace("torch.", ""))
    return torch.from_numpy(arr.view(np_view)).view(tdt)


def to_host(leaf) -> np.ndarray:
    """State leaf -> numpy array: the snapshot *freeze*.

    Always a copy the caller owns: torch tensors and numpy arrays are
    mutable, and the encode path hashes and writes from memoryview windows
    over this buffer — if it aliased live state, an in-place update between
    digest and write would commit a chunk whose bytes match neither its
    content address nor its crc. A bfloat16 tensor comes out as its uint16
    bits (see the module docstring)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        t = t.cpu() if t.device.type != "cpu" else t.clone()
        # `t` is this function's own: a CUDA tensor's host copy or a clone
        return tensor_to_numpy(t.contiguous())  # spotlint: ignore[SPOT021]
    if isinstance(leaf, np.ndarray):
        return leaf.copy()
    return np.asarray(leaf)


# ---------------------------------------------------------------------------
# bfloat16 on the host, without ml_dtypes
# ---------------------------------------------------------------------------

def bf16_bits_to_f32(u16: np.ndarray) -> np.ndarray:
    """bfloat16 bits (uint16) -> float32, exact: the bits are the top half."""
    # only read: the widened result below is a new array
    u16 = np.asarray(u16)  # spotlint: ignore[SPOT021]
    if u16.dtype != np.uint16:          # a bfloat16-typed array: same bits
        u16 = u16.view(np.uint16)
    return (u16.astype(np.uint32) << np.uint32(16)).view(np.float32)


def f32_to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bits, round to nearest even on the integer bits
    (NaN stays a quiet NaN of the same sign)."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    rounded = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) \
        >> np.uint32(16)
    nan = (u & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    out = np.where(nan, (u >> np.uint32(16)) | np.uint32(0x40), rounded)
    return out.astype(np.uint16)


def to_f32(arr: np.ndarray, dtype_name: str | None = None) -> np.ndarray:
    """Host payload -> float32 values of its logical dtype."""
    if dtype_name == "bfloat16":
        return bf16_bits_to_f32(arr)
    if dtype_name in _EXTENDED_DTYPES:
        raise TypeError(f"no host widen for {dtype_name}")
    # only read: astype returns a new array
    return np.asarray(arr).astype(np.float32)  # spotlint: ignore[SPOT021]


def from_f32(x: np.ndarray, dtype_name: str) -> np.ndarray:
    """float32 values -> host payload of ``dtype_name`` (storage dtype)."""
    if dtype_name == "bfloat16":
        return f32_to_bf16_bits(x)
    return x.astype(name_to_dtype(dtype_name))


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------

def resolve_codec(codec: str) -> str:
    """Degrade zstd-suffixed codecs to zlib when zstandard is unavailable."""
    if codec.endswith("zstd") and not HAVE_ZSTD:
        return codec[:-len("zstd")] + "zlib"
    return codec


def split_codec(codec: str) -> tuple[str, str]:
    """Codec string -> (quantization, compression) halves.

    The delta write path applies the two halves at different granularities:
    quantization per tensor (the absmax scale is tensor-global), compression
    per chunk (so unchanged chunks can skip the compressor entirely).
    """
    quant = "int8" if codec.startswith("int8") else ""
    if codec.endswith("zstd"):
        comp = "zstd"
    elif codec.endswith("zlib"):
        comp = "zlib"
    else:
        comp = ""
    return quant, comp


def quantize(arr: np.ndarray, quant: str, dtype_name: str | None = None
             ) -> tuple[np.ndarray, float | None]:
    """Tensor -> contiguous payload *array* (+ absmax scale for int8).

    ``dtype_name`` is the logical dtype of ``arr`` (needed for bfloat16,
    which arrives as uint16 bits). Returns an array, not bytes: for the raw
    codec this is the input itself when already contiguous (zero-copy).
    """
    if quant == "int8":
        x = to_f32(arr, dtype_name)
        absmax = np.float32(np.max(np.abs(x))) if x.size else np.float32(0.0)
        scale, inv = int8_scale_inv(absmax)
        # multiply-only elementwise step with float32 scalars: bit-identical
        # to the device quantize kernel, so urgent (device-quantized) and
        # periodic (host-quantized) saves of the same state dedup
        q = np.clip(np.round(x * inv), -127, 127).astype(np.int8)
        return q, float(scale)
    return np.ascontiguousarray(arr), None


def int8_scale_inv(absmax) -> tuple[np.float32, np.float32]:
    """absmax -> (scale, 1/scale), both float32, computed with numpy scalar
    ops. Every quantize implementation (host, torch plain version, CUDA
    kernel) funnels its reduce result through this one function so the
    scalar rounding sequence — and therefore the stored bytes — cannot
    diverge."""
    absmax = np.float32(absmax)
    scale = absmax / np.float32(127.0) if absmax > 0 else np.float32(1.0)
    return scale, np.float32(1.0) / scale


def compress_bytes(buf, comp: str) -> bytes:
    """Compress a bytes-like (bytes or memoryview window) payload."""
    if comp == "zstd":
        return zstandard.ZstdCompressor(level=3).compress(buf)
    if comp == "zlib":
        return zlib.compress(buf, 3)
    return buf


def decompress_bytes(buf, comp: str) -> bytes:
    if comp == "zstd":
        if not HAVE_ZSTD:
            raise IOError(
                "payload was written with the zstd codec but the 'zstandard' "
                "package is not installed (pip install zstandard)")
        return zstandard.ZstdDecompressor().decompress(buf)
    if comp == "zlib":
        return zlib.decompress(buf)
    return buf


def stored_dtype(dtype_name: str, quant: str) -> np.dtype:
    """Dtype of the raw (pre-compression) payload on disk."""
    return np.dtype(np.int8) if quant == "int8" else name_to_dtype(dtype_name)


def alloc_payload(dtype_name: str, shape, quant: str) -> np.ndarray:
    """Preallocated destination for a tensor's raw payload — decode fills
    this in place (one mmap-slice copy per chunk, no concatenation)."""
    return np.empty(tuple(shape), dtype=stored_dtype(dtype_name, quant))


def finish_payload(dst: np.ndarray, *, dtype_name: str, quant: str,
                   scale: float | None) -> np.ndarray:
    """Filled payload array -> logical tensor payload (dequantize if needed).

    The dequantize multiplies in float32 with a float32 scale — the exact
    arithmetic of the device dequantize kernel, so host- and device-restored
    tensors are bit-identical. A bfloat16 target rounds to nearest even and
    comes back as uint16 bits.
    """
    if quant == "int8":
        s = np.float32(scale)
        if dtype_name == "float32":
            return np.multiply(dst, s, dtype=np.float32)
        return from_f32(dst.astype(np.float32) * s, dtype_name)
    return dst


def payload_to_array(raw, *, dtype_name: str, shape, quant: str,
                     scale: float | None) -> np.ndarray:
    """Decoded (decompressed) raw payload bytes -> tensor payload (copies)."""
    shape = tuple(shape)
    dst = np.frombuffer(raw, dtype=stored_dtype(dtype_name, quant)).reshape(shape)
    if quant != "int8":
        dst = dst.copy()        # frombuffer views are read-only
    return finish_payload(dst, dtype_name=dtype_name, quant=quant, scale=scale)


def _encode(arr: np.ndarray, codec: str, dtype_name: str):
    quant, comp = split_codec(codec)
    raw, scale = quantize(arr, quant, dtype_name)
    view = array_bytes_view(raw)
    if comp:
        return compress_bytes(view, comp), scale
    return view, scale          # zero-copy: raw codec payload is the array


def _decode(buf, rec: TensorRecord) -> np.ndarray:
    quant, comp = split_codec(rec.codec)
    try:
        raw = decompress_bytes(buf, comp) if comp else buf
    except IOError as e:
        raise IOError(f"tensor {rec.name!r}: {e}") from None
    return payload_to_array(raw, dtype_name=rec.dtype, shape=rec.shape,
                            quant=quant, scale=rec.scale)


# ---------------------------------------------------------------------------
# shard file writer / reader
# ---------------------------------------------------------------------------

@dataclass
class PendingTensor:
    record: TensorRecord
    payload: Any               # bytes or memoryview over the staged array


def encode_tensor(
    name: str,
    arr: np.ndarray,
    *,
    global_shape: tuple[int, ...] | None = None,
    index: tuple[tuple[int, int], ...] | None = None,
    codec: str = "raw",
    prequant_scale: float | None = None,
    logical_dtype: str | None = None,
) -> PendingTensor:
    """Encode one tensor piece.

    ``logical_dtype`` names the dtype ``arr`` stands for (bfloat16 payloads
    are uint16 bits). ``prequant_scale`` marks ``arr`` as an already-
    quantized int8 payload (produced on-device before the host copy): the
    quantize half of ``codec`` is skipped and the on-disk bytes are
    identical to a host-side quantize of the same values.
    """
    # `arr` is snapshot-owned: to_host froze (copied) it at the snapshot
    # boundary, so this asarray is a no-op normalization
    arr = np.asarray(arr)  # spotlint: ignore[SPOT021]
    codec = resolve_codec(codec)
    gshape = tuple(global_shape if global_shape is not None else arr.shape)
    idx = tuple(index if index is not None else tuple((0, s) for s in arr.shape))
    dtype_name = logical_dtype or dtype_to_name(arr.dtype)
    if prequant_scale is not None:
        _quant, comp = split_codec(codec)
        view = array_bytes_view(np.ascontiguousarray(arr))
        payload = compress_bytes(view, comp) if comp else view
        scale = prequant_scale
    else:
        payload, scale = _encode(arr, codec, dtype_name)
    rec = TensorRecord(
        name=name, dtype=dtype_name, shape=tuple(arr.shape),
        global_shape=gshape, index=idx, nbytes=len(payload),
        crc32=zlib.crc32(payload), codec=codec, scale=scale,
    )
    return PendingTensor(rec, payload)


def write_shard_file(path, tensors: Iterable[PendingTensor]) -> list[TensorRecord]:
    """Write a shard container; returns finalized records (offsets filled)."""
    tensors = list(tensors)
    offset = 0
    records = []
    for t in tensors:
        t.record.offset = offset
        offset += t.record.nbytes
        records.append(t.record)
    header = json.dumps({"tensors": [r.to_json() for r in records]}).encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(_U32.pack(len(header)))
        f.write(header)
        for t in tensors:
            faults.write_bytes(f, t.payload, op="shard.write", path=str(path))
        f.flush()
        os.fsync(f.fileno())
    return records


class ShardFileReader:
    """Random access into a shard container; validates crc per read.

    The container is mapped once (``mmap``) and every tensor read slices the
    mapping. Falls back to one buffered read of the whole file where mmap is
    unavailable.
    """

    def __init__(self, path: "str | os.PathLike[str]") -> None:
        self.path = path
        self._buf: memoryview | None = mmap_view(str(path))
        if bytes(self._buf[:len(MAGIC)]) != MAGIC:
            magic = bytes(self._buf[:len(MAGIC)])
            release_view(self._buf)
            raise ValueError(f"{path}: bad magic {magic!r}")
        (hlen,) = _U32.unpack(self._buf[len(MAGIC):len(MAGIC) + 4])
        self._payload_start = len(MAGIC) + 4 + hlen
        header = json.loads(bytes(self._buf[len(MAGIC) + 4:self._payload_start]))
        self.records = {r["name"]: TensorRecord.from_json(r) for r in header["tensors"]}

    def close(self) -> None:
        if self._buf is not None:
            release_view(self._buf)
            self._buf = None

    def names(self) -> list[str]:
        return list(self.records)

    def _payload_view(self, rec: TensorRecord) -> memoryview:
        if self._buf is None:
            raise ValueError(f"{self.path}: reader is closed")
        start = self._payload_start + rec.offset
        buf = self._buf[start:start + rec.nbytes]
        if zlib.crc32(buf) != rec.crc32:
            raise IOError(f"{self.path}:{rec.name}: crc mismatch (corrupt shard)")
        return buf

    def read(self, name: str) -> np.ndarray:
        return _decode(self._payload_view(self.records[name]),
                       self.records[name])

    def read_into(self, name: str, dst: np.ndarray) -> bool:
        """Decode ``name`` directly into preallocated ``dst`` when its dtype
        and shape match the stored payload; returns False (caller falls back
        to ``read``) otherwise."""
        rec = self.records[name]
        quant, _comp = split_codec(rec.codec)
        if quant:
            return False
        return self.read_payload_into(name, dst)

    def read_payload_view(self, name: str) -> memoryview | None:
        """crc-validated zero-copy view of an *uncompressed* tensor's stored
        payload; None for compressed records. The view's lifetime is tied to
        this reader's mapping."""
        rec = self.records[name]
        _quant, comp = split_codec(rec.codec)
        if comp:
            return None
        return self._payload_view(rec)

    def read_payload_into(self, name: str, dst: np.ndarray) -> bool:
        """Fill ``dst`` with the *stored* payload (post-decompress,
        pre-dequantize): for an int8-coded tensor ``dst`` must be int8."""
        rec = self.records[name]
        quant, comp = split_codec(rec.codec)
        if (tuple(dst.shape) != tuple(rec.shape)
                or dst.dtype != stored_dtype(rec.dtype, quant)
                or not dst.flags.c_contiguous):
            return False
        buf = self._payload_view(rec)
        out = array_bytes_view(dst)
        if comp:
            out[:] = decompress_bytes(buf, comp)
        else:
            out[:] = buf
        return True

    def validate(self) -> None:
        for name in self.records:
            self.read(name)


def is_float_dtype(dtype) -> bool:
    """True for float dtypes including bfloat16/float8 (by name, numpy dtype
    or torch dtype)."""
    if isinstance(dtype, torch.dtype):
        return dtype.is_floating_point
    if isinstance(dtype, str) and dtype in _EXTENDED_DTYPES:
        return True
    dt = np.dtype(dtype)
    return np.issubdtype(dt, np.floating) or dt.name in _EXTENDED_DTYPES


def _dtype_kind(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        dtype = dtype_to_name(dtype)
    if isinstance(dtype, str) and dtype in _EXTENDED_DTYPES:
        return "V"             # the reference's ml_dtypes kind
    return np.dtype(dtype).kind


def is_moment_name(name: str) -> bool:
    """True for optimizer-moment leaves (``opt/.../mu|nu``)."""
    wrapped = f"/{name}/"
    return "/mu/" in wrapped or "/nu/" in wrapped


def default_codec_for(name: str, arr: np.ndarray, *, compress: bool,
                      quantize_moments: bool, dtype_name: str | None = None
                      ) -> str:
    """Checkpoint codec policy (``dtype_name`` overrides ``arr.dtype`` for
    payloads whose logical dtype numpy cannot hold)."""
    # metadata-only inspection (dtype/nbytes/ndim); the buffer is not
    # retained, so aliasing is harmless here
    arr = np.asarray(arr)  # spotlint: ignore[SPOT021]
    return codec_for_meta(name, dtype_name or arr.dtype, arr.nbytes,
                          ndim=arr.ndim, compress=compress,
                          quantize_moments=quantize_moments)


def codec_for_meta(name: str, dtype, nbytes: int, *, ndim: int,
                   compress: bool, quantize_moments: bool) -> str:
    """``default_codec_for`` from metadata alone — the device-delta tracker
    must know a leaf's codec *before* any bytes reach the host, so the
    policy is keyed on (name, dtype, nbytes, ndim), never on content."""
    if (quantize_moments and is_moment_name(name) and is_float_dtype(dtype)
            and ndim >= 1):
        return resolve_codec("int8+zstd") if compress else "int8"
    if compress and nbytes >= 1024:
        if HAVE_ZSTD:
            return "zstd"
        # zlib runs ~20 MB/s on float payloads for a ~7% ratio — large float
        # tensors stay raw; integer/bool payloads still compress well
        if _dtype_kind(dtype) in "iub":
            return "zlib"
    return "raw"
