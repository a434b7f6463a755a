"""The chunk digest kernel's arithmetic on the host: ``csrc/chunk_digest.cuh``
built with the host's C++ compiler (it has no CUDA types) into the
git-ignored build directory and called through ctypes, held bit for bit
against hashlib's SHA-1 and zlib's CRC-32 on ragged lengths.

What the kernel's warps run apart is what is held here, on one thread:
SHA-1 from a precomputed W_t + K_t schedule (``sha1_schedule`` then
``sha1_rounds``), and CRC-32 as each 64-byte block's register from zero
(slicing-by-16) joined to the running one by x^512 mod P; and zlib's
``crc32_combine`` joining the CRCs of slices of any length. The kernel
itself runs only on a card (``tests/test_torch_cuda.py``)."""

import ctypes
import hashlib
import os
import shutil
import subprocess
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _lib  # noqa: E402

SHIM = r"""
#include <string.h>
#include "chunk_digest.cuh"

namespace sd = spot_digest;

namespace {
struct HostSrc {
  const unsigned char* b;
  uint32_t word(long long i) const {
    uint32_t w;
    memcpy(&w, b + 4 * i, 4);
    return w;
  }
  uint32_t byte(long long j) const { return b[j]; }
};
uint32_t T[16 * 256], Z[4 * 256];
bool ready = false;
void tables() {
  if (ready) return;
  for (int k = 0; k < 16; ++k)
    for (uint32_t i = 0; i < 256; ++i) T[256 * k + i] = sd::crc_table_entry(k, i);
  for (int k = 0; k < 4; ++k)
    for (uint32_t v = 0; v < 256; ++v) Z[256 * k + v] = sd::crc_shift_entry(k, v);
  ready = true;
}

// SHA-1 and CRC-32 of n bytes with the kernel's arithmetic on one thread
uint32_t digest_span(const HostSrc& src, long long n, uint32_t h[5]) {
  sd::sha1_init(h);
  uint32_t crc = 0xffffffffu;
  const long long full = n / 64;
  for (long long blk = 0; blk < full; ++blk) {
    uint32_t x[16], w[16], wk[80];
    for (int i = 0; i < 16; ++i) {
      x[i] = src.word(blk * 16 + i);
      w[i] = sd::bswap(x[i]);
    }
    sd::sha1_schedule(w, wk);
    sd::sha1_rounds(h, wk);
    crc = sd::crc_shift64(crc, Z) ^ sd::crc_block(x, T);
  }
  for (long long j = full * 64; j < n; ++j) crc = sd::crc_byte(crc, src.byte(j), T);
  sd::sha1_tail(h, src, n);
  return ~crc;
}
}  // namespace

extern "C" uint32_t spot_host_digest(const unsigned char* p, long long n, uint32_t* h) {
  tables();
  return digest_span(HostSrc{p}, n, h);
}

extern "C" uint32_t spot_host_crc32_combine(uint32_t crc1, uint32_t crc2,
                                            unsigned long long len2) {
  return sd::crc32_combine(crc1, crc2, len2);
}
"""

LENGTHS = [0, 1, 55, 56, 63, 64, 65, 4096 + 3, 1 << 20]


@pytest.fixture(scope="module")
def host():
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    header = _lib.CSRC / "chunk_digest.cuh"
    key = hashlib.sha1(SHIM.encode() + header.read_bytes()).hexdigest()[:16]
    out_dir = _lib.REPO_ROOT / "build" / "chunk_digest_host"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"digest_{key}.so"
    if not so.exists():
        # built under a name of its own, then renamed: test workers may
        # build at once
        src = out_dir / f"shim_{key}_{os.getpid()}.cc"
        tmp = out_dir / f"digest_{key}_{os.getpid()}.so"
        src.write_text(SHIM)
        subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I",
                        str(_lib.CSRC), str(src), "-o", str(tmp)], check=True)
        os.replace(tmp, so)
        src.unlink()
    lib = ctypes.CDLL(str(so))
    lib.spot_host_digest.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                     ctypes.c_void_p]
    lib.spot_host_digest.restype = ctypes.c_uint32
    lib.spot_host_crc32_combine.argtypes = [ctypes.c_uint32, ctypes.c_uint32,
                                            ctypes.c_ulonglong]
    lib.spot_host_crc32_combine.restype = ctypes.c_uint32
    return lib


def _data(n: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def _digest(lib, data: bytes) -> tuple[str, int]:
    buf = np.frombuffer(data, dtype=np.uint8).copy() if data else np.zeros(
        1, np.uint8)
    h = np.zeros(5, dtype=np.uint32)
    crc = lib.spot_host_digest(buf.ctypes.data, len(data), h.ctypes.data)
    return h.astype(">u4").tobytes().hex(), int(crc)


@pytest.mark.parametrize("n", LENGTHS)
def test_schedule_and_rounds_match_hashlib_and_zlib(host, n):
    data = _data(n, seed=n)
    sha, crc = _digest(host, data)
    assert sha == hashlib.sha1(data).hexdigest()
    assert crc == zlib.crc32(data)


@pytest.mark.parametrize("n", LENGTHS)
def test_crc_slices_joined_by_crc32_combine_match_zlib(host, n):
    """Each slice's CRC from the kernel's arithmetic, the slices joined by
    crc32_combine, whatever the cut points (block-aligned or not)."""
    data = _data(n, seed=n + 1)
    rng = np.random.default_rng(n)
    cuts = sorted({0, n, *rng.integers(0, n + 1, 4).tolist(),
                   *(c for c in (64, 4096, n // 2) if c <= n)})
    joined = None
    for a, b in zip(cuts, cuts[1:] or [n]):
        piece = _digest(host, data[a:b])[1]
        assert piece == zlib.crc32(data[a:b])
        joined = piece if joined is None else \
            host.spot_host_crc32_combine(joined, piece, b - a)
    assert (joined if joined is not None else 0) == zlib.crc32(data)
    # and on zlib's own CRCs, with an empty slice on either side
    half = n // 2
    c1, c2 = zlib.crc32(data[:half]), zlib.crc32(data[half:])
    assert host.spot_host_crc32_combine(c1, c2, n - half) == zlib.crc32(data)
    assert host.spot_host_crc32_combine(zlib.crc32(data), 0, 0) == zlib.crc32(data)
