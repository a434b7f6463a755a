// The per-chunk digest arithmetic of chunk_digest.cu: SHA-1 (FIPS 180-4) and
// zlib's CRC-32 (reflected polynomial 0xEDB88320) of one span of bytes, in
// one pass. Plain integer code with no CUDA types, so a host compiler can
// build it too; the kernel supplies the loads.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define SPOT_HD __host__ __device__ __forceinline__
#else
#define SPOT_HD inline
#endif

namespace spot_digest {

SPOT_HD uint32_t rol(uint32_t x, int n) { return (x << n) | (x >> (32 - n)); }

SPOT_HD uint32_t bswap(uint32_t x) {
  return (x >> 24) | ((x >> 8) & 0xff00u) | ((x << 8) & 0xff0000u) | (x << 24);
}

// the byte-wise table's entry for c
SPOT_HD uint32_t crc_t0(uint32_t c) {
  for (int j = 0; j < 8; ++j) c = (c & 1u) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
  return c;
}

// entry i of slicing table k: T0 is the byte-wise table, T_k[i] the CRC
// of byte i followed by k zero bytes
SPOT_HD uint32_t crc_table_entry(int k, uint32_t i) {
  uint32_t v = crc_t0(i);
  for (int j = 0; j < k; ++j) v = (v >> 8) ^ crc_t0(v & 0xffu);
  return v;
}

// one little-endian word through slicing-by-4
SPOT_HD uint32_t crc_word(uint32_t crc, uint32_t w, const uint32_t (*T)[256]) {
  crc ^= w;
  return T[3][crc & 0xffu] ^ T[2][(crc >> 8) & 0xffu] ^ T[1][(crc >> 16) & 0xffu] ^
         T[0][crc >> 24];
}

SPOT_HD uint32_t crc_byte(uint32_t crc, uint32_t b, const uint32_t (*T)[256]) {
  return T[0][(crc ^ b) & 0xffu] ^ (crc >> 8);
}

// SHA-1 compression of one 64-byte block; w: its 16 big-endian words,
// reused as the message schedule's ring
SPOT_HD void sha1_block(uint32_t h[5], uint32_t w[16]) {
  uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4];
#pragma unroll
  for (int t = 0; t < 80; ++t) {
    uint32_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      wt = rol(w[(t + 13) & 15] ^ w[(t + 8) & 15] ^ w[(t + 2) & 15] ^ w[t & 15], 1);
      w[t & 15] = wt;
    }
    uint32_t f, k;
    if (t < 20) {
      f = (b & c) | (~b & d);
      k = 0x5A827999u;
    } else if (t < 40) {
      f = b ^ c ^ d;
      k = 0x6ED9EBA1u;
    } else if (t < 60) {
      f = (b & c) | (b & d) | (c & d);
      k = 0x8F1BBCDCu;
    } else {
      f = b ^ c ^ d;
      k = 0xCA62C1D6u;
    }
    const uint32_t tmp = rol(a, 5) + f + e + k + wt;
    e = d;
    d = c;
    c = rol(b, 30);
    b = a;
    a = tmp;
  }
  h[0] += a;
  h[1] += b;
  h[2] += c;
  h[3] += d;
  h[4] += e;
}

// SHA-1 and CRC-32 of the n bytes src reads: src.word(i) the i-th native
// (little-endian) 4-byte word, src.byte(j) the j-th byte. h: the digest's
// five words (big-endian order, as hashlib prints them); returns the CRC.
template <class Src>
SPOT_HD uint32_t digest_span(const Src& src, long long n, const uint32_t (*T)[256],
                             uint32_t h[5]) {
  h[0] = 0x67452301u;
  h[1] = 0xEFCDAB89u;
  h[2] = 0x98BADCFEu;
  h[3] = 0x10325476u;
  h[4] = 0xC3D2E1F0u;
  uint32_t crc = 0xffffffffu;
  const long long full = n / 64;
  for (long long blk = 0; blk < full; ++blk) {
    uint32_t w[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint32_t x = src.word(blk * 16 + i);
      crc = crc_word(crc, x, T);
      w[i] = bswap(x);
    }
    sha1_block(h, w);
  }
  // the tail: the last n % 64 bytes, the 0x80 marker, zeros and the
  // message's length in bits, in one block or two
  uint32_t tw[32];
  for (int i = 0; i < 32; ++i) tw[i] = 0;
  const int r = static_cast<int>(n - full * 64);
  for (int j = 0; j < r; ++j) {
    const uint32_t b = src.byte(full * 64 + j);
    crc = crc_byte(crc, b, T);
    tw[j >> 2] |= b << (24 - 8 * (j & 3));
  }
  tw[r >> 2] |= 0x80u << (24 - 8 * (r & 3));
  const int nb = (r + 1 + 8 <= 64) ? 1 : 2;
  const unsigned long long bits = static_cast<unsigned long long>(n) * 8ull;
  tw[nb * 16 - 2] = static_cast<uint32_t>(bits >> 32);
  tw[nb * 16 - 1] = static_cast<uint32_t>(bits);
  sha1_block(h, tw);
  if (nb == 2) sha1_block(h, tw + 16);
  return ~crc;
}

}  // namespace spot_digest
