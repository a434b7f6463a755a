// The per-chunk digest arithmetic of chunk_digest.cu: SHA-1 (FIPS 180-4) and
// zlib's CRC-32 (reflected polynomial 0xEDB88320), cut into the pieces the
// kernel's warps run apart:
//
//  * SHA-1's message schedule, with each round's constant already added
//    (sha1_schedule: W_t + K_t for t = 0..79), and the 80 rounds that read
//    it (sha1_rounds), so the rounds' thread keeps only the rounds' own
//    dependent chain;
//  * CRC-32 as a join of independent slices: each 64-byte block's CRC from
//    a zero register (crc_block, slicing-by-16), joined to the running
//    register by multiplying it by x^512 mod P (crc_shift64, four table
//    lookups): zlib's crc32_combine at a fixed length. crc32_combine itself
//    (any length, by square-and-multiply in GF(2)) is here too.
//
// Plain integer code with no CUDA types, so a host compiler builds it too
// (tests/test_torch_chunk_digest_host.py joins the pieces on one thread
// and holds them against hashlib and zlib); the kernel supplies the loads,
// the tables in shared memory and the warps.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define SPOT_HD __host__ __device__ __forceinline__
#else
#define SPOT_HD inline
#endif

namespace spot_digest {

constexpr uint32_t CRC_POLY = 0xEDB88320u;   // reflected: bit 31 is x^0

SPOT_HD uint32_t rol(uint32_t x, int n) { return (x << n) | (x >> (32 - n)); }

SPOT_HD uint32_t bswap(uint32_t x) {
  return (x >> 24) | ((x >> 8) & 0xff00u) | ((x << 8) & 0xff0000u) | (x << 24);
}

SPOT_HD void sha1_init(uint32_t h[5]) {
  h[0] = 0x67452301u;
  h[1] = 0xEFCDAB89u;
  h[2] = 0x98BADCFEu;
  h[3] = 0x10325476u;
  h[4] = 0xC3D2E1F0u;
}

SPOT_HD uint32_t sha1_k(int t) {
  return t < 20 ? 0x5A827999u : t < 40 ? 0x6ED9EBA1u : t < 60 ? 0x8F1BBCDCu : 0xCA62C1D6u;
}

// one block's message schedule plus the round constants: wk[t] = W_t + K_t;
// w: the block's 16 big-endian words
SPOT_HD void sha1_schedule(const uint32_t w[16], uint32_t wk[80]) {
  uint32_t r[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    r[t] = w[t];
    wk[t] = w[t] + sha1_k(t);
  }
#pragma unroll
  for (int t = 16; t < 80; ++t) {
    const uint32_t x =
        rol(r[(t + 13) & 15] ^ r[(t + 8) & 15] ^ r[(t + 2) & 15] ^ r[t & 15], 1);
    r[t & 15] = x;
    wk[t] = x + sha1_k(t);
  }
}

SPOT_HD uint32_t sha1_f(int t, uint32_t b, uint32_t c, uint32_t d) {
  if (t < 20) return (b & c) | (~b & d);
  if (t < 40 || t >= 60) return b ^ c ^ d;
  return (b & c) | (b & d) | (c & d);
}

// the 80 rounds of one compression from its schedule. Written one round
// ahead: p, the next round's f + e + W_t + K_t, is computed from a while
// the round's own a = rol(a, 5) + p is (one LEA.HI on the card), so the
// next p (f, then its add) runs beside that rotate-and-add
SPOT_HD void sha1_rounds(uint32_t h[5], const uint32_t wk[80]) {
  uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4];
  uint32_t p = sha1_f(0, b, c, d) + e + wk[0];
#pragma unroll
  for (int t = 0; t < 80; ++t) {
    const uint32_t na = rol(a, 5) + p;
    const uint32_t nc = rol(b, 30);
    if (t < 79) p = sha1_f(t + 1, a, nc, c) + d + wk[t + 1];
    e = d;
    d = c;
    c = nc;
    b = a;
    a = na;
  }
  h[0] += a;
  h[1] += b;
  h[2] += c;
  h[3] += d;
  h[4] += e;
}

SPOT_HD void sha1_block(uint32_t h[5], const uint32_t w[16]) {
  uint32_t wk[80];
  sha1_schedule(w, wk);
  sha1_rounds(h, wk);
}

// SHA-1's last block or two: the n - full * 64 tail bytes that src.byte(j)
// reads (j from full * 64), the 0x80 marker, zeros and the message's
// length n in bits
template <class Src>
SPOT_HD void sha1_tail(uint32_t h[5], const Src& src, long long n) {
  const long long full = n / 64;
  uint32_t tw[32];
  for (int i = 0; i < 32; ++i) tw[i] = 0;
  const int r = static_cast<int>(n - full * 64);
  for (int j = 0; j < r; ++j) tw[j >> 2] |= src.byte(full * 64 + j) << (24 - 8 * (j & 3));
  tw[r >> 2] |= 0x80u << (24 - 8 * (r & 3));
  const int nb = (r + 1 + 8 <= 64) ? 1 : 2;
  const unsigned long long bits = static_cast<unsigned long long>(n) * 8ull;
  tw[nb * 16 - 2] = static_cast<uint32_t>(bits >> 32);
  tw[nb * 16 - 1] = static_cast<uint32_t>(bits);
  sha1_block(h, tw);
  if (nb == 2) sha1_block(h, tw + 16);
}

// --- CRC-32 ------------------------------------------------------------------

// the byte-wise table's entry for c
SPOT_HD uint32_t crc_t0(uint32_t c) {
  for (int j = 0; j < 8; ++j) c = (c & 1u) ? CRC_POLY ^ (c >> 1) : c >> 1;
  return c;
}

// a * b mod P, both reflected (bit 31 the coefficient of x^0)
SPOT_HD uint32_t crc_mulmod(uint32_t a, uint32_t b) {
  uint32_t p = 0;
  for (int i = 0; i < 32; ++i) {
    if (a & (0x80000000u >> i)) p ^= b;
    b = (b & 1u) ? (b >> 1) ^ CRC_POLY : b >> 1;
  }
  return p;
}

// x^(8 n) mod P: the factor that n zero bytes apply to a CRC register
SPOT_HD uint32_t crc_xpow8(unsigned long long n) {
  uint32_t r = 0x80000000u, base = 0x00800000u;   // 1 and x^8
  for (; n; n >>= 1) {
    if (n & 1) r = crc_mulmod(base, r);
    base = crc_mulmod(base, base);
  }
  return r;
}

// zlib's crc32_combine: the CRC-32 of A followed by B from crc1 = crc32(A),
// crc2 = crc32(B) and B's length
SPOT_HD uint32_t crc32_combine(uint32_t crc1, uint32_t crc2, unsigned long long len2) {
  return crc_mulmod(crc_xpow8(len2), crc1) ^ crc2;
}

// entry i of slicing table k (k < 16): the register after byte i and k zero
// bytes, from a zero register (T0 is the byte-wise table)
SPOT_HD uint32_t crc_table_entry(int k, uint32_t i) {
  return crc_mulmod(crc_xpow8(static_cast<unsigned long long>(k)), crc_t0(i));
}

// entry v of shift table k (k < 4): register byte k holding v, moved
// across 64 zero bytes; crc_shift64 is the XOR of four of them
SPOT_HD uint32_t crc_shift_entry(int k, uint32_t v) {
  return crc_mulmod(crc_xpow8(64), v << (8 * k));
}

SPOT_HD uint32_t crc_byte(uint32_t crc, uint32_t b, const uint32_t* T0) {
  return T0[(crc ^ b) & 0xffu] ^ (crc >> 8);
}

// the register r moved across 64 zero bytes: r * x^512 mod P; Z: the shift
// tables, Z[256 * k + v] = crc_shift_entry(k, v)
SPOT_HD uint32_t crc_shift64(uint32_t r, const uint32_t* Z) {
  return Z[r & 0xffu] ^ Z[256 + ((r >> 8) & 0xffu)] ^ Z[512 + ((r >> 16) & 0xffu)] ^
         Z[768 + (r >> 24)];
}

// one 64-byte block's CRC register from zero (no pre- or post-inversion):
// w its 16 little-endian words, T the slicing tables, T[256 * k + i] =
// crc_table_entry(k, i). Four slicing-by-16 steps: the first word of each
// 16 bytes meets the register, the other three are looked up beside it.
SPOT_HD uint32_t crc_block(const uint32_t w[16], const uint32_t* T) {
  uint32_t r = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t x = r ^ w[4 * q], y = w[4 * q + 1], z = w[4 * q + 2], u = w[4 * q + 3];
    const uint32_t side = T[11 * 256 + (y & 0xffu)] ^ T[10 * 256 + ((y >> 8) & 0xffu)] ^
                          T[9 * 256 + ((y >> 16) & 0xffu)] ^ T[8 * 256 + (y >> 24)] ^
                          T[7 * 256 + (z & 0xffu)] ^ T[6 * 256 + ((z >> 8) & 0xffu)] ^
                          T[5 * 256 + ((z >> 16) & 0xffu)] ^ T[4 * 256 + (z >> 24)] ^
                          T[3 * 256 + (u & 0xffu)] ^ T[2 * 256 + ((u >> 8) & 0xffu)] ^
                          T[1 * 256 + ((u >> 16) & 0xffu)] ^ T[u >> 24];
    r = side ^ T[15 * 256 + (x & 0xffu)] ^ T[14 * 256 + ((x >> 8) & 0xffu)] ^
        T[13 * 256 + ((x >> 16) & 0xffu)] ^ T[12 * 256 + (x >> 24)];
  }
  return r;
}

}  // namespace spot_digest
