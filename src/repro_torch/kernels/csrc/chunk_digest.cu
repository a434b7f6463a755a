// Per-chunk content address (SHA-1) and CRC-32 of a save's tensors, on the
// device, before their bytes cross to the host.
//
// Replaces (no TPU kernel): the host digests of every chunk a save writes,
// src/repro/checkpoint/chunkstore.py::chunk_digest (hashlib.sha1) and the
// zlib.crc32 of store_chunk -> spot_chunk_digest. An urgent save's bytes
// then cross the link with their addresses known, and the host only writes
// them: inside the eviction notice the host's cores are shared between the
// digests and the filesystem's writes, and the digests lose.
//
// Output, bit for bit what hashlib and zlib give (the plain version,
// kernels/chunk_digest/ref.py): for chunk c, the five SHA-1 words in
// digest order and the CRC-32, over desc[c] = (address, length) — the
// 1 MiB windows (store.chunk_size) of each tensor's raw bytes, the last one
// of a tensor possibly short.
//
// Bound: one chunk's SHA-1 chain. A chunk's digest is a chain of
// compressions (16,385 for 1 MiB, the padding block included) with no
// parallelism inside it, so a call takes one chunk's chain whatever its
// chunk count. Within a round, a = rol(a, 5) + p compiles to one LEA.HI,
// and the next round's p = f(a, ...) + e + W_t + K_t is one LOP3 and one
// IADD3 on that same a: the critical path is three dependent integer
// operations every two rounds. chip_smoke.py measures the dependent
// latency on the card (spot_chunk_digest_chain_clocks: a chain of the
// rounds' rotate-and-add on one thread) and states the bound as blocks x
// 80 x 1.5 x that latency. Throughput comes close behind: the integer
// pipe has 16 lanes a scheduler, so each warp instruction holds it two
// clocks, and a round is four (f, the add, the rotate-and-add,
// rol(b, 30)). Moving the
// adds to the multiply-add pipe (IMAD by a runtime 1) was slower on the
// card: a dependence across the two pipes costs five clocks, not four.
// The bytes (read once) and the operations over every SM are each a small
// fraction of the chain.
//
// Design: warp-specialised, one CTA of three warps for 32 chunks, lane i of
// every warp on the CTA's chunk i, so each warp's instruction stream keeps
// only its own dependent path:
//  * warp 0 (loads and schedule) keeps each chunk's next RAW - 1 stages of
//    SB blocks in flight into a ring in shared memory with cp.async (16
//    bytes a copy where the chunk starts on a 16-byte boundary, 4 bytes
//    a copy otherwise: a leaf is only promised 4-byte alignment), then
//    byte-swaps each block and writes W_t + K_t, t = 0..79, into a second
//    ring, one row of WK_LD words per lane;
//  * warp 1 (CRC-32) reads the same staged bytes: each block's CRC from a
//    zero register by slicing-by-16 (no dependence between blocks), joined
//    to the running register by one multiply by x^512 mod P (four lookups:
//    crc32_combine at 64 bytes), so its chain is one table lookup a block;
//  * warp 2 (rounds) runs the 80 rounds of each block from its W_t + K_t
//    row, read sixteen bytes a load.
// A "full" and an "empty" mbarrier guard each slot of both rings; every
// lane arrives on each, so no lane's writes are released by another's
// arrival. The short tail block(s) of a chunk (its last len % 64 bytes and
// SHA-1's padding) are read from device memory by the rounds and CRC lanes
// themselves. Rows are padded so that a quarter-warp's 16-byte accesses
// fall in distinct banks (68 and 84 words: 17 and 21 sixteen-byte units,
// odd). The three warps land on three of the SM's four schedulers, so the
// rounds warp runs beside, not behind, the other two.
#include "chunk_digest.cuh"
#include "common.cuh"
#include "wgmma.cuh"

namespace {

namespace sd = spot_digest;
namespace tc = spot::tc;

constexpr int LANES = 32;             // chunks a CTA, one a lane
constexpr int THREADS = 3 * LANES;    // loads + schedule, CRC, rounds
constexpr int SB = 4;                 // 64-byte blocks a staged stage
constexpr int RAW = 6;                // stages in the byte ring
constexpr int RAW_LD = SB * 16 + 4;   // words between two lanes' staged bytes
constexpr int WKS = 4;                // blocks in the W_t + K_t ring
constexpr int WK_LD = 84;             // words between two lanes' W_t + K_t rows

struct Smem {
  uint32_t raw[RAW][LANES * RAW_LD];
  uint32_t wk[WKS][LANES * WK_LD];
  uint32_t T[16 * 256];               // slicing-by-16 tables
  uint32_t Z[4 * 256];                // x^512 mod P, by register byte
  uint64_t raw_full[RAW], raw_empty[RAW], wk_full[WKS], wk_empty[WKS];
};

constexpr int SMEM_BYTES = static_cast<int>(sizeof(Smem));

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

struct DevBytes {
  const uint8_t* b;
  __device__ __forceinline__ uint32_t byte(long long j) const { return __ldg(b + j); }
};

__device__ __forceinline__ long long warp_max(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const long long u = __shfl_xor_sync(0xffffffffu, v, o);
    v = u > v ? u : v;
  }
  return v;
}

__global__ void __launch_bounds__(THREADS, 1)
chunk_digest_kernel(const long long* __restrict__ desc, long long n_chunks,
                    uint32_t* __restrict__ sha, uint32_t* __restrict__ crc_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& S = *reinterpret_cast<Smem*>(smem_raw);
  const int warp = threadIdx.x / LANES, lane = threadIdx.x % LANES;

  for (int i = threadIdx.x; i < 256; i += THREADS) S.T[i] = sd::crc_t0(i);
  if (threadIdx.x == 0) {
    for (int s = 0; s < RAW; ++s) {
      tc::mbar_init(tc::smem_u32(&S.raw_full[s]), LANES);
      tc::mbar_init(tc::smem_u32(&S.raw_empty[s]), 2 * LANES);   // CRC and schedule
    }
    for (int s = 0; s < WKS; ++s) {
      tc::mbar_init(tc::smem_u32(&S.wk_full[s]), LANES);
      tc::mbar_init(tc::smem_u32(&S.wk_empty[s]), LANES);
    }
  }
  __syncthreads();
  {
    const uint32_t x512 = sd::crc_xpow8(64);
    for (int i = 256 + threadIdx.x; i < 16 * 256; i += THREADS)
      S.T[i] = sd::crc_mulmod(sd::crc_xpow8(i >> 8), S.T[i & 255]);
    for (int i = threadIdx.x; i < 4 * 256; i += THREADS)
      S.Z[i] = sd::crc_mulmod(x512, static_cast<uint32_t>(i & 255) << (8 * (i >> 8)));
  }
  __syncthreads();

  const long long c = static_cast<long long>(blockIdx.x) * LANES + lane;
  const bool live = c < n_chunks;
  const uint8_t* p = live ? reinterpret_cast<const uint8_t*>(desc[2 * c]) : nullptr;
  const long long len = live ? desc[2 * c + 1] : 0;
  const long long nfull = len / 64;                 // this lane's full blocks
  const long long cta_full = warp_max(nfull);       // every warp's trip count
  const long long stages = (cta_full + SB - 1) / SB;

  if (warp == 0) {
    // loads and the message schedule
    const bool wide = (reinterpret_cast<uintptr_t>(p) & 15) == 0;
    auto load_stage = [&](long long s) {
      const uint32_t dst = tc::smem_u32(&S.raw[s % RAW][lane * RAW_LD]);
#pragma unroll
      for (int b = 0; b < SB; ++b) {
        const long long blk = s * SB + b;
        if (blk >= nfull) break;
        const uint8_t* src = p + blk * 64;
        if (wide) {
#pragma unroll
          for (int q = 0; q < 4; ++q) tc::cp_async16(dst + b * 64 + q * 16, src + q * 16, true);
        } else {
#pragma unroll
          for (int q = 0; q < 16; ++q) cp_async4(dst + b * 64 + q * 4, src + q * 4);
        }
      }
    };
    for (long long s = 0; s < RAW - 1; ++s) {
      if (s < stages) load_stage(s);
      tc::cp_async_commit();
    }
    for (long long s = 0; s < stages; ++s) {
      const long long ahead = s + RAW - 1;
      if (ahead < stages) {
        if (ahead >= RAW)   // its slot's last stage, s - 1, released
          tc::mbar_wait(tc::smem_u32(&S.raw_empty[ahead % RAW]), ((ahead / RAW) - 1) & 1);
        load_stage(ahead);
      }
      tc::cp_async_commit();
      tc::cp_async_wait<RAW - 1>();                 // stage s has landed
      tc::mbar_arrive(tc::smem_u32(&S.raw_full[s % RAW]));
      const uint32_t* st = &S.raw[s % RAW][lane * RAW_LD];
      for (int b = 0; b < SB; ++b) {
        const long long blk = s * SB + b;
        if (blk >= cta_full) break;
        const int q = static_cast<int>(blk % WKS);
        if (blk >= WKS)
          tc::mbar_wait(tc::smem_u32(&S.wk_empty[q]), ((blk / WKS) - 1) & 1);
        if (blk < nfull) {
          uint32_t w[16], wk[80];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint4 v = *reinterpret_cast<const uint4*>(st + b * 16 + 4 * i);
            w[4 * i] = __byte_perm(v.x, 0, 0x0123);
            w[4 * i + 1] = __byte_perm(v.y, 0, 0x0123);
            w[4 * i + 2] = __byte_perm(v.z, 0, 0x0123);
            w[4 * i + 3] = __byte_perm(v.w, 0, 0x0123);
          }
          sd::sha1_schedule(w, wk);
          uint4* row = reinterpret_cast<uint4*>(&S.wk[q][lane * WK_LD]);
#pragma unroll
          for (int i = 0; i < 20; ++i)
            row[i] = make_uint4(wk[4 * i], wk[4 * i + 1], wk[4 * i + 2], wk[4 * i + 3]);
        }
        tc::mbar_arrive(tc::smem_u32(&S.wk_full[q]));
      }
      tc::mbar_arrive(tc::smem_u32(&S.raw_empty[s % RAW]));
    }
    tc::cp_async_wait<0>();
  } else if (warp == 1) {
    // CRC-32: each block's register from zero, joined by x^512
    uint32_t r = 0xffffffffu;
    for (long long s = 0; s < stages; ++s) {
      tc::mbar_wait(tc::smem_u32(&S.raw_full[s % RAW]), (s / RAW) & 1);
      const uint32_t* st = &S.raw[s % RAW][lane * RAW_LD];
      uint32_t part[SB];
#pragma unroll
      for (int b = 0; b < SB; ++b) {
        part[b] = 0;
        if (s * SB + b < nfull) {
          uint32_t x[16];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint4 v = *reinterpret_cast<const uint4*>(st + b * 16 + 4 * i);
            x[4 * i] = v.x;
            x[4 * i + 1] = v.y;
            x[4 * i + 2] = v.z;
            x[4 * i + 3] = v.w;
          }
          part[b] = sd::crc_block(x, S.T);
        }
      }
      tc::mbar_arrive(tc::smem_u32(&S.raw_empty[s % RAW]));
#pragma unroll
      for (int b = 0; b < SB; ++b)
        if (s * SB + b < nfull) r = sd::crc_shift64(r, S.Z) ^ part[b];
    }
    if (live) {
      for (long long j = nfull * 64; j < len; ++j) r = sd::crc_byte(r, __ldg(p + j), S.T);
      crc_out[c] = ~r;
    }
  } else {
    // the rounds
    uint32_t h[5];
    sd::sha1_init(h);
    for (long long blk = 0; blk < cta_full; ++blk) {
      const int q = static_cast<int>(blk % WKS);
      tc::mbar_wait(tc::smem_u32(&S.wk_full[q]), (blk / WKS) & 1);
      if (blk < nfull) {
        uint32_t wk[80];
        const uint4* row = reinterpret_cast<const uint4*>(&S.wk[q][lane * WK_LD]);
#pragma unroll
        for (int i = 0; i < 20; ++i) {
          const uint4 v = row[i];
          wk[4 * i] = v.x;
          wk[4 * i + 1] = v.y;
          wk[4 * i + 2] = v.z;
          wk[4 * i + 3] = v.w;
        }
        tc::mbar_arrive(tc::smem_u32(&S.wk_empty[q]));
        sd::sha1_rounds(h, wk);
      } else {
        tc::mbar_arrive(tc::smem_u32(&S.wk_empty[q]));
      }
    }
    if (live) {
      sd::sha1_tail(h, DevBytes{p}, len);
#pragma unroll
      for (int k = 0; k < 5; ++k) sha[5 * c + k] = h[k];
    }
  }
}

// dependent chains on one thread, `iters` steps timed with the SM's clock:
// mode 0 the rounds' rotate-and-add (a = rol(a, 5) + x, one LEA.HI), mode 1
// whole SHA-1 rounds from a schedule held in registers (a step is a round)
__global__ void chain_clocks_kernel(int mode, uint32_t seed, int iters, long long* clocks,
                                    uint32_t* sink) {
  uint32_t a = seed;
  const uint32_t x = seed * 2654435761u + 1u;
  long long t0 = 0, t1 = 0;
  if (mode == 0) {
    t0 = clock64();
#pragma unroll 1
    for (int i = 0; i < iters; i += 64) {
#pragma unroll
      for (int j = 0; j < 64; ++j) a = sd::rol(a, 5) + x;
    }
    t1 = clock64();
  } else {
    uint32_t wk[80], h[5];
#pragma unroll
    for (int t = 0; t < 80; ++t) wk[t] = x * (t + 1) + seed;
    sd::sha1_init(h);
    t0 = clock64();
#pragma unroll 1
    for (int i = 0; i < iters; i += 80) sd::sha1_rounds(h, wk);
    t1 = clock64();
    a = h[0] ^ h[1] ^ h[2] ^ h[3] ^ h[4];
  }
  clocks[0] = t1 - t0;
  sink[0] = a;
}

}  // namespace

// desc: int64[n_chunks][2] on the device, (address, length) of each chunk,
// every address 4-byte aligned; sha: uint32[n_chunks][5]; crc:
// uint32[n_chunks].
extern "C" int spot_chunk_digest(const void* desc, long long n_chunks, void* sha,
                                 void* crc, void* stream) {
  if (n_chunks <= 0) return 0;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        chunk_digest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const long long grid = (n_chunks + LANES - 1) / LANES;
  chunk_digest_kernel<<<static_cast<unsigned>(grid), THREADS, SMEM_BYTES,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(desc), n_chunks, static_cast<uint32_t*>(sha),
      static_cast<uint32_t*>(crc));
  return static_cast<int>(cudaGetLastError());
}

// int[5] out: chunks a CTA, threads a CTA, blocks a staged stage, stages
// in the byte ring, dynamic shared memory bytes a CTA
extern "C" int spot_chunk_digest_layout(int* out) {
  out[0] = LANES;
  out[1] = THREADS;
  out[2] = SB;
  out[3] = RAW;
  out[4] = SMEM_BYTES;
  return 0;
}

// clocks (device int64[1]) for `iters` steps of chain `mode` on one thread
// (chain_clocks_kernel; iters a multiple of 64, and of 80 for mode 1);
// sink: uint32[1]
extern "C" int spot_chunk_digest_chain_clocks(int mode, int iters, void* clocks,
                                              void* sink, void* stream) {
  chain_clocks_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      mode, 0x9E3779B9u, iters, static_cast<long long*>(clocks), static_cast<uint32_t*>(sink));
  return static_cast<int>(cudaGetLastError());
}
