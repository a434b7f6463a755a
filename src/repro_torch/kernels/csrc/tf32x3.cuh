// 3xTF32 building blocks for the float32 flash-attention kernels
// (flash_attention.cu's forward, flash_attention_bwd.cu's dkv and dq
// passes): mma.sync m16n8k8 tf32 with float32 sums, every operand value
// split into TF32 hi + lo and each product taken as three TF32 products;
// the fragment loaders that split as they load from shared-memory tiles of
// float32 rows; the pair sums of two warps that share a row block; the
// cp.async row loader. sm_80 and later (the kernels build for sm_90a).
//
// Fragments (g = lane / 4, t = lane % 4): A a0 (g, t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4); B b0 (k t, n g), b1 (k t + 4, n g); the
// accumulator c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
// The sum over k is taken in any order, so an accumulator goes to the A
// layout of the next product by relabelling k: A's k = t is the column 2t,
// k = t + 4 the column 2t + 1, and the B operand read down its rows
// (frag_b_cols) follows the same labels.
#pragma once

#include <stdint.h>

#include "wgmma.cuh"

namespace spot::tf32 {

namespace tc = spot::tc;

constexpr int F_WARPS = 8;
constexpr int F_THREADS = F_WARPS * 32;

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

struct FragA { uint32_t hi[4], lo[4]; };
struct FragB { uint32_t hi[2], lo[2]; };

// x ~ hi + lo, both TF32. hi is cvt.rna's (which keeps a NaN or an
// infinity as it is); x - hi is finite whenever x is, and lo rounds it the
// way cvt.rna rounds a finite value, on the bits (add half a TF32 ulp to
// the magnitude, clear the 13 low bits): two integer instructions where
// cvt.rna takes four, with the same result
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32, the two small products first
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma_tf32(d, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(d, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(d, a.hi, b.hi[0], b.hi[1]);
}

// A fragment of rows 0..15 x columns 0..7 of a tile (row stride LD), each
// value times mul
template <int LD>
__device__ __forceinline__ FragA frag_a(const float* s, int lane, float mul) {
  const float* p = s + (lane >> 2) * LD + (lane & 3);
  FragA f;
  split_tf32(p[0] * mul, f.hi[0], f.lo[0]);
  split_tf32(p[8 * LD] * mul, f.hi[1], f.lo[1]);
  split_tf32(p[4] * mul, f.hi[2], f.lo[2]);
  split_tf32(p[8 * LD + 4] * mul, f.hi[3], f.lo[3]);
  return f;
}

// A fragment of rows 0..15 x columns 0..7 with k relabelled (k = t is
// column 2t, k = t + 4 column 2t + 1), read as float2 pairs
template <int LD>
__device__ __forceinline__ FragA frag_a_pairs(const float* s, int lane) {
  const float* p = s + (lane >> 2) * LD + 2 * (lane & 3);
  const float2 u = *reinterpret_cast<const float2*>(p);
  const float2 w = *reinterpret_cast<const float2*>(p + 8 * LD);
  FragA f;
  split_tf32(u.x, f.hi[0], f.lo[0]);
  split_tf32(w.x, f.hi[1], f.lo[1]);
  split_tf32(u.y, f.hi[2], f.lo[2]);
  split_tf32(w.y, f.hi[3], f.lo[3]);
  return f;
}

// B fragment (k x n = 8 x 8) whose n runs down the tile's rows and k along
// its columns: b = tile[n][k] (K, Q^T, V^T, dO^T in S and dP)
template <int LD>
__device__ __forceinline__ FragB frag_b_rows(const float* s, int lane, float mul) {
  const float* p = s + (lane >> 2) * LD + (lane & 3);
  FragB f;
  split_tf32(p[0] * mul, f.hi[0], f.lo[0]);
  split_tf32(p[4] * mul, f.hi[1], f.lo[1]);
  return f;
}

// B fragment whose k runs down the tile's rows, relabelled as frag_a_pairs
// labels it: b0 = tile[2t][g], b1 = tile[2t + 1][g] (dO, Q, K in the
// gradient products)
template <int LD>
__device__ __forceinline__ FragB frag_b_cols(const float* s, int lane, float mul) {
  const float* p = s + 2 * (lane & 3) * LD + (lane >> 2);
  FragB f;
  split_tf32(p[0] * mul, f.hi[0], f.lo[0]);
  split_tf32(p[LD] * mul, f.hi[1], f.lo[1]);
  return f;
}

// an accumulator's values as float2 pairs at rows g, g + 8, columns 2t, 2t + 1
template <int LD>
__device__ __forceinline__ void store_pairs(float* s, int lane, const float (&c)[4]) {
  float* p = s + (lane >> 2) * LD + 2 * (lane & 3);
  *reinterpret_cast<float2*>(p) = make_float2(c[0], c[1]);
  *reinterpret_cast<float2*>(p + 8 * LD) = make_float2(c[2], c[3]);
}

// a barrier of the `count` threads of the warps that share a row block
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The two warps of a pair (w, w ^ 1) each hold the partial S and dP of the
// pair's 2 NB column blocks over half the head dimension: each sends the
// other the blocks the other keeps (warp half h keeps blocks h NB ..
// h NB + NB - 1) through its outbox of 2 NB float4 a lane, and returns in
// sk, dpk its own blocks plus the other's partial. One writer, one fixed
// sum per value. The blocks are chosen by selects, not by a runtime index
// into the arrays, which would put them in local memory.
template <int NB>
__device__ __forceinline__ void pair_sum(float4* xch, int warp, int lane, int half,
                                         const float (&s)[2 * NB][4],
                                         const float (&dp)[2 * NB][4], float (&sk)[NB][4],
                                         float (&dpk)[NB][4], int bar_id) {
  float4* out = xch + warp * 2 * NB * 32 + lane;
  const float4* in = xch + (warp ^ 1) * 2 * NB * 32 + lane;
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    float gs[4], gd[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      gs[i] = half ? s[n][i] : s[NB + n][i];
      gd[i] = half ? dp[n][i] : dp[NB + n][i];
      sk[n][i] = half ? s[NB + n][i] : s[n][i];
      dpk[n][i] = half ? dp[NB + n][i] : dp[n][i];
    }
    out[n * 32] = make_float4(gs[0], gs[1], gs[2], gs[3]);
    out[(NB + n) * 32] = make_float4(gd[0], gd[1], gd[2], gd[3]);
  }
  bar_sync(bar_id, 64);
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    const float4 a = in[n * 32], b = in[(NB + n) * 32];
    sk[n][0] += a.x; sk[n][1] += a.y; sk[n][2] += a.z; sk[n][3] += a.w;
    dpk[n][0] += b.x; dpk[n][1] += b.y; dpk[n][2] += b.z; dpk[n][3] += b.w;
  }
}

// pair_sum of S alone (the forward): an outbox of NB float4 a lane
template <int NB>
__device__ __forceinline__ void pair_sum(float4* xch, int warp, int lane, int half,
                                         const float (&s)[2 * NB][4], float (&sk)[NB][4],
                                         int bar_id) {
  float4* out = xch + warp * NB * 32 + lane;
  const float4* in = xch + (warp ^ 1) * NB * 32 + lane;
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    float gs[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      gs[i] = half ? s[n][i] : s[NB + n][i];
      sk[n][i] = half ? s[NB + n][i] : s[n][i];
    }
    out[n * 32] = make_float4(gs[0], gs[1], gs[2], gs[3]);
  }
  bar_sync(bar_id, 64);
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    const float4 a = in[n * 32];
    sk[n][0] += a.x; sk[n][1] += a.y; sk[n][2] += a.z; sk[n][3] += a.w;
  }
}

// ROWS x HD floats (global row stride `stride`) into shared rows of LD
// floats, by cp.async, 16 bytes a thread
template <int ROWS, int HD, int LD>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long stride, int tid) {
  constexpr int CH = HD / 4;
#pragma unroll 4
  for (int i = tid; i < ROWS * CH; i += F_THREADS) {
    const int r = i / CH, c = (i - r * CH) * 4;
    tc::cp_async16(tc::smem_u32(dst + r * LD + c), src + r * stride + c, true);
  }
}

}  // namespace spot::tf32
