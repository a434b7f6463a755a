// Hopper tensor-core building blocks for the bfloat16 flash-attention
// kernels (flash_attention.cu, flash_attention_bwd.cu): 128-byte-swizzled
// bf16 tiles filled by cp.async, wgmma shared-memory descriptors, the
// m64n64k16 bf16 -> float32 wgmma with A from shared memory (SS) or from
// registers (RS), and the split of a float32 fragment into bf16 hi + lo
// A operands. sm_90a only.
//
// Tile layout. A tile of ROWS rows by C columns of bf16 (C a multiple of
// 64) is stored as C / 64 column blocks, each ROWS x 128 bytes, rows 128 B
// apart; inside a row the 16-byte chunk c lands at chunk c ^ (row % 8): the
// 128-byte swizzle that wgmma's descriptor layout 1 reads, and the reason
// every tile starts on a 1024-byte boundary.
//
// Descriptors. Every wgmma here is m64n64k16, so an operand's K extent (16
// values, 32 bytes) or N extent (64 values, one column block) never leaves
// one swizzle atom along the other dimension's leading direction: both
// byte offsets are set to 1024, the distance between 8-row groups, which is
// the only one the instruction steps across.
//  * K-major operand (K along the tile's columns: Q, K, V, dO as the
//    first products read them): K step kk starts at column block kk / 4,
//    byte 32 * (kk % 4) of the row.
//  * MN-major operand (K along the tile's rows, N along its columns: V in
//    O += P V, dO and Q in the dkv pass): K step kk starts 16 rows down,
//    N block nb at column block nb; read with the transpose bit set.
//
// Fragments. The float32 accumulator of an m64n64 product: thread t of the
// warpgroup (warp w = t / 32, lane l) holds d[i] at row
// 16 w + l / 4 + 8 ((i / 2) % 2) and column 8 (i / 4) + 2 (l % 4) + i % 2.
// The RS form's A operand for K step kk is that accumulator's columns
// 16 kk .. 16 kk + 15 packed in pairs: {d[8kk], d[8kk+1]}, {d[8kk+2],
// d[8kk+3]}, {d[8kk+4], d[8kk+5]}, {d[8kk+6], d[8kk+7]}.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace spot::tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of (row r, column col) in a swizzled ROWS-row tile
template <int ROWS>
__device__ __forceinline__ uint32_t swz(int r, int col) {
  return (col >> 6) * (ROWS * 128) + r * 128 + ((((col & 63) >> 3) ^ (r & 7)) << 4) +
         ((col & 7) << 1);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  // src-size 0 fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// this thread's completed cp.async writes become visible to wgmma's reads
// (the async proxy); a barrier must follow before another thread's wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// rows [0, ROWS) x columns [0, CP) of a bf16 matrix (row stride `stride`
// values) into a swizzled tile; rows >= rows_valid and columns >= cols_valid
// are filled with zeros. Called by NT threads, thread index t.
template <int ROWS, int CP, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src,
                                          long long stride, int rows_valid,
                                          int cols_valid, int t) {
  constexpr int CH = CP / 8;  // 16-byte chunks per row
#pragma unroll 4
  for (int i = t; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = (i - r * CH) * 8;
    const bool ok = r < rows_valid && c < cols_valid;
    cp_async16(dst + swz<ROWS>(r, c), ok ? src + r * stride + c : src, ok);
  }
}

__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  constexpr uint64_t off = 1024 >> 4;  // both byte offsets (see above)
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (off << 16) | (off << 32) |
         (1ull << 62);  // layout 1: 128-byte swizzle
}
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc(tile + (kk >> 2) * (ROWS * 128) + (kk & 3) * 32);
}
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk, int nb) {
  return desc(tile + nb * (ROWS * 128) + kk * 16 * 128);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pins an accumulator register in place around the asynchronous product
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B, A from shared memory (K-major), B K-major
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B, A from registers (bf16 pairs), B MN-major (transposed)
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// x, y (a row's adjacent columns) as bf16 hi + lo pairs: hi = bf16(x),
// lo = bf16(x - hi), so that hi + lo carries x to about 2**-16 relative
__device__ __forceinline__ void split(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// the A operands of an m64n64 accumulator's four K steps, split hi + lo
__device__ __forceinline__ void split_frag(const float (&d)[32], uint32_t (&hi)[4][4],
                                           uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split(d[8 * kk + 2 * e], d[8 * kk + 2 * e + 1], hi[kk][e], lo[kk][e]);
}

}  // namespace spot::tc
