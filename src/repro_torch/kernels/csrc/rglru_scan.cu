// RG-LRU scan: the gated diagonal linear recurrence h_t = a_t * h_{t-1} + b_t
// over the sequence, from h_{-1} = 0.
//
// Replaces src/repro/kernels/rglru_scan/rglru_scan.py (_rglru_kernel, via
// rglru_scan) -> spot_rglru_scan.
//
// What bounds it on an H100: bytes. Two float32 operations per element
// against a and b read once and h written once, so the floor is those
// bytes over the memory rate. The chain itself is short: S dependent
// multiply-adds per channel (1984 at recurrentgemma-2b's prefill, about 8
// us), a tenth of the bytes' floor, so the recurrence stays sequential per
// channel and the design is about keeping bytes in flight on every SM.
//
// Design:
//  * A CTA is one warp that owns 32 contiguous channels of one batch row,
//    one thread a channel (128 bytes a float32 step row, 64 bfloat16): the
//    grid is B x ceil(W / 32), 320 CTAs at (4, ., 2560), so every one of
//    the 132 SMs walks channels (one thread a channel in CTAs of 128 gave
//    80 CTAs, and each thread read its own channel from device memory).
//  * a and b arrive TS steps at a time (64 float32, 128 bfloat16: 8 KB of
//    each a chunk) through a ring of STAGES = 3 slots in shared memory
//    (48 KB, four CTAs an SM), by 16-byte cp.async copies: two chunks, 32
//    KB, are in flight while one is computed.
//  * Thread c walks its channel down the staged rows; neighbouring threads
//    read neighbouring words, so no bank conflicts. The next U steps' a and
//    b are read into registers while the current U are chained, so the
//    chain never waits on shared memory. h is staged in the chunk's a slots
//    (each step's a is read before its h is written) and written back in
//    16-byte stores; h_last from the carry.
//  * A row that is not a whole number of 16-byte copies, a tail CTA's
//    missing channels and a base that is not 16-byte aligned take element
//    copies: each thread moves its own channel's values.
//  Measured on the H100 (throwaway builds, not kept): 64 or 128 channels a
//  CTA, 2 or 4 slots, and longer chunks that need shared memory beyond 48
//  KB ran no faster, or slower where fewer CTAs fit on an SM.
// The step is a float32 multiply then add, each rounded on its own
// (__fmul_rn / __fadd_rn: no contraction into an fma), the same arithmetic
// as the plain sequential version, so the two agree bit for bit; the
// sequence is never split, since a two-level scan would round otherwise.
// The reference's log-depth associative scan differs from both by float32
// rounding. A TPU grid carried the state between chunks in scratch; here
// the loop inside the thread takes that place.
//
// Shapes: a, b (B, S, W), h (B, S, W) in a's type, h_last (B, W) float32;
// a and b float32 or bfloat16.
#include "common.cuh"
#include "wgmma.cuh"

namespace {

using spot::tc::cp_async16;
using spot::tc::cp_async_commit;
using spot::tc::cp_async_wait;
using spot::tc::smem_u32;

constexpr int C = 32;       // channels a CTA: one warp, one thread a channel
constexpr int STAGES = 3;   // ring slots: two chunks in flight, one computed
constexpr int U = 8;        // steps read ahead into registers

// A chunk holds 8 KB of a and 8 KB of b: 64 float32 steps, 128 bfloat16;
// the ring 48 KB, four CTAs an SM
template <typename T>
struct Lru {
  static constexpr int TS = 256 / sizeof(T);   // steps a staged chunk
  static constexpr int VEC = 16 / sizeof(T);   // values a 16-byte copy
  static constexpr int PR = C / VEC;           // copies a step row
  static constexpr int SMEM = STAGES * 2 * TS * C * sizeof(T);   // a, b ring
  static_assert(TS % U == 0 && SMEM <= 48 * 1024, "the ring fits without an opt-in");
};

// stage steps [row0, row0 + len) of the CTA's channels into a slot; g0 is
// the index of (row0, c0), cw the CTA's channels in range
template <typename T>
__device__ __forceinline__ void stage_chunk(T* sa, T* sb, const T* a, const T* b,
                                            long long g0, int len, int cw, int W,
                                            bool vec) {
  using K = Lru<T>;
  if (vec) {
    // cw * sizeof(T) is a multiple of 16 here, so a copy is in range or out
    for (int i = threadIdx.x; i < len * K::PR; i += C) {
      const int r = i / K::PR, j = (i % K::PR) * K::VEC;
      if (j < cw) {
        const long long g = g0 + (long long)r * W + j;
        cp_async16(smem_u32(sa + r * C + j), a + g, true);
        cp_async16(smem_u32(sb + r * C + j), b + g, true);
      }
    }
  } else if ((int)threadIdx.x < cw) {
    const long long g = g0 + threadIdx.x;
    for (int r = 0; r < len; ++r) {
      sa[r * C + threadIdx.x] = a[g + (long long)r * W];
      sb[r * C + threadIdx.x] = b[g + (long long)r * W];
    }
  }
}

// write the h values staged in a slot back to steps [row0, row0 + len)
template <typename T>
__device__ __forceinline__ void write_chunk(const T* sh, T* h, long long g0, int len,
                                            int cw, int W, bool vec) {
  using K = Lru<T>;
  if (vec) {
    for (int i = threadIdx.x; i < len * K::PR; i += C) {
      const int r = i / K::PR, j = (i % K::PR) * K::VEC;
      if (j < cw)
        *reinterpret_cast<uint4*>(h + g0 + (long long)r * W + j) =
            *reinterpret_cast<const uint4*>(sh + r * C + j);
    }
  } else if ((int)threadIdx.x < cw) {
    const long long g = g0 + threadIdx.x;
    for (int r = 0; r < len; ++r) h[g + (long long)r * W] = sh[r * C + threadIdx.x];
  }
}

template <typename T>
__global__ void __launch_bounds__(C)
rglru_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ h,
             float* __restrict__ h_last, int S, int W, bool vec) {
  constexpr int TS = Lru<T>::TS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);   // slot s: a at 2s, b at 2s + 1
  const int c = threadIdx.x;
  const int c0 = blockIdx.x * C;
  const int cw = min(C, W - c0);
  const long long base = (long long)blockIdx.y * S * W + c0;
  const int n_chunks = (S + TS - 1) / TS;
  auto slot_a = [&](int k) { return ring + (2 * (k % STAGES)) * TS * C; };
  auto slot_b = [&](int k) { return ring + (2 * (k % STAGES) + 1) * TS * C; };

#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < n_chunks)
      stage_chunk<T>(slot_a(k), slot_b(k), a, b, base + (long long)k * TS * W,
                     min(TS, S - k * TS), cw, W, vec);
    cp_async_commit();
  }
  float carry = 0.f;
  for (int k = 0; k < n_chunks; ++k) {
    const int pre = k + STAGES - 1;
    if (pre < n_chunks)
      stage_chunk<T>(slot_a(pre), slot_b(pre), a, b, base + (long long)pre * TS * W,
                     min(TS, S - pre * TS), cw, W, vec);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();   // chunk k has landed
    __syncthreads();
    const int len = min(TS, S - k * TS);
    T* sa = slot_a(k);
    const T* sb = slot_b(k);
    float av[U], bv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      av[u] = spot::to_f32<T>(sa[u * C + c]);
      bv[u] = spot::to_f32<T>(sb[u * C + c]);
    }
    for (int t = 0; t < len; t += U) {
      // the next U steps' values (rows past len hold stale data, unused)
      float an[U], bn[U];
      if (t + U < TS) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          an[u] = spot::to_f32<T>(sa[(t + U + u) * C + c]);
          bn[u] = spot::to_f32<T>(sb[(t + U + u) * C + c]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (t + u < len) {
          carry = __fadd_rn(__fmul_rn(av[u], carry), bv[u]);
          sa[(t + u) * C + c] = spot::from_f32<T>(carry);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        av[u] = an[u];
        bv[u] = bn[u];
      }
    }
    __syncthreads();   // the chunk's h is staged
    write_chunk<T>(sa, h, base + (long long)k * TS * W, len, cw, W, vec);
    __syncthreads();   // the slot is free for chunk k + STAGES
  }
  if (c < cw) h_last[(long long)blockIdx.y * W + c0 + c] = carry;
}

template <typename T>
int launch(const void* a, const void* b, void* h, void* h_last, int B, int S, int W,
           cudaStream_t s) {
  const bool vec = spot::aligned(a, 16) && spot::aligned(b, 16) && spot::aligned(h, 16) &&
                   ((long long)W * sizeof(T)) % 16 == 0;
  const dim3 grid((W + C - 1) / C, B);
  rglru_kernel<T><<<grid, C, Lru<T>::SMEM, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h),
      static_cast<float*>(h_last), S, W, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int layout(int B, int W, int* out) {
  int per_sm = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, rglru_kernel<T>, C, Lru<T>::SMEM);
  out[0] = C;
  out[1] = Lru<T>::TS;
  out[2] = STAGES;
  out[3] = B * ((W + C - 1) / C);
  out[4] = Lru<T>::SMEM;
  out[5] = per_sm;
  return static_cast<int>(e);
}

}  // namespace

// The launch layout at (B, ., W) for dtype_code, written to out[6]:
// channels a CTA (its threads), steps a staged chunk, ring slots, CTAs,
// dynamic shared memory bytes a CTA, CTAs resident on an SM.
extern "C" int spot_rglru_scan_layout(int B, int W, int dtype_code, int* out) {
  switch (dtype_code) {
    case spot::kF32: return layout<float>(B, W, out);
    case spot::kBF16: return layout<__nv_bfloat16>(B, W, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int spot_rglru_scan(const void* a, const void* b, void* h,
                               void* h_last, int B, int S, int W,
                               int dtype_code, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case spot::kF32: return launch<float>(a, b, h, h_last, B, S, W, s);
    case spot::kBF16: return launch<__nv_bfloat16>(a, b, h, h_last, B, S, W, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
