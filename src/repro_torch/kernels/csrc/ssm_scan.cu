// Selective scan (Mamba-1): the recurrence
//     h_t = exp(dt_t * A) * h_{t-1} + dt_t * u_t * B_t,   h_{-1} = 0
//     y_t = C_t . h_t + D * u_t
// per (batch row, channel), with N states per channel.
//
// Replaces src/repro/kernels/ssm_scan/ssm_scan.py (_ssm_kernel, via
// ssm_scan) -> spot_ssm_scan.
//
// What bounds it on an H100: the exponentials. Each (step, channel, state)
// needs exp(dt * A): N of them per step and channel against 3 values of
// u, dt and y moved, so the floor is the B * S * DI * N exponentials over
// the special-function units (16 per SM per clock, compute capability
// 9.0), above the bytes' floor of u, dt and y over the memory rate. Next
// to each exponential a state costs 5 float32 instructions (dt * A, two
// products, a sum, y's multiply-add), 128 a clock per SM: 0.31 of the
// exponentials' time. What the kernel reaches is about half the SFU rate:
// besides the exponential, each state costs its arithmetic and the
// widening of its bf16 B and C, and each step its loads, shuffle and y,
// and the SFU's busy time and that issue add up rather than overlap
// (moving exponentials to a polynomial on the float32 pipe made it
// slower).
//
// Design: the reference's log-depth associative scan inside a chunk is a
// TPU choice (its vector unit wants the channel dimension). Here the
// recurrence is sequential in t and independent per (batch row, channel):
//  * LANES (2) neighbouring lanes of a warp share one channel, each with
//    N / LANES = 8 of its states in float32 registers, so a CTA of 128
//    threads walks 64 channels of one batch row and falcon-mamba's prefill
//    keeps about 16 warps an SM busy (one lane a channel, staged the same
//    way, ran as fast on 8 warps; 4 lanes of 4 states, 31 warps, ran
//    slower on more instructions a state). y's sum over the states
//    closes with __shfl_xor_sync inside the lane pair, which gives both
//    lanes the same bits, so two calls agree bit for bit.
//  * The steps arrive by cp.async: u and dt (the CTA's 64 channels, one
//    contiguous span a step), B_t and C_t (read in their own dtype, rows
//    `ld_bc` values apart, so a view into the projection's output needs no
//    copy) are copied a chunk of steps at a time, in 16-byte copies, into a
//    double-buffered ring in shared memory: the next chunk lands while this
//    one is computed, and no step waits on device memory. y is staged in
//    the chunk's u slots (each step's u is read before its y is written)
//    and written back in 16-byte stores. Unaligned rows or a ragged edge
//    of channels take element copies.
//  * The exponential is exp2 on the special-function unit: A is scaled by
//    log2(e) once per thread, and exp(dt * A) is ex2.approx(dt * A log2 e):
//    one multiply and one MUFU, where expf costs about 8 more float32
//    instructions. Flushing a subnormal exp to zero moves nothing measurable
//    at the tolerances (1e-4, and one bf16 ulp).
//  * The state update is a multiply, a multiply and an add, each rounded
//    on its own (no contraction into an fma), as the plain sequential
//    version computes it; y's sum runs in another order than the plain
//    version's, so the two agree within float32 rounding. A TPU grid
//    carried the state between chunks in scratch; here the loop inside the
//    thread takes that place. No atomics: one writer per output.
//
// Shapes: u, dt (B, S, DI) float32 or bfloat16; A (DI, N), D (DI,)
// float32; B, C (B, S, N) float32 or u's dtype, step rows ld_bc apart
// (contiguous: N); y (B, S, DI) in u's type, h_last (B, DI, N) float32.
// Built for N = 16 (falcon-mamba's d_state).
#include "common.cuh"
#include "wgmma.cuh"

namespace {

using spot::tc::cp_async16;
using spot::tc::cp_async_commit;
using spot::tc::cp_async_wait;
using spot::tc::smem_u32;

constexpr int N = 16;          // states per channel
constexpr int LANES = 2;       // lanes per channel
constexpr int NS = N / LANES;  // states per lane
constexpr int THREADS = 128;
constexpr int CH = THREADS / LANES;   // channels per CTA
constexpr float LOG2E = 1.4426950408889634f;

// a chunk of 128 / sizeof(T) steps (64 bf16, 32 float32): 8 KB of u per
// stage either way, 40 KB of shared memory a CTA with B and C in bf16
template <typename T, typename TB>
struct Scan {
  static constexpr int TC = 128 / sizeof(T);    // steps per chunk
  static constexpr int VU = 16 / sizeof(T);     // u values per 16-byte copy
  static constexpr int PU = CH / VU;            // copies per step row of u
  static constexpr int VB = 16 / sizeof(TB);    // B values per 16-byte copy
  static constexpr int PB = N / VB;             // copies per step row of B
  struct Smem {
    alignas(16) T u[2][TC * CH];    // u in, then y out
    alignas(16) T d[2][TC * CH];
    alignas(16) TB b[2][TC * N];
    alignas(16) TB c[2][TC * N];
  };
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// M consecutive values of TB from shared memory, widened to float32
template <typename TB, int M>
__device__ __forceinline__ void load_vals(const TB* p, float* out) {
  if constexpr (sizeof(TB) == 4) {
#pragma unroll
    for (int i = 0; i < M; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      out[i] = v.x; out[i + 1] = v.y; out[i + 2] = v.z; out[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < M; i += 4) {
      const uint2 v = *reinterpret_cast<const uint2*>(p + i);
      out[i] = __uint_as_float(v.x << 16);
      out[i + 1] = __uint_as_float(v.x & 0xFFFF0000u);
      out[i + 2] = __uint_as_float(v.y << 16);
      out[i + 3] = __uint_as_float(v.y & 0xFFFF0000u);
    }
  }
}

// stage steps [t0, t0 + len) of batch row b into ring slot `st`
template <typename T, typename TB>
__device__ __forceinline__ void stage_chunk(typename Scan<T, TB>::Smem& sm, int st,
                                            const T* u, const T* dt, const TB* Bm,
                                            const TB* Cm, long long row0, int len,
                                            int c0, int DI, long long ld_bc,
                                            bool vec_ud, bool vec_bc) {
  using K = Scan<T, TB>;
  for (int i = threadIdx.x; i < len * K::PU; i += THREADS) {
    const int r = i / K::PU, c = c0 + (i % K::PU) * K::VU;
    const long long g = (row0 + r) * DI + c;
    T* su = &sm.u[st][r * CH + (i % K::PU) * K::VU];
    T* sd = &sm.d[st][r * CH + (i % K::PU) * K::VU];
    if (vec_ud && c + K::VU <= DI) {
      cp_async16(smem_u32(su), u + g, true);
      cp_async16(smem_u32(sd), dt + g, true);
    } else {
      for (int e = 0; e < K::VU; ++e) {
        const bool ok = c + e < DI;
        su[e] = ok ? u[g + e] : spot::from_f32<T>(0.f);
        sd[e] = ok ? dt[g + e] : spot::from_f32<T>(0.f);
      }
    }
  }
  for (int i = threadIdx.x; i < len * K::PB; i += THREADS) {
    const int r = i / K::PB, k = (i % K::PB) * K::VB;
    const long long g = (row0 + r) * ld_bc + k;
    TB* sb = &sm.b[st][r * N + k];
    TB* sc = &sm.c[st][r * N + k];
    if (vec_bc) {
      cp_async16(smem_u32(sb), Bm + g, true);
      cp_async16(smem_u32(sc), Cm + g, true);
    } else {
      for (int e = 0; e < K::VB; ++e) {
        sb[e] = Bm[g + e];
        sc[e] = Cm[g + e];
      }
    }
  }
}

// write the y values staged in ring slot `st` (steps [t0, t0 + len))
template <typename T, typename TB>
__device__ __forceinline__ void write_chunk(const typename Scan<T, TB>::Smem& sm, int st,
                                            T* y, long long row0, int len, int c0,
                                            int DI, bool vec_ud) {
  using K = Scan<T, TB>;
  for (int i = threadIdx.x; i < len * K::PU; i += THREADS) {
    const int r = i / K::PU, c = c0 + (i % K::PU) * K::VU;
    const long long g = (row0 + r) * DI + c;
    const T* sy = &sm.u[st][r * CH + (i % K::PU) * K::VU];
    if (vec_ud && c + K::VU <= DI) {
      *reinterpret_cast<uint4*>(y + g) = *reinterpret_cast<const uint4*>(sy);
    } else {
      for (int e = 0; e < K::VU && c + e < DI; ++e) y[g + e] = sy[e];
    }
  }
}

template <typename T, typename TB>
__global__ void __launch_bounds__(THREADS, 4)
ssm_kernel(const T* __restrict__ u, const T* __restrict__ dt,
           const float* __restrict__ A, const TB* __restrict__ Bm,
           const TB* __restrict__ Cm, const float* __restrict__ Dv,
           T* __restrict__ y, float* __restrict__ h_last, int S, int DI,
           long long ld_bc, bool vec_ud, bool vec_bc) {
  using K = Scan<T, TB>;
  __shared__ typename K::Smem sm;
  const int c0 = blockIdx.x * CH;
  const int b = blockIdx.y;
  const int lc = threadIdx.x / LANES;    // the lane group's channel in the CTA
  const int sub = threadIdx.x % LANES;   // which NS states of it
  const int ch = c0 + lc;
  const bool active = ch < DI;
  float a2[NS], h[NS];
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    a2[n] = active ? __fmul_rn(A[(long long)ch * N + sub * NS + n], LOG2E) : 0.f;
    h[n] = 0.f;
  }
  const float dd = active ? Dv[ch] : 0.f;
  const long long row_b = (long long)b * S;
  const int n_chunks = (S + K::TC - 1) / K::TC;

  stage_chunk<T, TB>(sm, 0, u, dt, Bm, Cm, row_b, min(K::TC, S), c0, DI, ld_bc,
                     vec_ud, vec_bc);
  cp_async_commit();
  for (int k = 0; k < n_chunks; ++k) {
    const int st = k & 1;
    const int t0 = k * K::TC;
    const int len = min(K::TC, S - t0);
    if (k + 1 < n_chunks)
      stage_chunk<T, TB>(sm, st ^ 1, u, dt, Bm, Cm, row_b + t0 + K::TC,
                         min(K::TC, S - t0 - K::TC), c0, DI, ld_bc, vec_ud, vec_bc);
    cp_async_commit();
    cp_async_wait<1>();   // chunk k has landed (chunk k + 1 may be in flight)
    __syncthreads();
    T* su = sm.u[st];
    const T* sd = sm.d[st];
    const TB* sb = sm.b[st];
    const TB* sc = sm.c[st];
#pragma unroll 2
    for (int t = 0; t < len; ++t) {
      const float uu = spot::to_f32<T>(su[t * CH + lc]);
      const float d = spot::to_f32<T>(sd[t * CH + lc]);
      float bv[NS], cv[NS];
      load_vals<TB, NS>(sb + t * N + sub * NS, bv);
      load_vals<TB, NS>(sc + t * N + sub * NS, cv);
      const float du = __fmul_rn(d, uu);
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float dA = ex2(__fmul_rn(d, a2[n]));
        h[n] = __fadd_rn(__fmul_rn(dA, h[n]), __fmul_rn(du, bv[n]));
        acc = fmaf(h[n], cv[n], acc);
      }
#pragma unroll
      for (int o = 1; o < LANES; o <<= 1) acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
      // every lane of the group has read this step's u (its sum needed it)
      if (sub == 0) su[t * CH + lc] = spot::from_f32<T>(__fadd_rn(acc, __fmul_rn(uu, dd)));
    }
    __syncthreads();   // the chunk's y is staged
    write_chunk<T, TB>(sm, st, y, row_b + t0, len, c0, DI, vec_ud);
    __syncthreads();   // slot st is free for chunk k + 2
  }
  if (active) {
    float* hl = h_last + ((long long)b * DI + ch) * N + sub * NS;
#pragma unroll
    for (int n = 0; n < NS; n += 4)
      *reinterpret_cast<float4*>(hl + n) = make_float4(h[n], h[n + 1], h[n + 2], h[n + 3]);
  }
}

template <typename T, typename TB>
int launch(const void* u, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* Dv, void* y, void* h_last, int B,
           int S, int DI, long long ld_bc, cudaStream_t s) {
  using K = Scan<T, TB>;
  const bool vec_ud = spot::aligned(u, 16) && spot::aligned(dt, 16) &&
                      spot::aligned(y, 16) && (DI * sizeof(T)) % 16 == 0;
  const bool vec_bc = spot::aligned(Bm, 16) && spot::aligned(Cm, 16) &&
                      (ld_bc * sizeof(TB)) % 16 == 0;
  const dim3 grid((DI + CH - 1) / CH, B);
  ssm_kernel<T, TB><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt),
      static_cast<const float*>(A), static_cast<const TB*>(Bm),
      static_cast<const TB*>(Cm), static_cast<const float*>(Dv),
      static_cast<T*>(y), static_cast<float*>(h_last), S, DI, ld_bc, vec_ud, vec_bc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launch layout at DI channels for dtype_code (B and C in the same
// dtype), written to out[5]: CTAs a batch row, threads a CTA, lanes a
// channel, steps a staged chunk, CTAs resident on an SM.
extern "C" int spot_ssm_scan_layout(int DI, int dtype_code, int* out) {
  int per_sm = 0;
  cudaError_t e;
  if (dtype_code == spot::kF32) {
    out[3] = Scan<float, float>::TC;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ssm_kernel<float, float>,
                                                      THREADS, 0);
  } else {
    out[3] = Scan<__nv_bfloat16, __nv_bfloat16>::TC;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ssm_kernel<__nv_bfloat16, __nv_bfloat16>, THREADS, 0);
  }
  out[0] = (DI + CH - 1) / CH;
  out[1] = THREADS;
  out[2] = LANES;
  out[4] = per_sm;
  return static_cast<int>(e);
}

// u, dt, y: dtype_code; B, C: bc_dtype_code (float32 or dtype_code), step
// rows ld_bc values apart, 16-byte copies where aligned.
extern "C" int spot_ssm_scan(const void* u, const void* dt, const void* A,
                             const void* Bm, const void* Cm, const void* Dv,
                             void* y, void* h_last, int B, int S, int DI,
                             int N_, long long ld_bc, int dtype_code,
                             int bc_dtype_code, void* stream) {
  if (N_ != N || ld_bc < N) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype_code == spot::kF32 && bc_dtype_code == spot::kF32)
    return launch<float, float>(u, dt, A, Bm, Cm, Dv, y, h_last, B, S, DI, ld_bc, s);
  if (dtype_code == spot::kBF16 && bc_dtype_code == spot::kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(u, dt, A, Bm, Cm, Dv, y, h_last, B, S,
                                                DI, ld_bc, s);
  if (dtype_code == spot::kBF16 && bc_dtype_code == spot::kF32)
    return launch<__nv_bfloat16, float>(u, dt, A, Bm, Cm, Dv, y, h_last, B, S, DI,
                                        ld_bc, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
