// absmax-int8 quantize / dequantize: the checkpoint path's device halves.
//
// Replaces (src/repro/kernels/quantize/quantize.py):
//   _absmax_kernel   (absmax_2d)     -> spot_absmax
//   _quantize_kernel (quantize_2d)   -> spot_quantize
//   _dequant_kernel  (dequantize_2d) -> spot_dequantize
//
// All three are bound by bytes: one read of the input and one write of the
// output, no reuse, so the floor on an H100 SXM is (bytes in + bytes out) /
// 3.35 TB/s. Design: grid-stride loops in which each thread moves 16 bytes
// of the wider side per iteration (16-byte loads of the float input for
// absmax and quantize, 16-byte stores of the float output for dequantize),
// so every warp access is one contiguous span; scalar accesses for the
// ragged tail or a misaligned pointer; float32 arithmetic in registers; one
// pass each.
//
// Bit-exactness with the host (checkpoint/serialize.py) is the contract:
//  * absmax is a max of non-negative floats, done on their uint32 bits
//    (monotonic for x >= 0), so it is exact in any order. A NaN, whose bits
//    after fabsf exceed +inf's, wins the max, which is np.max's NaN
//    propagation (fmaxf would drop it). Per-CTA partials, then a one-CTA
//    second pass: no atomics, deterministic.
//  * quantize multiplies by the host-computed float32 inverse (never
//    divides), rounds half to even (rintf == np.round), clips to +-127.
//  * dequantize widens int8 to float32, multiplies by the float32 scale and
//    rounds to the target with __float2bfloat16_rn / __float2half_rn, the
//    reference's round-to-nearest-even astype.
// Build without fast math: flushing subnormals would change absmax.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_PARTIALS = 1024;

__device__ __forceinline__ uint32_t warp_max(uint32_t v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

// block-wide max of uint32; result valid in thread 0
__device__ __forceinline__ uint32_t block_max(uint32_t v) {
  __shared__ uint32_t warp_vals[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) warp_vals[warp] = v;
  __syncthreads();
  const int n_warps = (blockDim.x + 31) >> 5;
  v = (threadIdx.x < n_warps) ? warp_vals[threadIdx.x] : 0u;
  if (warp == 0) v = warp_max(v);
  return v;
}

__device__ __forceinline__ uint32_t abs_bits(float f) {
  return __float_as_uint(fabsf(f));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
absmax_partial_kernel(const T* __restrict__ x, long long n, bool vec,
                      uint32_t* __restrict__ partial) {
  constexpr int VEC = 16 / sizeof(T);
  uint32_t m = 0;
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (vec) {
    const long long nv = n / VEC;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    for (long long i = tid; i < nv; i += stride) {
      const uint4 raw = xv[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < VEC; ++k) m = max(m, abs_bits(spot::to_f32<T>(e[k])));
    }
    done = nv * VEC;
  }
  for (long long i = done + tid; i < n; i += stride)
    m = max(m, abs_bits(spot::to_f32<T>(x[i])));
  m = block_max(m);
  if (threadIdx.x == 0) partial[blockIdx.x] = m;
}

__global__ void absmax_final_kernel(const uint32_t* __restrict__ partial, int n,
                                    float* __restrict__ out) {
  uint32_t m = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) m = max(m, partial[i]);
  m = block_max(m);
  if (threadIdx.x == 0) out[0] = __uint_as_float(m);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
quantize_kernel(const T* __restrict__ x, long long n, float inv, bool vec,
                int8_t* __restrict__ q) {
  constexpr int VEC = 16 / sizeof(T);
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (vec) {
    const long long nv = n / VEC;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    for (long long i = tid; i < nv; i += stride) {
      const uint4 raw = xv[i];
      const T* e = reinterpret_cast<const T*>(&raw);
      alignas(16) int8_t out[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        float r = rintf(spot::to_f32<T>(e[k]) * inv);
        r = fminf(fmaxf(r, -127.0f), 127.0f);
        out[k] = static_cast<int8_t>(static_cast<int>(r));
      }
      int8_t* dst = q + i * VEC;
      if constexpr (VEC == 4)
        *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(out);
      else
        *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(out);
    }
    done = nv * VEC;
  }
  for (long long i = done + tid; i < n; i += stride) {
    float r = rintf(spot::to_f32<T>(x[i]) * inv);
    r = fminf(fmaxf(r, -127.0f), 127.0f);
    q[i] = static_cast<int8_t>(static_cast<int>(r));
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dequantize_kernel(const int8_t* __restrict__ q, long long n, float scale,
                  bool vec, T* __restrict__ out) {
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (vec) {
    // one 16-byte store of outputs per thread and iteration (4 f32 or 8
    // bf16/f16 from a 4- or 8-byte load of int8), so a warp's stores cover
    // one contiguous 512-byte span
    constexpr int VEC = 16 / sizeof(T);
    using In = typename std::conditional<VEC == 4, uint32_t, uint2>::type;
    const long long nv = n / VEC;
    const In* qv = reinterpret_cast<const In*>(q);
    for (long long i = tid; i < nv; i += stride) {
      const In raw = qv[i];
      const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
      alignas(16) T vals[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        vals[k] = spot::from_f32<T>(static_cast<float>(e[k]) * scale);
      reinterpret_cast<uint4*>(out)[i] = *reinterpret_cast<const uint4*>(vals);
    }
    done = nv * VEC;
  }
  for (long long i = done + tid; i < n; i += stride)
    out[i] = spot::from_f32<T>(static_cast<float>(q[i]) * scale);
}

int blocks_for(long long n) { return spot::grid_for(n / 8 + 1, THREADS, 132 * 16); }

}  // namespace

// x: n elements of dtype_code; partial: uint32[n_partial] scratch
// (n_partial <= 1024); out: float32[1]. Two launches (partials, final).
extern "C" int spot_absmax(const void* x, long long n, int dtype_code,
                           void* partial, int n_partial, void* out,
                           void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  int grid = spot::grid_for(n / 16 + 1, THREADS, n_partial);
  if (grid > MAX_PARTIALS) grid = MAX_PARTIALS;
  const bool vec = spot::aligned(x, 16);
  auto* p = static_cast<uint32_t*>(partial);
  switch (dtype_code) {
    case spot::kF32:
      absmax_partial_kernel<float><<<grid, THREADS, 0, s>>>(
          static_cast<const float*>(x), n, vec, p);
      break;
    case spot::kBF16:
      absmax_partial_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), n, vec, p);
      break;
    case spot::kF16:
      absmax_partial_kernel<__half><<<grid, THREADS, 0, s>>>(
          static_cast<const __half*>(x), n, vec, p);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  absmax_final_kernel<<<1, 1024, 0, s>>>(p, grid, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spot_quantize(const void* x, long long n, int dtype_code,
                             float inv, void* q, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int grid = blocks_for(n);
  const bool vec = spot::aligned(x, 16) && spot::aligned(q, 16);
  auto* qo = static_cast<int8_t*>(q);
  switch (dtype_code) {
    case spot::kF32:
      quantize_kernel<float><<<grid, THREADS, 0, s>>>(
          static_cast<const float*>(x), n, inv, vec, qo);
      break;
    case spot::kBF16:
      quantize_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), n, inv, vec, qo);
      break;
    case spot::kF16:
      quantize_kernel<__half><<<grid, THREADS, 0, s>>>(
          static_cast<const __half*>(x), n, inv, vec, qo);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spot_dequantize(const void* q, long long n, float scale,
                               int dtype_code, void* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int grid = blocks_for(n);
  const bool vec = spot::aligned(q, 16) && spot::aligned(out, 16);
  const auto* qi = static_cast<const int8_t*>(q);
  switch (dtype_code) {
    case spot::kF32:
      dequantize_kernel<float><<<grid, THREADS, 0, s>>>(
          qi, n, scale, vec, static_cast<float*>(out));
      break;
    case spot::kBF16:
      dequantize_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
          qi, n, scale, vec, static_cast<__nv_bfloat16*>(out));
      break;
    case spot::kF16:
      dequantize_kernel<__half><<<grid, THREADS, 0, s>>>(
          qi, n, scale, vec, static_cast<__half*>(out));
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
