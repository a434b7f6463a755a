// Shared helpers for the port's elementwise/reduction kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace spot {

// element-type codes, shared with kernels/_lib.py::DTYPE_CODES
enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}

// float32 -> T, round to nearest even (the reference's astype)
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

inline bool aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) % a) == 0;
}

inline int grid_for(long long work, int threads, int max_blocks) {
  long long b = (work + threads - 1) / threads;
  if (b < 1) b = 1;
  if (b > max_blocks) b = max_blocks;
  return static_cast<int>(b);
}

}  // namespace spot
