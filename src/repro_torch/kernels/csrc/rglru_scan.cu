// RG-LRU scan: the gated diagonal linear recurrence h_t = a_t * h_{t-1} + b_t
// over the sequence, from h_{-1} = 0.
//
// Replaces src/repro/kernels/rglru_scan/rglru_scan.py (_rglru_kernel, via
// rglru_scan) -> spot_rglru_scan.
//
// What bounds it on an H100: bytes. Two multiply-adds' worth of work per
// element against a and b read once and h written once, so the floor is
// those bytes over the memory rate.
//
// Design: the recurrence is sequential in t and independent per (batch,
// channel), so each thread owns one channel of one batch row and walks the
// sequence; neighbouring threads own neighbouring channels, so every load
// and store of a warp is one contiguous span. The carry stays in a float32
// register. The step is a float32 multiply then add, each rounded on its
// own (__fmul_rn / __fadd_rn: no contraction into an fma), the same
// arithmetic as the plain sequential version, so the two agree bit for bit;
// the reference's log-depth associative scan differs from both by float32
// rounding. A TPU grid carried the state between chunks in scratch; here
// the loop inside the thread takes that place.
//
// Shapes: a, b (B, S, W), h (B, S, W) in a's type, h_last (B, W) float32;
// a and b float32 or bfloat16.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;

template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_kernel(const T* __restrict__ a, const T* __restrict__ b,
             T* __restrict__ h, float* __restrict__ h_last, int S, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int bi = blockIdx.y;
  if (w >= W) return;
  const long long base = (long long)bi * S * W + w;
  float carry = 0.f;
#pragma unroll 8
  for (int t = 0; t < S; ++t) {
    const long long i = base + (long long)t * W;
    carry = __fadd_rn(__fmul_rn(spot::to_f32<T>(a[i]), carry), spot::to_f32<T>(b[i]));
    h[i] = spot::from_f32<T>(carry);
  }
  h_last[(long long)bi * W + w] = carry;
}

template <typename T>
int launch(const void* a, const void* b, void* h, void* h_last, int B, int S,
           int W, cudaStream_t s) {
  const dim3 grid((W + THREADS - 1) / THREADS, B);
  rglru_kernel<T><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h),
      static_cast<float*>(h_last), S, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

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
