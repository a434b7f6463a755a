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
// pass each. absmax's first pass keeps more bytes in flight: each thread
// issues four independent 16-byte loads a trip (evict-first, __ldcs: the
// tensor is read once), in CTAs of 1024 threads over a grid of exactly the
// CTAs the card holds at once (its SMs times the kernel's occupancy,
// computed once). dequantize runs over its own resident grid too, four
// independent loads of 4 (float32) or 8 (bf16, f16) int8 a thread and
// trip, each widened into one 16-byte store, so a warp's loads and stores
// each cover one contiguous span. Its writes are 80% of its bytes; on the
// H100, 16-byte loads of int8 widened into four strided 16-byte stores,
// evict-first stores (__stcs) and CTAs of 1024 threads ran no faster.
//
// Bit-exactness with the host (checkpoint/serialize.py) is the contract:
//  * absmax is a max of non-negative floats, done on their uint32 bits
//    (monotonic for x >= 0), so it is exact in any order. A NaN, whose bits
//    after fabsf exceed +inf's, wins the max, which is np.max's NaN
//    propagation (fmaxf would drop it). Per-CTA partials, then a one-CTA
//    second pass, launched as a programmatic dependent of the first (it is
//    scheduled while the partials are computed and waits for them): no
//    atomics, deterministic.
//  * quantize multiplies by the host-computed float32 inverse (never
//    divides), rounds half to even (rintf == np.round), clips to +-127.
//  * dequantize widens int8 to float32, multiplies by the float32 scale and
//    rounds to the target with __float2bfloat16_rn / __float2half_rn, the
//    reference's round-to-nearest-even astype.
// Build without fast math: flushing subnormals would change absmax.
#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_PARTIALS = 1024;
constexpr int ABSMAX_THREADS = 1024;   // absmax's first pass: two CTAs an SM
constexpr int ABSMAX_LOADS = 4;        // independent 16-byte loads per thread and trip
constexpr int DEQ_THREADS = 256;       // dequantize: CTAs of 256 over the resident grid
constexpr int DEQ_LOADS = 4;           // independent loads per thread and trip

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

// max |x| bits over the 16 / sizeof(T) values of one 16-byte load
template <typename T>
__device__ __forceinline__ uint32_t abs_bits16(uint4 raw) {
  const T* e = reinterpret_cast<const T*>(&raw);
  uint32_t m = 0;
#pragma unroll
  for (int k = 0; k < 16 / (int)sizeof(T); ++k) m = max(m, abs_bits(spot::to_f32<T>(e[k])));
  return m;
}

template <typename T>
__global__ void __launch_bounds__(ABSMAX_THREADS)
absmax_partial_kernel(const T* __restrict__ x, long long n, bool vec,
                      uint32_t* __restrict__ partial) {
  // the final CTA may be scheduled now; it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  constexpr int VEC = 16 / sizeof(T);
  uint32_t m = 0;
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (vec) {
    const long long nv = n / VEC;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    long long i = tid;
    for (; i + (ABSMAX_LOADS - 1) * stride < nv; i += ABSMAX_LOADS * stride) {
      uint4 raw[ABSMAX_LOADS];
#pragma unroll
      for (int u = 0; u < ABSMAX_LOADS; ++u) raw[u] = __ldcs(xv + i + u * stride);
#pragma unroll
      for (int u = 0; u < ABSMAX_LOADS; ++u) m = max(m, abs_bits16<T>(raw[u]));
    }
    for (; i < nv; i += stride) m = max(m, abs_bits16<T>(__ldcs(xv + i)));
    done = nv * VEC;
  }
  for (long long i = done + tid; i < n; i += stride)
    m = max(m, abs_bits(spot::to_f32<T>(x[i])));
  m = block_max(m);
  if (threadIdx.x == 0) partial[blockIdx.x] = m;
}

// launched as a programmatic dependent of the partials' grid: scheduled
// while that grid runs, it waits here until the partials are written
__global__ void absmax_final_kernel(const uint32_t* __restrict__ partial, int n,
                                    float* __restrict__ out) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
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

// One load of VEC int8 widened to VEC values of T: one 16-byte store
template <typename T>
using DeqIn = typename std::conditional<sizeof(T) == 4, uint32_t, uint2>::type;

template <typename T>
__device__ __forceinline__ uint4 widen(DeqIn<T> raw, float scale) {
  constexpr int VEC = 16 / sizeof(T);
  const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
  alignas(16) T vals[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) vals[k] = spot::from_f32<T>(static_cast<float>(e[k]) * scale);
  return *reinterpret_cast<const uint4*>(vals);
}

template <typename T>
__global__ void __launch_bounds__(DEQ_THREADS)
dequantize_kernel(const int8_t* __restrict__ q, long long n, float scale,
                  bool vec, T* __restrict__ out) {
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (vec) {
    // each load of VEC int8 (4 for float32, 8 for bf16/f16) becomes one
    // 16-byte store, so a warp's loads and its stores each cover one
    // contiguous span; DEQ_LOADS independent loads a thread and trip
    constexpr int VEC = 16 / sizeof(T);
    const long long nv = n / VEC;
    const DeqIn<T>* qv = reinterpret_cast<const DeqIn<T>*>(q);
    uint4* ov = reinterpret_cast<uint4*>(out);
    long long i = tid;
    for (; i + (DEQ_LOADS - 1) * stride < nv; i += DEQ_LOADS * stride) {
      DeqIn<T> raw[DEQ_LOADS];
#pragma unroll
      for (int u = 0; u < DEQ_LOADS; ++u) raw[u] = __ldcs(qv + i + u * stride);
#pragma unroll
      for (int u = 0; u < DEQ_LOADS; ++u) ov[i + u * stride] = widen<T>(raw[u], scale);
    }
    for (; i < nv; i += stride) ov[i] = widen<T>(__ldcs(qv + i), scale);
    done = nv * VEC;
  }
  for (long long i = done + tid; i < n; i += stride)
    out[i] = spot::from_f32<T>(static_cast<float>(q[i]) * scale);
}

int blocks_for(long long n) { return spot::grid_for(n / 8 + 1, THREADS, 132 * 16); }

// absmax's first-pass grid on a large tensor: every CTA resident at once
template <typename T>
int absmax_resident_grid() {
  static const int grid = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, absmax_partial_kernel<T>,
                                                  ABSMAX_THREADS, 0);
    return std::min(std::max(sms * per_sm, 1), MAX_PARTIALS);
  }();
  return grid;
}

// dequantize's grid: every CTA resident at once
template <typename T>
int dequantize_resident_grid() {
  static const int grid = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dequantize_kernel<T>,
                                                  DEQ_THREADS, 0);
    return std::max(sms * per_sm, 1);
  }();
  return grid;
}

int dequantize_grid(int dtype_code) {
  switch (dtype_code) {
    case spot::kF32: return dequantize_resident_grid<float>();
    case spot::kBF16: return dequantize_resident_grid<__nv_bfloat16>();
    case spot::kF16: return dequantize_resident_grid<__half>();
    default: return -1;
  }
}

int absmax_grid(int dtype_code) {
  switch (dtype_code) {
    case spot::kF32: return absmax_resident_grid<float>();
    case spot::kBF16: return absmax_resident_grid<__nv_bfloat16>();
    case spot::kF16: return absmax_resident_grid<__half>();
    default: return -1;
  }
}

}  // namespace

// The grid absmax's first pass takes on a large tensor of dtype_code (-1
// for a dtype it does not take); a trip of it reads grid * 1024 threads *
// 4 loads * 16 bytes.
extern "C" int spot_absmax_grid(int dtype_code) { return absmax_grid(dtype_code); }

// x: n elements of dtype_code; partial: uint32[n_partial] scratch
// (n_partial <= 1024); out: float32[1]. Two launches (partials, final).
extern "C" int spot_absmax(const void* x, long long n, int dtype_code,
                           void* partial, int n_partial, void* out,
                           void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int resident = absmax_grid(dtype_code);
  if (resident < 1) return static_cast<int>(cudaErrorInvalidValue);
  // elements one CTA reads in a trip: at most one trip per CTA on a small x
  const int per_cta = ABSMAX_THREADS * ABSMAX_LOADS * 16 / (dtype_code == spot::kF32 ? 4 : 2);
  const int grid = spot::grid_for(n, per_cta, std::min(resident, n_partial));
  const bool vec = spot::aligned(x, 16);
  auto* p = static_cast<uint32_t*>(partial);
  switch (dtype_code) {
    case spot::kF32:
      absmax_partial_kernel<float><<<grid, ABSMAX_THREADS, 0, s>>>(
          static_cast<const float*>(x), n, vec, p);
      break;
    case spot::kBF16:
      absmax_partial_kernel<__nv_bfloat16><<<grid, ABSMAX_THREADS, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), n, vec, p);
      break;
    case spot::kF16:
      absmax_partial_kernel<__half><<<grid, ABSMAX_THREADS, 0, s>>>(
          static_cast<const __half*>(x), n, vec, p);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(1024);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, absmax_final_kernel,
                                           static_cast<const uint32_t*>(p), grid,
                                           static_cast<float*>(out));
  if (e != cudaSuccess) return static_cast<int>(e);
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

// dequantize's layout for a target dtype_code, written to out[4]: CTAs
// of the resident grid, threads a CTA, loads a thread and trip, values a
// load.
extern "C" int spot_dequantize_layout(int dtype_code, int* out) {
  out[0] = dequantize_grid(dtype_code);
  if (out[0] < 1) return static_cast<int>(cudaErrorInvalidValue);
  out[1] = DEQ_THREADS;
  out[2] = DEQ_LOADS;
  out[3] = dtype_code == spot::kF32 ? 4 : 8;
  return 0;
}

extern "C" int spot_dequantize(const void* q, long long n, float scale,
                               int dtype_code, void* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int resident = dequantize_grid(dtype_code);
  if (resident < 1) return static_cast<int>(cudaErrorInvalidValue);
  // values one CTA widens in a trip: at most one trip per CTA on a small q
  const int grid = spot::grid_for(
      n, DEQ_THREADS * DEQ_LOADS * (dtype_code == spot::kF32 ? 4 : 8), resident);
  const bool vec = spot::aligned(q, 16) && spot::aligned(out, 16);
  const auto* qi = static_cast<const int8_t*>(q);
  switch (dtype_code) {
    case spot::kF32:
      dequantize_kernel<float><<<grid, DEQ_THREADS, 0, s>>>(
          qi, n, scale, vec, static_cast<float*>(out));
      break;
    case spot::kBF16:
      dequantize_kernel<__nv_bfloat16><<<grid, DEQ_THREADS, 0, s>>>(
          qi, n, scale, vec, static_cast<__nv_bfloat16*>(out));
      break;
    case spot::kF16:
      dequantize_kernel<__half><<<grid, DEQ_THREADS, 0, s>>>(
          qi, n, scale, vec, static_cast<__half*>(out));
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
