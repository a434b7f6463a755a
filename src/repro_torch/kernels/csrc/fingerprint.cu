// Per-block fingerprint digest (+ optional diff against the previous save).
//
// Replaces: src/repro/kernels/fingerprint/fingerprint.py::_fingerprint_kernel
// (the Pallas TPU kernel reached through fingerprint_blocks_2d and
// kernels/fingerprint/ops.py::fingerprint_blocks / fingerprint_diff).
//
// Computes, for every `block_bytes` window of a tensor's raw bytes, one
// uint32 digest: words are the block's native-width elements zero-extended
// to uint32 (1/2/4-byte dtypes; 8-byte dtypes as two uint32 halves),
//   h_i = ((w_i ^ (i * C1)) * C2);  h_i ^= h_i >> 15
//   digest = fmix32(sum_i h_i mod 2^32)
// bit-for-bit the reference (kernels/fingerprint/ref.py). Positions run over
// all words_per_block slots: the tail block's zero padding counts, because
// mix(0, i) is not 0.
//
// Bound: bytes. Each input byte is read once and the outputs are 4-5 bytes
// per block, so the floor is nbytes / 3.35 TB/s on an H100 SXM. Design: one
// CTA per block; threads stride over the block in 16-byte loads (uint4) when
// the pointer and block size allow, each load split into words in
// registers — the reference's full-size uint32 word temporary
// (fingerprint/ops.py:76-82) never exists. The 32-bit sum wraps, so any
// reduction order gives the same digest: warp shuffles, then one thread
// folds the warp sums and applies fmix32. The diff against `old` is written
// by the same thread, in the same launch.
#include "common.cuh"

namespace {

constexpr uint32_t C1 = 0x9E3779B1u;
constexpr uint32_t C2 = 0x85EBCA6Bu;
constexpr uint32_t F1 = 0x85EBCA6Bu;
constexpr uint32_t F2 = 0xC2B2AE35u;
constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t mix(uint32_t w, uint32_t pos) {
  uint32_t h = (w ^ (pos * C1)) * C2;
  return h ^ (h >> 15);
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= F1;
  h ^= h >> 13;
  h *= F2;
  h ^= h >> 16;
  return h;
}

// mixed sum of the words inside 4-byte group `g` of a block
__device__ __forceinline__ uint32_t mix_group(uint32_t v, uint32_t g, int wb) {
  if (wb == 4) return mix(v, g);
  if (wb == 2) {
    const uint32_t p = g * 2u;
    return mix(v & 0xFFFFu, p) + mix(v >> 16, p + 1u);
  }
  const uint32_t p = g * 4u;
  return mix(v & 0xFFu, p) + mix((v >> 8) & 0xFFu, p + 1u) +
         mix((v >> 16) & 0xFFu, p + 2u) + mix(v >> 24, p + 3u);
}

// 4-byte group at byte offset `off` (zero past the end of the tensor)
__device__ __forceinline__ uint32_t load_group(const uint8_t* x, long long off,
                                               long long nbytes) {
  if (off + 4 <= nbytes) return *reinterpret_cast<const uint32_t*>(x + off);
  uint32_t v = 0;
  for (int i = 0; i < 4; ++i)
    if (off + i < nbytes) v |= uint32_t(x[off + i]) << (8 * i);
  return v;
}

template <bool VEC16>
__global__ void __launch_bounds__(THREADS)
fingerprint_kernel(const uint8_t* __restrict__ x, long long nbytes, int wb,
                   long long block_bytes, uint32_t* __restrict__ out,
                   const uint32_t* __restrict__ old, uint8_t* __restrict__ diff) {
  const long long b = blockIdx.x;
  const long long base = b * block_bytes;
  uint32_t acc = 0;
  if (VEC16) {
    const long long n16 = block_bytes >> 4;
    for (long long j = threadIdx.x; j < n16; j += THREADS) {
      const long long off = base + (j << 4);
      const uint32_t g = uint32_t(j) * 4u;
      if (off + 16 <= nbytes) {
        const uint4 v = *reinterpret_cast<const uint4*>(x + off);
        acc += mix_group(v.x, g, wb) + mix_group(v.y, g + 1u, wb) +
               mix_group(v.z, g + 2u, wb) + mix_group(v.w, g + 3u, wb);
      } else {
        for (int k = 0; k < 4; ++k)
          acc += mix_group(load_group(x, off + 4 * k, nbytes), g + k, wb);
      }
    }
  } else {
    const long long n4 = block_bytes >> 2;
    for (long long j = threadIdx.x; j < n4; j += THREADS)
      acc += mix_group(load_group(x, base + (j << 2), nbytes), uint32_t(j), wb);
  }
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  __shared__ uint32_t warp_sums[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t s = 0;
    for (int w = 0; w < THREADS / 32; ++w) s += warp_sums[w];
    const uint32_t fp = fmix32(s);
    out[b] = fp;
    if (diff != nullptr) diff[b] = fp != old[b] ? 1 : 0;
  }
}

}  // namespace

// x: raw bytes of the tensor (4-byte aligned); out: uint32[n_blocks];
// old/diff: both NULL, or uint32[n_blocks] / bool[n_blocks]. Returns
// cudaGetLastError() after the launch.
extern "C" int spot_fingerprint(const void* x, long long nbytes, int itemsize,
                                long long block_bytes, long long n_blocks,
                                void* out, const void* old, void* diff,
                                void* stream) {
  if (n_blocks <= 0) return 0;
  const int wb = itemsize < 4 ? itemsize : 4;
  const bool vec16 = (block_bytes % 16 == 0) && spot::aligned(x, 16);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const uint8_t*>(x);
  auto* o = static_cast<uint32_t*>(out);
  const auto* od = static_cast<const uint32_t*>(old);
  auto* d = static_cast<uint8_t*>(diff);
  if (vec16)
    fingerprint_kernel<true><<<n_blocks, THREADS, 0, s>>>(xb, nbytes, wb,
                                                          block_bytes, o, od, d);
  else
    fingerprint_kernel<false><<<n_blocks, THREADS, 0, s>>>(xb, nbytes, wb,
                                                           block_bytes, o, od, d);
  return static_cast<int>(cudaGetLastError());
}
