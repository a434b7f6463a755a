// Per-block fingerprint digest (+ optional diff against the previous save).
//
// Replaces: src/repro/kernels/fingerprint/fingerprint.py::_fingerprint_kernel
// (the Pallas TPU kernel reached through fingerprint_blocks_2d and
// kernels/fingerprint/ops.py::fingerprint_blocks / fingerprint_diff)
//   -> spot_fingerprint_partials (the slices' sums) + spot_fingerprint_final
//      (each block's sum, fmix32, digest and diff).
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
// per block, so the floor is nbytes / 3.35 TB/s on an H100 SXM. The integer
// work is about 6 operations a word (Hopper issues 32-bit integer multiply,
// shift and logic at 64 a clock per SM): under the byte floor for 2- and
// 4-byte words, above it for int8's four words per 4 bytes.
//
// Design, for an even spread of bytes over the SMs and many in flight:
//  * Each block is cut into fixed slices of `slice_bytes` (the wrapper's
//    64 KiB: 1024 threads x 4 loads x 16 bytes, one trip); a block smaller
//    than a slice is one slice. A resident grid (the SMs times the
//    kernel's occupancy, two 1024-thread CTAs an SM) strides over the
//    (block, slice) pairs, so the work is even whatever the block count.
//  * Each thread issues four independent 16-byte evict-first loads
//    (__ldcs: the tensor is read once) a trip, when the pointer and the
//    block size allow; a 4-byte path takes views off a 16-byte boundary,
//    and a byte-wise one the ragged tail of the tensor.
//  * Each slice writes the wrapping uint32 sum of its mixed words, their
//    positions counted from the block's first word, to its own slot. A
//    second kernel, launched as a programmatic dependent (scheduled while
//    the slices run, it waits with griddepcontrol.wait), sums each block's
//    slots in order, applies fmix32 and writes the digest and the diff.
//    The sum wraps mod 2^32, so any split gives the reference's bits; one
//    writer per output and no atomics.
//  * Little integer work a word: a 16-byte load's positions times C1 step
//    by a constant from one product, each mask folds into its xor (one
//    three-input logic op), and the halves' sums share a three-operand add.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr uint32_t C1 = 0x9E3779B1u;
constexpr uint32_t C2 = 0x85EBCA6Bu;
constexpr uint32_t F1 = 0x85EBCA6Bu;
constexpr uint32_t F2 = 0xC2B2AE35u;
constexpr int THREADS = 1024;      // two CTAs an SM
constexpr int LOADS = 4;           // independent loads per thread and trip
constexpr int FINAL_THREADS = 256;
constexpr int MAX_GRID = 1024;

// mix of word w at a position whose product with C1 is pc
__device__ __forceinline__ uint32_t mixp(uint32_t w, uint32_t pc) {
  const uint32_t h = (w ^ pc) * C2;
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

// mixed sum of the words of one 4-byte group whose first word's position
// times C1 is pc (word width WB bytes)
template <int WB>
__device__ __forceinline__ uint32_t mix_group(uint32_t v, uint32_t pc) {
  if constexpr (WB == 4) {
    return mixp(v, pc);
  } else if constexpr (WB == 2) {
    return mixp(v & 0xFFFFu, pc) + mixp(v >> 16, pc + C1);
  } else {
    return mixp(v & 0xFFu, pc) + mixp((v >> 8) & 0xFFu, pc + C1) +
           mixp((v >> 16) & 0xFFu, pc + 2u * C1) + mixp(v >> 24, pc + 3u * C1);
  }
}

// pc of the first word at byte offset `off` of a block
template <int WB>
__device__ __forceinline__ uint32_t pos_c1(long long off) {
  return uint32_t(off / WB) * C1;
}

// 4-byte group at byte offset `off` of `base` (zero past `avail` bytes)
__device__ __forceinline__ uint32_t load_tail(const uint8_t* base, long long off,
                                              long long avail) {
  uint32_t v = 0;
  for (int i = 0; i < 4; ++i)
    if (off + i < avail) v |= uint32_t(base[off + i]) << (8 * i);
  return v;
}

// one load of W bytes (16 or 4) at block offset `off`: its mixed sum
template <int W, int WB>
__device__ __forceinline__ uint32_t mix_load(const uint8_t* base, long long off,
                                             long long avail, bool whole) {
  constexpr uint32_t G = uint32_t(4 / WB) * C1;  // pc step from one group to the next
  const uint32_t pc = pos_c1<WB>(off);
  if constexpr (W == 16) {
    uint4 v;
    if (whole) {
      v = __ldcs(reinterpret_cast<const uint4*>(base + off));
    } else {
      v = make_uint4(load_tail(base, off, avail), load_tail(base, off + 4, avail),
                     load_tail(base, off + 8, avail), load_tail(base, off + 12, avail));
    }
    return mix_group<WB>(v.x, pc) + mix_group<WB>(v.y, pc + G) +
           mix_group<WB>(v.z, pc + 2u * G) + mix_group<WB>(v.w, pc + 3u * G);
  } else {
    const uint32_t v = whole ? __ldcs(reinterpret_cast<const unsigned int*>(base + off))
                             : load_tail(base, off, avail);
    return mix_group<WB>(v, pc);
  }
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// partial[p] = wrapping sum of the mixed words of slice p = (block b,
// slice s): bytes [s * slice_bytes, min((s + 1) * slice_bytes, block_bytes))
// of block b, bytes past the tensor's end read as zeros
template <int W, int WB>
__global__ void __launch_bounds__(THREADS)
fingerprint_partial_kernel(const uint8_t* __restrict__ x, long long nbytes,
                           long long block_bytes, long long slice_bytes,
                           long long slices_per_block, long long n_slices,
                           uint32_t* __restrict__ partial) {
  // the final kernel may be scheduled now; it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __shared__ uint32_t warp_sums[2][THREADS / 32];
  constexpr long long STEP = (long long)THREADS * W;   // one load of each thread
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int parity = 0;
  for (long long p = blockIdx.x; p < n_slices; p += gridDim.x, parity ^= 1) {
    const long long b = p / slices_per_block;
    const long long lo = (p - b * slices_per_block) * slice_bytes;
    const long long hi = min(lo + slice_bytes, block_bytes);
    const uint8_t* base = x + b * block_bytes;
    const long long avail = nbytes - b * block_bytes;  // the tensor's bytes from base
    const long long end = min(hi, avail);               // whole loads end here
    uint32_t acc = 0;
    for (long long o = lo + threadIdx.x * W; o < hi; o += LOADS * STEP) {
      if (o + (LOADS - 1) * STEP + W <= end) {
        uint32_t s[LOADS];
#pragma unroll
        for (int u = 0; u < LOADS; ++u) s[u] = mix_load<W, WB>(base, o + u * STEP, avail, true);
#pragma unroll
        for (int u = 0; u < LOADS; ++u) acc += s[u];
      } else {
        for (int u = 0; u < LOADS; ++u) {
          const long long off = o + u * STEP;
          if (off < hi) acc += mix_load<W, WB>(base, off, avail, off + W <= end);
        }
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) warp_sums[parity][warp] = acc;
    __syncthreads();   // a slice's warp sums alternate between two rows
    if (warp == 0) {
      const uint32_t v = warp_sum(warp_sums[parity][lane]);
      if (lane == 0) partial[p] = v;
    }
  }
}

// out[b] = fmix32(sum of block b's slice sums, in slot order); diff[b] =
// out[b] != old[b] where diff is given
__global__ void __launch_bounds__(FINAL_THREADS)
fingerprint_final_kernel(const uint32_t* __restrict__ partial, long long n_blocks,
                         long long slices_per_block, uint32_t* __restrict__ out,
                         const uint32_t* __restrict__ old, uint8_t* __restrict__ diff) {
  // launched as a programmatic dependent of the slices' grid: scheduled
  // while that grid runs, it waits here until the partials are written
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long long b = blockIdx.x * (long long)FINAL_THREADS + threadIdx.x;
  if (b >= n_blocks) return;
  const uint32_t* pb = partial + b * slices_per_block;
  uint32_t s = 0;
  for (long long i = 0; i < slices_per_block; ++i) s += pb[i];
  const uint32_t fp = fmix32(s);
  out[b] = fp;
  if (diff != nullptr) diff[b] = fp != old[b] ? 1 : 0;
}

template <int W, int WB>
int resident_grid() {
  static const int grid = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fingerprint_partial_kernel<W, WB>, THREADS, 0);
    return std::min(std::max(sms * per_sm, 1), MAX_GRID);
  }();
  return grid;
}

template <int W, int WB>
int launch_partials(const uint8_t* x, long long nbytes, long long block_bytes,
                    long long slice_bytes, long long spb, long long n_slices,
                    uint32_t* partial, cudaStream_t s) {
  const int grid = static_cast<int>(std::min<long long>(resident_grid<W, WB>(), n_slices));
  fingerprint_partial_kernel<W, WB><<<grid, THREADS, 0, s>>>(
      x, nbytes, block_bytes, slice_bytes, spb, n_slices, partial);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int launch_width(int wb, const uint8_t* x, long long nbytes, long long block_bytes,
                 long long slice_bytes, long long spb, long long n_slices,
                 uint32_t* partial, cudaStream_t s) {
  switch (wb) {
    case 1: return launch_partials<W, 1>(x, nbytes, block_bytes, slice_bytes, spb, n_slices, partial, s);
    case 2: return launch_partials<W, 2>(x, nbytes, block_bytes, slice_bytes, spb, n_slices, partial, s);
    case 4: return launch_partials<W, 4>(x, nbytes, block_bytes, slice_bytes, spb, n_slices, partial, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The partial kernel's resident grid (CTAs of 1024 threads) for 16-byte
// loads of 2-byte words.
extern "C" int spot_fingerprint_grid() { return resident_grid<16, 2>(); }

// x: raw bytes of the tensor (4-byte aligned), nbytes of them; partial:
// uint32[n_blocks * ceil(block_bytes / slice_bytes)], block-major.
// block_bytes and slice_bytes: multiples of 4 (slice_bytes of 16).
extern "C" int spot_fingerprint_partials(const void* x, long long nbytes,
                                         int itemsize, long long block_bytes,
                                         long long slice_bytes, long long n_blocks,
                                         void* partial, void* stream) {
  if (n_blocks <= 0) return 0;
  if (block_bytes <= 0 || block_bytes % 4 || slice_bytes <= 0 || slice_bytes % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int wb = itemsize < 4 ? itemsize : 4;
  const long long spb = (block_bytes + slice_bytes - 1) / slice_bytes;
  const long long n_slices = n_blocks * spb;
  const auto* xb = static_cast<const uint8_t*>(x);
  auto* p = static_cast<uint32_t*>(partial);
  auto s = static_cast<cudaStream_t>(stream);
  if (block_bytes % 16 == 0 && spot::aligned(x, 16))
    return launch_width<16>(wb, xb, nbytes, block_bytes, slice_bytes, spb, n_slices, p, s);
  return launch_width<4>(wb, xb, nbytes, block_bytes, slice_bytes, spb, n_slices, p, s);
}

// partial: uint32[n_blocks * slices_per_block]; out: uint32[n_blocks];
// old/diff: both NULL, or uint32[n_blocks] / bool[n_blocks]. Launched as a
// programmatic dependent of the kernel before it on the stream.
extern "C" int spot_fingerprint_final(const void* partial, long long n_blocks,
                                      long long slices_per_block, void* out,
                                      const void* old, void* diff, void* stream) {
  if (n_blocks <= 0) return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((n_blocks + FINAL_THREADS - 1) / FINAL_THREADS));
  cfg.blockDim = dim3(FINAL_THREADS);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, fingerprint_final_kernel, static_cast<const uint32_t*>(partial), n_blocks,
      slices_per_block, static_cast<uint32_t*>(out), static_cast<const uint32_t*>(old),
      static_cast<uint8_t*>(diff));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
