// Per-chunk content address (SHA-1) and CRC-32 of a save's tensors, on the
// device, before their bytes cross to the host.
//
// Replaces (no TPU kernel): the host digests of every chunk a save writes,
// src/repro/checkpoint/chunkstore.py::chunk_digest (hashlib.sha1) and the
// zlib.crc32 of store_chunk -> spot_chunk_digest. An urgent save's bytes
// then cross the link with their addresses known, and the host only writes
// them: inside the eviction notice the host's cores are shared between the
// digests and the filesystem's writes, and the digests lose.
//
// Output, bit for bit what hashlib and zlib give (the plain version,
// kernels/chunk_digest/ref.py): for chunk c, the five SHA-1 words in
// digest order and the CRC-32, over desc[c] = (address, length) — the
// 1 MiB windows (store.chunk_size) of each tensor's raw bytes, the last one
// of a tensor possibly short.
//
// Bound: operations. SHA-1 is about 1,000 32-bit integer operations a
// 64-byte block (80 rounds and the message schedule) and CRC-32 by
// slicing-by-4 about 10 a word; the bytes are read once. At 64 integer
// operations a clock per SM the digests of 6.5 GB take about 7 ms, the read
// 2 ms.
//
// Design, the simple one first: one thread a chunk, walking its chunk in
// 64-byte blocks with 4-byte loads (each word feeds the CRC as it is and the
// SHA-1 byte-swapped), the slicing tables in shared memory, and one launch
// for all of a save's tensors (a chunk table, not a launch a tensor, so the
// chunks of every leaf run side by side). A chunk's digest is a chain of
// 16,384 compressions with no parallelism inside it; the grid is as wide
// as the save has chunks.
#include "chunk_digest.cuh"
#include "common.cuh"

namespace {

constexpr int THREADS = 64;

struct DevSrc {
  const uint32_t* w;
  const uint8_t* b;
  __device__ __forceinline__ uint32_t word(long long i) const { return __ldg(w + i); }
  __device__ __forceinline__ uint32_t byte(long long j) const { return __ldg(b + j); }
};

__global__ void __launch_bounds__(THREADS)
chunk_digest_kernel(const long long* __restrict__ desc, long long n_chunks,
                    uint32_t* __restrict__ sha, uint32_t* __restrict__ crc) {
  __shared__ uint32_t T[4][256];
  for (int i = threadIdx.x; i < 4 * 256; i += THREADS)
    T[i >> 8][i & 255] = spot_digest::crc_table_entry(i >> 8, static_cast<uint32_t>(i & 255));
  __syncthreads();
  const long long c = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (c >= n_chunks) return;
  const auto* p = reinterpret_cast<const uint8_t*>(desc[2 * c]);
  const long long len = desc[2 * c + 1];
  uint32_t h[5];
  const uint32_t cr = spot_digest::digest_span(
      DevSrc{reinterpret_cast<const uint32_t*>(p), p}, len, T, h);
#pragma unroll
  for (int k = 0; k < 5; ++k) sha[5 * c + k] = h[k];
  crc[c] = cr;
}

}  // namespace

// desc: int64[n_chunks][2] on the device, (address, length) of each chunk,
// every address 4-byte aligned; sha: uint32[n_chunks][5]; crc:
// uint32[n_chunks].
extern "C" int spot_chunk_digest(const void* desc, long long n_chunks, void* sha,
                                 void* crc, void* stream) {
  if (n_chunks <= 0) return 0;
  const long long grid = (n_chunks + THREADS - 1) / THREADS;
  chunk_digest_kernel<<<static_cast<unsigned>(grid), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(desc), n_chunks, static_cast<uint32_t*>(sha),
      static_cast<uint32_t*>(crc));
  return static_cast<int>(cudaGetLastError());
}
