// Flash decode: one query token per (batch, head) against a KV cache whose
// first valid_len rows are filled, split over the cache and merged.
//
// Replaces src/repro/kernels/decode_attention/decode_attention.py
// (_decode_kernel, via decode_attention) -> spot_decode_split (the key
// blocks) + spot_decode_merge (the reference's finalize across them).
//
// What bounds it on an H100: bytes. Every valid cache row is read once per
// token and used for 2 * hd multiply-adds per query head of its group, so
// the floor is the K/V bytes over the memory rate (3.35 TB/s). At a decode
// step's shapes that floor is microseconds, so the design is about
// parallelism and bytes in flight:
//
//  * Split over the cache. Grid (splits, KV, B): CTA (s, kvh, b) reduces
//    the contiguous key range [s * keys_per_split, min(.., valid_len)) into
//    float32 partials (acc[G][hd], m, l) per query head, and a second, small
//    kernel merges a head's partials in split order (no atomics, one writer
//    per output). The split count is a host function of (B, KV, hd,
//    valid_len) alone (kernels/decode_attention/ops.py: decode_splits),
//    so a decode position gives the same bits every time.
//  * One CTA per KV head serves its whole GQA group (G = H / KV <= 16):
//    each K/V row is read once for all G query heads. The G queries sit
//    in shared memory as they came (16 bytes are 8 bf16 values, half the
//    shared-memory reads of float32); each dot product is scaled by
//    scale * log2(e) once.
//  * K/V tiles of TK keys (64, or 32 at hd 256) stream through a ring of
//    2-4 shared-memory stages (as many as fit in 96 KB, two CTAs an SM) in
//    16-byte cp.async copies; rows are padded by 16 bytes, so 8 lanes
//    reading 8 rows at one column hit 8 different bank groups. hd 96 is 12
//    such chunks a bf16 row, no padding to 128.
//  * Scores from shared memory, no shuffle per key. bf16: S = Q K^T on the
//    tensor cores, mma.sync m16n8k16 with the group's heads padded to 16
//    rows of zeros, one warp per 8 keys (exact products, float32 sums).
//    float32 (the check copies) on the CUDA cores: lane l of a warp owns
//    keys l, l + 32 and sums its dot products whole, each query value
//    read by all lanes at once, warp w taking heads w, w + 8.
//  * One online-softmax rescale per tile and head, in exp2: the scores
//    are scaled by scale * log2(e) (expf is not needed for the tolerance).
//  * P V on the CUDA cores: thread (slot, x) owns 16-byte column chunk x of
//    heads slot, slot + min(G, slots), ..., reading each V chunk once for
//    all of them; where G is below the slots, the spare slots split the
//    tile's keys. The accumulators leave through shared memory, written
//    out coalesced, the key groups' sums added in order.
// float32 and bfloat16 share the design (16 bytes are 4 or 8 values); the
// arithmetic is float32 throughout.
//
// valid_len is a runtime argument, so one build serves every decode
// position and any cache depth S; keys at or past valid_len are never
// read. The reference's mask value (-2**30) starts the running max, and
// its guard is kept: a sum of 0 divides by 1. A ring cache (sliding
// window) is read through the same kernels: every filled slot of a ring of
// size W holds a position within the window of the newest token, so the
// ring's validity mask is slot < min(pos + 1, W), and softmax does not
// depend on slot order.
//
// Shapes: q (B, H, hd), k/v (B, S, KV, hd), o (B, H, hd), partials
// (B, H, splits, hd + 2) float32 (acc, then m and l in the log2 domain);
// hd is 64, 96, 128 or 256; H % KV == 0, H / KV <= 16; q, k, v 16-byte
// aligned. Built for float32 and bfloat16, the dtypes the models serve in.
#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using spot::tc::cp_async16;
using spot::tc::cp_async_commit;
using spot::tc::cp_async_wait;
using spot::tc::smem_u32;

constexpr float NEG_INF = -1073741824.0f;  // -2**30, the reference's mask value
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GMAX = 16;                   // query heads per KV head
constexpr int MAX_SPLITS = 256;            // decode_splits' cap (ops.py)
constexpr int MERGE_THREADS = 256;
constexpr int MERGE_COLS = 32;             // output columns per merge CTA

template <typename T, int HD>
struct Cfg {
  static constexpr int E = 16 / sizeof(T);              // values per 16-byte chunk
  static constexpr int C = HD / E;                       // chunks per row
  static constexpr int TK = HD > 128 ? 32 : 64;          // keys per tile
  static constexpr int KPL = TK / 32;                    // keys per lane
  static constexpr int RS = HD + E;                      // row stride: 16-byte pad
  static constexpr int QS = HD + E;                      // query row stride, the same
  static constexpr int PS = TK + 1;                      // score row stride (floats)
  static constexpr int STAGE_BYTES = 2 * TK * RS * sizeof(T);   // a K and a V tile
  // 2 to 4 stages, as many as fit in 96 KB (two CTAs an SM)
  static constexpr int NSTAGE = 98304 / STAGE_BYTES < 2 ? 2
                                : 98304 / STAGE_BYTES > 4 ? 4 : 98304 / STAGE_BYTES;
  // P V: thread (slot, x) owns 16-byte column chunk x of some heads
  static constexpr int SLOTS = THREADS / C;
  static constexpr int HPT = (GMAX + SLOTS - 1) / SLOTS;   // heads per thread, at most
  static constexpr size_t KV_BYTES = size_t(NSTAGE) * STAGE_BYTES;
  // + queries [G][QS] in T, scores then p [G][PS] and alpha [G] in float32
  static size_t smem(int G) {
    return KV_BYTES + size_t(G) * QS * sizeof(T) + size_t(G) * (PS + 1) * sizeof(float);
  }
};

// 16 bytes of T widened to float32
template <typename T> __device__ __forceinline__ void widen(const uint4& x, float* f);
template <> __device__ __forceinline__ void widen<float>(const uint4& x, float* f) {
  f[0] = __uint_as_float(x.x); f[1] = __uint_as_float(x.y);
  f[2] = __uint_as_float(x.z); f[3] = __uint_as_float(x.w);
}
template <> __device__ __forceinline__ void widen<__nv_bfloat16>(const uint4& x, float* f) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
// one 16-byte chunk of shared memory widened to float32
template <typename T>
__device__ __forceinline__ void load_chunk(const T* p, float* f) {
  widen<T>(*reinterpret_cast<const uint4*>(p), f);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// c += A B, m16n8k16, bf16 operands, float32 accumulators
__device__ __forceinline__ void mma_bf16_16816(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 2)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, float* __restrict__ ws, int S,
                    int H, int KV, int valid_len, int keys_per_split,
                    float qscale) {
  using F = Cfg<T, HD>;
  constexpr int NSTAGE = F::NSTAGE;
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / KV;
  T* ring = reinterpret_cast<T*>(smem);                        // [NSTAGE][K|V][TK][RS]
  const T* qs = reinterpret_cast<T*>(smem + F::KV_BYTES);     // [G][QS]
  float* ps = reinterpret_cast<float*>(smem + F::KV_BYTES + G * F::QS * sizeof(T));  // [G][PS]
  float* alpha_s = ps + G * F::PS;                              // [G]

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lo = split * keys_per_split;
  const int hi = min(lo + keys_per_split, valid_len);
  const int n_tiles = (hi - lo + F::TK - 1) / F::TK;

  const long long row = (long long)KV * HD;   // elements from one key to the next
  const T* kb = k + (long long)b * S * row + (long long)kvh * HD;
  const T* vb = v + (long long)b * S * row + (long long)kvh * HD;

  auto load_tile = [&](int t) {
    const int base = lo + t * F::TK;
    const int n = min(F::TK, hi - base);
    T* ks = ring + (t % NSTAGE) * 2 * F::TK * F::RS;
    T* vs = ks + F::TK * F::RS;
    for (int i = tid; i < n * F::C; i += THREADS) {
      const int r = i / F::C, c = i - r * F::C;
      const long long off = (long long)(base + r) * row + c * F::E;
      cp_async16(smem_u32(ks + r * F::RS + c * F::E), kb + off, true);
      cp_async16(smem_u32(vs + r * F::RS + c * F::E), vb + off, true);
    }
  };
  // the group's G query rows, copied as they are with the first tile
  const T* qg = q + ((long long)b * H + (long long)kvh * G) * HD;
  for (int i = tid; i < G * F::C; i += THREADS)
    cp_async16(smem_u32(qs + i / F::C * F::QS + i % F::C * F::E), qg + i * F::E, true);
#pragma unroll
  for (int t = 0; t < NSTAGE - 1; ++t) {
    if (t < n_tiles) load_tile(t);
    cp_async_commit();
  }

  // warp w < HW = min(G, WARPS) keeps the running max and sum of heads
  // w, w + HW, ... (and sums their float32 scores)
  constexpr int RMAX = GMAX / WARPS;      // heads per warp, at most
  const int HW = min(G, WARPS);
  float m_r[RMAX], l_r[RMAX];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    m_r[r] = NEG_INF;
    l_r[r] = 0.f;
  }
  // P V: thread (slot, x) of the SLOTS x C threads owns column chunk x of
  // heads slot % hs + hs * i (hs = min(G, SLOTS) head slots); where G <
  // SLOTS the spare slots split the keys: key group kg = slot / hs of nkg
  const int x = tid % F::C, slot = tid / F::C;
  const int hs = min(G, F::SLOTS), nkg = F::SLOTS / hs;
  const int kg = slot / hs, g0 = slot - kg * hs;
  const bool pv = kg < nkg;
  float acc[F::HPT][F::E];
#pragma unroll
  for (int i = 0; i < F::HPT; ++i)
#pragma unroll
    for (int e = 0; e < F::E; ++e) acc[i][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + NSTAGE - 1 < n_tiles) load_tile(t + NSTAGE - 1);
    cp_async_commit();
    cp_async_wait<NSTAGE - 1>();
    __syncthreads();
    const T* ks = ring + (t % NSTAGE) * 2 * F::TK * F::RS;
    const T* vs = ks + F::TK * F::RS;
    const int n = min(F::TK, hi - (lo + t * F::TK));

    // 1. scores, scaled by scale * log2(e): sc[r][kk] of head w + HW r and
    // key lane + 32 kk, in warps w < HW
    float sc[RMAX][F::KPL];
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      // bf16: S = Q K^T on the tensor cores (mma.sync m16n8k16, float32
      // sums, exact products), the heads padded to 16 rows of zeros; warp
      // w < TK / 8 takes keys 8w .. 8w + 7, two accumulators (even and odd
      // k steps), the fragments read from the padded rows without bank
      // conflicts
      if (warp < F::TK / 8) {
        float c[2][4] = {};
        const int gq = lane >> 2, tq = lane & 3;
        const bool v0 = gq < G, v1 = gq + 8 < G;
        const uint32_t* kr = reinterpret_cast<const uint32_t*>(ks + (warp * 8 + gq) * F::RS) + tq;
        const uint32_t* q0 = reinterpret_cast<const uint32_t*>(qs + gq * F::QS) + tq;
        const uint32_t* q1 = reinterpret_cast<const uint32_t*>(qs + (gq + 8) * F::QS) + tq;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int w = kk * 8;
          mma_bf16_16816(c[kk & 1], v0 ? q0[w] : 0u, v1 ? q1[w] : 0u, v0 ? q0[w + 4] : 0u,
                         v1 ? q1[w + 4] : 0u, kr[w], kr[w + 4]);
        }
        const int j = warp * 8 + 2 * tq;
        if (v0) {
          ps[gq * F::PS + j] = (c[0][0] + c[1][0]) * qscale;
          ps[gq * F::PS + j + 1] = (c[0][1] + c[1][1]) * qscale;
        }
        if (v1) {
          ps[(gq + 8) * F::PS + j] = (c[0][2] + c[1][2]) * qscale;
          ps[(gq + 8) * F::PS + j + 1] = (c[0][3] + c[1][3]) * qscale;
        }
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < RMAX; ++r)
#pragma unroll
        for (int kk = 0; kk < F::KPL; ++kk)
          sc[r][kk] = warp < HW && warp + HW * r < G ? ps[(warp + HW * r) * F::PS + lane + 32 * kk] : 0.f;
    } else {
      // float32 on the CUDA cores: lane l sums the dot products of keys
      // l, l + 32, .. whole (no shuffles), each query value read by all
      // lanes at once, two accumulators per dot product
      float s[F::KPL][RMAX][2];
#pragma unroll
      for (int kk = 0; kk < F::KPL; ++kk)
#pragma unroll
        for (int r = 0; r < RMAX; ++r) s[kk][r][0] = s[kk][r][1] = 0.f;
      if (warp < HW) {
#pragma unroll 2
        for (int c = 0; c < F::C; c += 2) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float kf[F::KPL][F::E];
#pragma unroll
            for (int kk = 0; kk < F::KPL; ++kk)
              load_chunk(ks + (lane + 32 * kk) * F::RS + (c + h) * F::E, kf[kk]);
#pragma unroll
            for (int r = 0; r < RMAX; ++r) {
              const int g = warp + HW * r;
              if (g < G) {
                float qf[F::E];
                load_chunk(qs + g * F::QS + (c + h) * F::E, qf);
#pragma unroll
                for (int e = 0; e < F::E; ++e)
#pragma unroll
                  for (int kk = 0; kk < F::KPL; ++kk)
                    s[kk][r][h] = fmaf(qf[e], kf[kk][e], s[kk][r][h]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RMAX; ++r)
#pragma unroll
        for (int kk = 0; kk < F::KPL; ++kk) sc[r][kk] = (s[kk][r][0] + s[kk][r][1]) * qscale;
    }
    // one online-softmax rescale per tile and head (keys past n, whose
    // rows hold whatever the ring held, get p = 0)
    if (warp < HW) {
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        const int g = warp + HW * r;
        if (g < G) {
          float sv[F::KPL], mt = -INFINITY;
#pragma unroll
          for (int kk = 0; kk < F::KPL; ++kk) {
            sv[kk] = lane + 32 * kk < n ? sc[r][kk] : -INFINITY;
            mt = fmaxf(mt, sv[kk]);
          }
          const float m_new = fmaxf(m_r[r], warp_max(mt));
          float sum = 0.f;
#pragma unroll
          for (int kk = 0; kk < F::KPL; ++kk) {
            const float pj = lane + 32 * kk < n ? exp2f(sv[kk] - m_new) : 0.f;
            ps[g * F::PS + lane + 32 * kk] = pj;
            sum += pj;
          }
          const float alpha = exp2f(m_r[r] - m_new);
          l_r[r] = l_r[r] * alpha + warp_sum(sum);
          m_r[r] = m_new;
          if (lane == 0) alpha_s[g] = alpha;
        }
      }
    }
    __syncthreads();

    // 2. acc = acc * alpha + P V: each V chunk read once for the thread's heads
    if (pv) {
#pragma unroll
      for (int i = 0; i < F::HPT; ++i) {
        const int g = g0 + hs * i;
        if (g < G) {
          const float alpha = alpha_s[g];
#pragma unroll
          for (int e = 0; e < F::E; ++e) acc[i][e] *= alpha;
        }
      }
#pragma unroll 4
      for (int j = kg; j < n; j += nkg) {
        float vf[F::E];
        load_chunk(vs + j * F::RS + x * F::E, vf);
#pragma unroll
        for (int i = 0; i < F::HPT; ++i) {
          const int g = g0 + hs * i;
          if (g < G) {
            const float pj = ps[g * F::PS + j];
#pragma unroll
            for (int e = 0; e < F::E; ++e) acc[i][e] = fmaf(pj, vf[e], acc[i][e]);
          }
        }
      }
    }
    __syncthreads();   // the stage and the scores are free for the next tile
  }
  cp_async_wait<0>();

  // 3. partials: (acc, m, l) of each head of the group for this split
  const long long wrow = ((long long)b * H + (long long)kvh * G) * splits + split;
  auto out = [&](int g) { return ws + (wrow + (long long)g * splits) * (HD + 2); };
  // the accumulators through shared memory ([nkg][G][HD], in the ring),
  // then written out coalesced, the key groups' sums added in order
  float* red = reinterpret_cast<float*>(smem);
  if (pv) {
#pragma unroll
    for (int i = 0; i < F::HPT; ++i) {
      const int g = g0 + hs * i;
      if (g < G) {
        float* dst = red + (kg * G + g) * HD + x * F::E;
#pragma unroll
        for (int e = 0; e < F::E; e += 4)
          *reinterpret_cast<float4*>(dst + e) =
              make_float4(acc[i][e], acc[i][e + 1], acc[i][e + 2], acc[i][e + 3]);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < G * HD; i += THREADS) {
    float a = red[i];
    for (int r = 1; r < nkg; ++r) a += red[r * G * HD + i];
    out(i / HD)[i % HD] = a;
  }
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    const int g = warp + HW * r;
    if (warp < HW && g < G && lane == 0) {
      out(g)[HD] = m_r[r];
      out(g)[HD + 1] = l_r[r];
    }
  }
}

// o[b, h] = sum_s acc_s * 2^(m_s - M) / sum_s l_s * 2^(m_s - M), summed in
// split order, M = max_s m_s. CTA (h, b, c) writes columns [32c, 32c + 32):
// its 256 threads stage the splits' weights and their columns of every
// split's accumulator in shared memory (independent loads, all in flight
// together), then one warp sums each column over the splits in order.
template <typename T, int HD>
__global__ void __launch_bounds__(MERGE_THREADS)
decode_merge_kernel(const float* __restrict__ ws, T* __restrict__ o, int splits) {
  __shared__ float f_s[MAX_SPLITS], l_s[MAX_SPLITS], red[MERGE_THREADS / 32];
  __shared__ float cols[MAX_SPLITS * MERGE_COLS];     // [split][column]
  const long long bh = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  const int c0 = blockIdx.z * MERGE_COLS;
  const float* w = ws + bh * splits * (HD + 2);
  const int t = threadIdx.x;
  float mx = NEG_INF;
  for (int s = t; s < splits; s += MERGE_THREADS) {
    f_s[s] = w[s * (HD + 2) + HD];
    l_s[s] = w[s * (HD + 2) + HD + 1];
    mx = fmaxf(mx, f_s[s]);
  }
  for (int i = t; i < splits * MERGE_COLS; i += MERGE_THREADS) {
    const int s = i / MERGE_COLS, c = i - s * MERGE_COLS;
    cols[i] = w[s * (HD + 2) + c0 + c];
  }
  mx = warp_max(mx);
  if ((t & 31) == 0) red[t >> 5] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int i = 1; i < MERGE_THREADS / 32; ++i) mx = fmaxf(mx, red[i]);
  for (int s = t; s < splits; s += MERGE_THREADS) f_s[s] = exp2f(f_s[s] - mx);
  __syncthreads();
  if (t < MERGE_COLS) {
    float l = 0.f, acc = 0.f;
#pragma unroll 8
    for (int s = 0; s < splits; ++s) {
      l = fmaf(l_s[s], f_s[s], l);
      acc = fmaf(cols[s * MERGE_COLS + t], f_s[s], acc);
    }
    if (l == 0.f) l = 1.f;
    o[bh * HD + c0 + t] = spot::from_f32<T>(acc / l);
  }
}

template <typename T, int HD>
int launch_split(const void* q, const void* k, const void* v, void* ws, int B,
                 int S, int H, int KV, int valid_len, int splits,
                 int keys_per_split, float qscale, cudaStream_t s) {
  using F = Cfg<T, HD>;
  auto kern = decode_split_kernel<T, HD>;
  // once per instance, for the largest group, outside any graph capture
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F::smem(GMAX));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kern<<<dim3(splits, KV, B), THREADS, F::smem(H / KV), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(ws), S, H, KV, valid_len,
      keys_per_split, qscale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int split_hd(int hd, const void* q, const void* k, const void* v, void* ws,
             int B, int S, int H, int KV, int valid_len, int splits, int kps,
             float qscale, cudaStream_t s) {
  switch (hd) {
    case 64: return launch_split<T, 64>(q, k, v, ws, B, S, H, KV, valid_len, splits, kps, qscale, s);
    case 96: return launch_split<T, 96>(q, k, v, ws, B, S, H, KV, valid_len, splits, kps, qscale, s);
    case 128: return launch_split<T, 128>(q, k, v, ws, B, S, H, KV, valid_len, splits, kps, qscale, s);
    case 256: return launch_split<T, 256>(q, k, v, ws, B, S, H, KV, valid_len, splits, kps, qscale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int merge_hd(int hd, const void* ws, void* o, int B, int H, int splits,
             cudaStream_t s) {
  const dim3 grid(H, B, hd / MERGE_COLS);
  const auto* w = static_cast<const float*>(ws);
  auto* out = static_cast<T*>(o);
  switch (hd) {
    case 64: decode_merge_kernel<T, 64><<<grid, MERGE_THREADS, 0, s>>>(w, out, splits); break;
    case 96: decode_merge_kernel<T, 96><<<grid, MERGE_THREADS, 0, s>>>(w, out, splits); break;
    case 128: decode_merge_kernel<T, 128><<<grid, MERGE_THREADS, 0, s>>>(w, out, splits); break;
    case 256: decode_merge_kernel<T, 256><<<grid, MERGE_THREADS, 0, s>>>(w, out, splits); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace


// The split pass: partials (B, H, splits, hd + 2) float32. Every split
// must hold at least one valid key and together they must cover valid_len.
extern "C" int spot_decode_split(const void* q, const void* k, const void* v,
                                 void* ws, int B, int S, int H, int KV, int hd,
                                 int valid_len, int splits, int keys_per_split,
                                 int dtype_code, float qscale, void* stream) {
  if (valid_len < 1 || valid_len > S || KV <= 0 || H % KV || H / KV > GMAX ||
      splits < 1 || keys_per_split < 1 ||
      (long long)(splits - 1) * keys_per_split >= valid_len ||
      (long long)splits * keys_per_split < valid_len)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case spot::kF32:
      return split_hd<float>(hd, q, k, v, ws, B, S, H, KV, valid_len, splits,
                             keys_per_split, qscale, s);
    case spot::kBF16:
      return split_hd<__nv_bfloat16>(hd, q, k, v, ws, B, S, H, KV, valid_len,
                                     splits, keys_per_split, qscale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The merge pass: partials (B, H, splits, hd + 2) -> o (B, H, hd) of dtype.
extern "C" int spot_decode_merge(const void* ws, void* o, int B, int H, int hd,
                                 int splits, int dtype_code, void* stream) {
  if (splits < 1 || splits > MAX_SPLITS) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case spot::kF32: return merge_hd<float>(hd, ws, o, B, H, splits, s);
    case spot::kBF16: return merge_hd<__nv_bfloat16>(hd, ws, o, B, H, splits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
