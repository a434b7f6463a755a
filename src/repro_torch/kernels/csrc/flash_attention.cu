// Flash-attention forward: causal / sliding-window GQA with an online
// softmax, returning the output and the per-row log-sum-exp.
//
// Replaces src/repro/kernels/flash_attention/flash_attention.py
// (_fwd_kernel, via flash_attention_fwd) -> spot_flash_attention_fwd.
//
// What bounds it on an H100: operations. Per visible (q block, k block)
// pair the kernel does 2 * 64 * 64 * hd multiply-adds against 2 * 64 * hd
// loaded values, far above the card's ~295 operations per byte, so its
// floor is the FLOPs over the tensor-core rate. This first version runs the
// products on the CUDA cores in float32 (IEEE fmaf, never TF32) and is
// bound by shared-memory loads well below that floor; tensor cores (wgmma)
// are later work.
//
// Design: one CTA of 8 warps per (64-row q block, head, batch). The q tile
// is widened to float32 and scaled once (the reference's
// q.astype(f32) * scale), and K/V tiles of 64 rows stream through shared
// memory in float32: K with a padded row (hd + 1 floats) so that lane j
// reading key j's column d hits bank (j + d) % 32, conflict-free. Warp w
// owns q rows 8w..8w+7; for scores lane j owns keys j and j + 32 of the
// tile; for the output lane j owns columns j, j + 32, ... (hd / 32 floats
// per row in registers). Probabilities pass from the score layout to the
// output layout through a per-warp slice of shared memory. K/V blocks that
// no row of the q block can see (past the causal frontier, or wholly
// outside the sliding window) are skipped, as the reference's _visible
// skips them, so a window layer does O(S * window) work. Inside a visible
// block masked scores take the reference's finite NEG_INF = -2**30, and a
// row whose sum is 0 divides by 1, as the reference does.
//
// Shapes: q (B, Sq, H, hd), k/v (B, Skv, KV, hd), o like q, lse (B, H, Sq)
// float32; Sq and Skv are multiples of 64 (the wrapper pads), hd is 64, 96,
// 128 or 256, H % KV == 0 (query head h reads KV head h / (H / KV)). Built
// for float32 and bfloat16, the dtypes the models serve and train in.
#include "common.cuh"

namespace {

constexpr float NEG_INF = -1073741824.0f;  // -2**30, the reference's mask value
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = BQ / WARPS;  // q rows per warp

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

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * HD + BK * (HD + 1) + BK * HD + BQ * BK);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Skv, int H, int KV,
                 int causal, int window, float scale) {
  constexpr int COLS = HD / 32;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                  // BQ x HD, scaled float32
  float* Ks = Qs + BQ * HD;          // BK x (HD + 1)
  float* Vs = Ks + BK * (HD + 1);    // BK x HD
  float* Ps = Vs + BK * HD;          // BQ x BK probabilities

  const int qi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q_lo = qi * BQ, q_hi = q_lo + BQ - 1;

  const long long q_stride = (long long)H * HD;     // between sequence rows
  const long long kv_stride = (long long)KV * HD;
  const T* qb = q + ((long long)b * Sq + q_lo) * q_stride + (long long)h * HD;
  const T* kb = k + (long long)b * Skv * kv_stride + (long long)kvh * HD;
  const T* vb = v + (long long)b * Skv * kv_stride + (long long)kvh * HD;

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    Qs[i] = spot::to_f32<T>(qb[r * q_stride + d]) * scale;
  }

  float m[ROWS], l[ROWS], acc[ROWS][COLS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[r][c] = 0.f;
  }

  const float* qw = Qs + warp * ROWS * HD;
  float* pw = Ps + warp * ROWS * BK;
  const int nk = Skv / BK;
  for (int ki = 0; ki < nk; ++ki) {
    const int k_lo = ki * BK, k_hi = k_lo + BK - 1;
    if (causal && k_lo > q_hi) break;             // past the causal frontier
    if (window && k_hi <= q_lo - window) continue;  // wholly outside the band
    __syncthreads();  // the previous tile's readers are done (and Qs is written)
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int r = i / HD, d = i % HD;
      const long long g = (long long)(k_lo + r) * kv_stride + d;
      Ks[r * (HD + 1) + d] = spot::to_f32<T>(kb[g]);
      Vs[i] = spot::to_f32<T>(vb[g]);
    }
    __syncthreads();

    // scores: rows 8w.., keys lane and lane + 32
    float s[ROWS][2];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r][0] = s[r][1] = 0.f;
    const float* k0p = Ks + lane * (HD + 1);
    const float* k1p = Ks + (lane + 32) * (HD + 1);
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      float k0[4], k1[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        k0[e] = k0p[d + e];
        k1[e] = k1p[d + e];
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + r * HD + d);
        s[r][0] = fmaf(qv.x, k0[0], s[r][0]);
        s[r][0] = fmaf(qv.y, k0[1], s[r][0]);
        s[r][0] = fmaf(qv.z, k0[2], s[r][0]);
        s[r][0] = fmaf(qv.w, k0[3], s[r][0]);
        s[r][1] = fmaf(qv.x, k1[0], s[r][1]);
        s[r][1] = fmaf(qv.y, k1[1], s[r][1]);
        s[r][1] = fmaf(qv.z, k1[2], s[r][1]);
        s[r][1] = fmaf(qv.w, k1[3], s[r][1]);
      }
    }

    // mask, online softmax update, probabilities to shared memory
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qpos = q_lo + warp * ROWS + r;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kpos = k_lo + lane + 32 * c;
        bool ok = true;
        if (causal) ok = ok && kpos <= qpos;
        if (window) ok = ok && kpos > qpos - window;
        if (!ok) s[r][c] = NEG_INF;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      const float p0 = expf(s[r][0] - m_new);
      const float p1 = expf(s[r][1] - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[r][c] *= alpha;
      m[r] = m_new;
      pw[r * BK + lane] = p0;
      pw[r * BK + lane + 32] = p1;
    }
    __syncwarp();

    // acc += P V: lane owns columns lane, lane + 32, ...
#pragma unroll 1
    for (int j = 0; j < BK; j += 4) {
      float vv[4][COLS];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int c = 0; c < COLS; ++c) vv[e][c] = Vs[(j + e) * HD + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(pw + r * BK + j);
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          acc[r][c] = fmaf(p.x, vv[0][c], acc[r][c]);
          acc[r][c] = fmaf(p.y, vv[1][c], acc[r][c]);
          acc[r][c] = fmaf(p.z, vv[2][c], acc[r][c]);
          acc[r][c] = fmaf(p.w, vv[3][c], acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qrow = q_lo + warp * ROWS + r;
    const float lsum = l[r] == 0.f ? 1.f : l[r];
    T* orow = o + ((long long)b * Sq + qrow) * q_stride + (long long)h * HD;
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      orow[lane + 32 * c] = spot::from_f32<T>(acc[r][c] / lsum);
    if (lane == 0) lse[((long long)b * H + h) * Sq + qrow] = m[r] + logf(lsum);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int Sq, int Skv, int H, int KV, int causal, int window,
           float scale, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kern = flash_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Sq / BQ, H, B);
  kern<<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      Sq, Skv, H, KV, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                void* lse, int B, int Sq, int Skv, int H, int KV, int causal,
                int window, float scale, cudaStream_t s) {
  switch (hd) {
    case 64: return launch<T, 64>(q, k, v, o, lse, B, Sq, Skv, H, KV, causal, window, scale, s);
    case 96: return launch<T, 96>(q, k, v, o, lse, B, Sq, Skv, H, KV, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, Sq, Skv, H, KV, causal, window, scale, s);
    case 256: return launch<T, 256>(q, k, v, o, lse, B, Sq, Skv, H, KV, causal, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int spot_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int B, int Sq, int Skv, int H, int KV,
                                        int hd, int dtype_code, int causal,
                                        int window, float scale, void* stream) {
  if (Sq % BQ || Skv % BK || KV <= 0 || H % KV) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case spot::kF32:
      return dispatch_hd<float>(hd, q, k, v, o, lse, B, Sq, Skv, H, KV, causal, window, scale, s);
    case spot::kBF16:
      return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, lse, B, Sq, Skv, H, KV, causal, window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
