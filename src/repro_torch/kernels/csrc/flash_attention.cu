// Flash-attention forward: causal / sliding-window GQA with an online
// softmax, returning the output and the per-row log-sum-exp.
//
// Replaces src/repro/kernels/flash_attention/flash_attention.py
// (_fwd_kernel, via flash_attention_fwd) -> spot_flash_attention_fwd.
// Two kernels behind the one entry point, chosen by dtype alone:
// bfloat16 runs on the tensor cores (wgmma), float32 on the CUDA cores.
//
// What bounds it on an H100: operations. Per visible (q block, k block)
// pair the kernel does 2 * 64 * 64 * hd multiply-adds against 2 * 64 * hd
// loaded values, far above the card's ~295 operations per byte, so its
// floor is the FLOPs over the tensor-core rate, reachable only through
// wgmma.
//
// bfloat16: flash_fwd_wgmma_kernel. One CTA of two warpgroups per
// (128-row q tile, head, batch); each warpgroup owns 64 q rows, and both
// share the K/V tiles of 64 keys, double-buffered in shared memory and
// filled by cp.async while the previous tile computes (wgmma.cuh has the
// tile layout). S = Q K^T is an SS wgmma with bf16 operands and float32
// sums; the scale is applied to S in float32 after the product (scaling
// bf16 q first would add a rounding). The online softmax runs on the
// accumulator fragment in registers (row max and sum across the quad of
// lanes sharing a row, expf, the reference's finite NEG_INF = -2**30 for
// masked scores, a zero row sum divides by 1). O += P V is an RS wgmma with
// P from registers and V read transposed, twice: P rounded once to bf16
// misses the one-ulp tolerance on about 11% of the outputs, so P is split
// into hi = bf16(P) and lo = bf16(P - hi) and both products go into the
// same float32 accumulator (6 FLOPs per pair and head dimension instead
// of 4). Head dims 64, 96, 128, 256: hd 96 is zero-padded to 128 inside
// shared memory (the zeros add nothing to QK^T; the extra output columns
// are never stored). Invisible key tiles are skipped as the reference's
// _visible skips them, and causal q tiles launch longest rows first so the
// causal tail does not set the pace. The wrapper pads Sq to 64, so the
// last 128-row tile may be half filled: its missing rows load as zeros and
// are never stored. Shared memory at hd 256: Q 64 KB + K, V in two stages
// 128 KB; one CTA of 256 threads per SM.
//
// float32: flash_fwd_kernel, on the CUDA cores (IEEE fmaf, never TF32),
// kept for the float32 checks (gradients card vs host, decode vs teacher
// forcing). One CTA of 8 warps per (64-row q block, head, batch). The q
// tile is widened to float32 and scaled once (the reference's
// q.astype(f32) * scale), and K/V tiles of 64 rows stream through shared
// memory in float32: K with a padded row (hd + 1 floats) so that lane j
// reading key j's column d hits bank (j + d) % 32, conflict-free. Warp w
// owns q rows 8w..8w+7; for scores lane j owns keys j and j + 32 of the
// tile; for the output lane j owns columns j, j + 32, ... (hd / 32 floats
// per row in registers). Probabilities pass from the score layout to the
// output layout through a per-warp slice of shared memory. Its bound is
// shared-memory loads, well above the floor. It skips invisible blocks and
// masks as the bf16 kernel does.
//
// Shapes: q (B, Sq, H, hd), k/v (B, Skv, KV, hd), o like q, lse (B, H, Sq)
// float32; Sq and Skv are multiples of 64 (the wrapper pads), hd is 64, 96,
// 128 or 256, H % KV == 0 (query head h reads KV head h / (H / KV)).
#include "common.cuh"
#include "wgmma.cuh"

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

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores
// ---------------------------------------------------------------------------

namespace tc = spot::tc;
using bf16 = __nv_bfloat16;

constexpr int TC_BQ = 128;            // q rows per CTA: two warpgroups of 64
constexpr int TC_BK = 64;             // keys per tile
constexpr int TC_THREADS = 256;

template <int HD>
struct TcFwd {
  static constexpr int HDP = HD <= 64 ? 64 : (HD <= 128 ? 128 : 256);  // padded
  static constexpr int NB = HDP / 64;                  // 64-column blocks of O
  static constexpr int Q_TILE = 64 * HDP * 2;          // one warpgroup's Q, bytes
  static constexpr int KV_TILE = TC_BK * HDP * 2;
  static constexpr int SMEM = 2 * Q_TILE + 4 * KV_TILE + 1024;  // + alignment
};

template <int HD>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       float* __restrict__ lse, int Sq, int Skv, int H, int KV,
                       int causal, int window, float scale) {
  using C = TcFwd<HD>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (tc::smem_u32(smem_raw) + 1023u) & ~1023u;

  const int nqt = (Sq + TC_BQ - 1) / TC_BQ;
  const int qt = causal ? nqt - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KV);
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = t & 31;
  const int q_lo = qt * TC_BQ, q_rows = min(TC_BQ, Sq - q_lo);
  const int q_hi = q_lo + q_rows - 1;

  const long long qs = (long long)H * HD, kvs = (long long)KV * HD;
  const bf16* qb = q + ((long long)b * Sq + q_lo) * qs + (long long)h * HD;
  const bf16* kb = k + (long long)b * Skv * kvs + (long long)kvh * HD;
  const bf16* vb = v + (long long)b * Skv * kvs + (long long)kvh * HD;
  const uint32_t sQ = base + wg * C::Q_TILE;
  const uint32_t sK = base + 2 * C::Q_TILE, sV = sK + 2 * C::KV_TILE;

  // the key tiles some row of this q tile can see: [kt0, kt1)
  const int nkt = Skv / TC_BK;
  const int kt1 = causal ? min(nkt, q_hi / TC_BK + 1) : nkt;
  const int kt0 = window ? max(0, q_lo - window + 1) / TC_BK : 0;

  auto load_kv = [&](int kt, int st) {
    const long long off = (long long)kt * TC_BK * kvs;
    tc::load_tile<TC_BK, C::HDP, TC_THREADS>(sK + st * C::KV_TILE, kb + off, kvs,
                                             TC_BK, HD, tid);
    tc::load_tile<TC_BK, C::HDP, TC_THREADS>(sV + st * C::KV_TILE, vb + off, kvs,
                                             TC_BK, HD, tid);
  };
  // a warpgroup past the last row loads zeros (from a valid address)
  tc::load_tile<64, C::HDP, 128>(sQ, wg * 64 < q_rows ? qb + (long long)wg * 64 * qs : qb,
                                 qs, q_rows - wg * 64, HD, t);
  if (kt0 < kt1) load_kv(kt0, 0);
  tc::cp_async_commit();

  float acc[C::NB][32];
#pragma unroll
  for (int n = 0; n < C::NB; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[n][i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const int row0 = q_lo + wg * 64 + warp * 16 + (lane >> 2);  // and row0 + 8

  for (int kt = kt0; kt < kt1; ++kt) {
    const int st = (kt - kt0) & 1;
    if (kt + 1 < kt1) load_kv(kt + 1, st ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    tc::fence_async_smem();
    __syncthreads();

    // S = Q K^T, float32 sums of bf16 products
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    tc::fence();
#pragma unroll
    for (int kk = 0; kk < C::HDP / 16; ++kk)
      tc::mma_ss(s, tc::desc_k<64>(sQ, kk), tc::desc_k<TC_BK>(sK + st * C::KV_TILE, kk),
                 kk > 0);
    tc::commit();
    tc::wait<0>();
    tc::fence_regs(s);

    // scale, mask, online softmax on the fragment: rows row0 (r = 0) and
    // row0 + 8 (r = 1), each shared by the quad of lanes 4 (lane / 4) ..
    const int k_lo = kt * TC_BK;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1, row = row0 + 8 * r;
      const int col = k_lo + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      bool ok = true;
      if (causal) ok = ok && col <= row;
      if (window) ok = ok && col > row - window;
      s[i] = ok ? s[i] * scale : NEG_INF;
      mx[r] = fmaxf(mx[r], s[i]);
    }
    float rs[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = expf(s[i] - m[r]);
      rs[r] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
    }
#pragma unroll
    for (int n = 0; n < C::NB; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[n][i] *= alpha[(i >> 1) & 1];

    // O += P_hi V + P_lo V
    uint32_t ph[4][4], pl[4][4];
    tc::split_frag(s, ph, pl);
    tc::fence();
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk)
#pragma unroll
      for (int n = 0; n < C::NB; ++n) {
        const uint64_t dv = tc::desc_mn<TC_BK>(sV + st * C::KV_TILE, kk, n);
        tc::mma_rs(acc[n], ph[kk], dv);
        tc::mma_rs(acc[n], pl[kk], dv);
      }
    tc::commit();
    tc::wait<0>();
#pragma unroll
    for (int n = 0; n < C::NB; ++n) tc::fence_regs(acc[n]);
    __syncthreads();  // every warpgroup is done with this stage
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row > q_hi) continue;
    const float lsum = l[r] == 0.f ? 1.f : l[r];
    if ((lane & 3) == 0) lse[((long long)b * H + h) * Sq + row] = m[r] + logf(lsum);
    bf16* orow = o + ((long long)b * Sq + row) * qs + (long long)h * HD;
#pragma unroll
    for (int n = 0; n < C::NB; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n * 64 + 8 * j + 2 * (lane & 3);
        if (col < HD) {
          const int i = 4 * j + 2 * r;
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(acc[n][i] / lsum, acc[n][i + 1] / lsum);
        }
      }
  }
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, void* lse,
                 int B, int Sq, int Skv, int H, int KV, int causal, int window,
                 float scale, cudaStream_t s) {
  constexpr int smem = TcFwd<HD>::SMEM;
  auto kern = flash_fwd_wgmma_kernel<HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + TC_BQ - 1) / TC_BQ, H, B);
  kern<<<grid, TC_THREADS, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), static_cast<float*>(lse),
      Sq, Skv, H, KV, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

#define SPOT_FWD_ARGS q, k, v, o, lse, B, Sq, Skv, H, KV, causal, window, scale, s

int dispatch_f32(int hd, const void* q, const void* k, const void* v, void* o,
                 void* lse, int B, int Sq, int Skv, int H, int KV, int causal,
                 int window, float scale, cudaStream_t s) {
  switch (hd) {
    case 64: return launch<float, 64>(SPOT_FWD_ARGS);
    case 96: return launch<float, 96>(SPOT_FWD_ARGS);
    case 128: return launch<float, 128>(SPOT_FWD_ARGS);
    case 256: return launch<float, 256>(SPOT_FWD_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch_bf16(int hd, const void* q, const void* k, const void* v, void* o,
                  void* lse, int B, int Sq, int Skv, int H, int KV, int causal,
                  int window, float scale, cudaStream_t s) {
  switch (hd) {
    case 64: return launch_wgmma<64>(SPOT_FWD_ARGS);
    case 96: return launch_wgmma<96>(SPOT_FWD_ARGS);
    case 128: return launch_wgmma<128>(SPOT_FWD_ARGS);
    case 256: return launch_wgmma<256>(SPOT_FWD_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#undef SPOT_FWD_ARGS

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
      return dispatch_f32(hd, q, k, v, o, lse, B, Sq, Skv, H, KV, causal, window, scale, s);
    case spot::kBF16:
      return dispatch_bf16(hd, q, k, v, o, lse, B, Sq, Skv, H, KV, causal, window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dynamic shared memory of the bf16 tensor-core forward at head dim hd
extern "C" int spot_flash_attention_fwd_wgmma_smem(int hd) {
  switch (hd) {
    case 64: return TcFwd<64>::SMEM;
    case 96: return TcFwd<96>::SMEM;
    case 128: return TcFwd<128>::SMEM;
    case 256: return TcFwd<256>::SMEM;
    default: return -1;
  }
}
