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
// share the K/V tiles of 64 keys.
//  * Feed. One thread issues every load as TMA (cp.async.bulk.tensor)
//    through 4-d tensor maps (hd, heads, seq, batch) made on the host,
//    whose box (64 columns of one head by 64 rows, 128-byte swizzle) lands
//    in the layout wgmma reads (wgmma.cuh). Elements past the tensor
//    arrive as zeros: the missing half of a last 128-row q tile, hd 96's
//    columns 96-127. K and V sit in a ring of stages (two at hd 256,
//    three below) with a full and an empty mbarrier each; a warpgroup
//    waits on its tile's full barrier, and each warp arrives on the empty
//    one when it is done (no block-wide barrier in the loop). The issuer
//    is a consumer thread (ISSUER, in warpgroup 1): after each tile it
//    waits on that stage's empty barrier, that is for warpgroup 0 to have
//    left the tile too, before it refills the stage. So warpgroup 0 may
//    run up to STAGES - 1 tiles ahead, and warpgroup 1 never runs ahead of
//    warpgroup 0. Whether one's softmax overlaps the other's products was
//    not measured (no trace of the card was taken); a producer that no
//    consumer waits on is the next schedule to try. Two explicit schedules
//    were measured on the card and not kept: each warpgroup issuing tile
//    j + 1's S before tile j's softmax, and the two taking turns at issuing
//    S (named barriers); both were slower than this one at every head dim
//    (PERF.md, section 6).
//  * Masks and skips. The causal/window predicate is evaluated only on a
//    tile that straddles the diagonal or the window's lower edge, and a
//    warpgroup skips a tile none of its rows sees.
//  * Arithmetic. S is an SS wgmma with bf16 operands and float32 sums
//    over the real head dimension (6 K steps at hd 96); the scale is
//    applied in float32 after the product, folded with log2(e) into one
//    fma: P = exp2(s * scale * log2e - m), m the running max in base-2
//    units (the log-sum-exp is still returned as a natural log). Masked
//    scores take the reference's finite NEG_INF = -2**30, and a zero row
//    sum divides by 1. O += P V is an RS wgmma with P from registers and V
//    read transposed, twice: P rounded once to bf16 misses the one-ulp
//    tolerance on about 11% of the outputs, so P is split into
//    hi = bf16(P) and lo = bf16(P - hi) and both products go into the same
//    float32 accumulator (6 FLOPs per pair and head dimension instead of
//    4). O covers the real head dimension: m64n64 blocks, plus one m64n32
//    block at hd 96 (48 accumulator registers a thread, not 64).
//  * Order. Invisible key tiles are skipped as the reference's _visible
//    skips them, and causal q tiles launch longest rows first so the
//    causal tail does not set the pace. The wrapper pads Sq to 64, so the
//    last 128-row tile may be half filled: its second warpgroup then only
//    keeps the barriers' count. Shared memory at hd 256: Q 64 KB + K, V in
//    two stages 128 KB; one CTA of 256 threads per SM.

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
// 128 or 256, H % KV == 0 (query head h reads KV head h / (H / KV)). The
// bf16 kernel's q, k and v start on 16-byte boundaries (a tensor map's
// base; the wrapper copies a view that does not).
#include <cuda.h>

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
constexpr int ISSUER = 128;           // the thread that issues every TMA load
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

template <int HD>
struct TcFwd {
  static constexpr int HDP = HD <= 64 ? 64 : (HD <= 128 ? 128 : 256);  // padded
  static constexpr int CB = HDP / 64;                  // 64-column blocks (TMA boxes)
  static constexpr int NB = HD / 64;                   // m64n64 blocks of O
  static constexpr bool N32 = HD % 64 != 0;            // + an m64n32 block (hd 96)
  static constexpr int KSTEPS = HD / 16;               // K steps of S = Q K^T
  static constexpr int STAGES = HD > 128 ? 2 : 3;      // K/V ring
  static constexpr int Q_TILE = 64 * HDP * 2;          // one warpgroup's Q, bytes
  static constexpr int KV_TILE = TC_BK * HDP * 2;
  static constexpr int BOX = 64 * 64 * 2;              // one TMA box, bytes
  // Q; K and V per stage; full and empty barriers per stage; alignment
  static constexpr int SMEM = 2 * Q_TILE + STAGES * 2 * KV_TILE + STAGES * 16 + 1024;
};

template <int HD>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       bf16* __restrict__ o, float* __restrict__ lse, int Sq, int Skv,
                       int H, int KV, int causal, int window, float scale) {
  using C = TcFwd<HD>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (tc::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;                          // + wg * Q_TILE
  const uint32_t sKV = base + 2 * C::Q_TILE;         // stage st: K, then V
  const uint32_t full = sKV + C::STAGES * 2 * C::KV_TILE;  // + 8 st
  const uint32_t empty = full + 8 * C::STAGES;             // + 8 st

  const int nqt = (Sq + TC_BQ - 1) / TC_BQ;
  const int qt = causal ? nqt - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KV);
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = t & 31;
  const int q_lo = qt * TC_BQ, q_rows = min(TC_BQ, Sq - q_lo);
  const int q_hi = q_lo + q_rows - 1;
  const bool wg_live = wg * 64 < q_rows;   // a half-filled tile's second warpgroup idles

  // the key tiles some row of this q tile can see: [kt0, kt0 + n)
  const int nkt = Skv / TC_BK;
  const int kt1 = causal ? min(nkt, q_hi / TC_BK + 1) : nkt;
  const int kt0 = window ? max(0, q_lo - window + 1) / TC_BK : 0;
  const int n = kt1 - kt0;

  if (tid == 0) {
    for (int st = 0; st < C::STAGES; ++st) {
      tc::mbar_init(full + 8 * st, 1);
      tc::mbar_init(empty + 8 * st, TC_THREADS / 32);
    }
    tc::mbar_fence_init();
  }
  __syncthreads();

  // tile j of the walk into stage j % STAGES (the first fill of stage 0
  // carries the Q tile too)
  const void *mq = &tm_q, *mk = &tm_k, *mv = &tm_v;
  auto issue = [&](int j) {
    const int st = j % C::STAGES;
    const uint32_t bar = full + 8 * st;
    const int q_boxes = j == 0 ? (q_rows > 64 ? 2 : 1) * C::CB : 0;
    tc::mbar_expect_tx(bar, (2 * C::CB + q_boxes) * C::BOX);
    if (j == 0)
      for (int w = 0; w * 64 < q_rows; ++w)
        for (int cb = 0; cb < C::CB; ++cb)
          tc::tma_load_4d(sQ + w * C::Q_TILE + cb * C::BOX, mq, bar, cb * 64, h,
                          q_lo + 64 * w, b);
    const uint32_t kt_s = sKV + st * 2 * C::KV_TILE;
    const int row = (kt0 + j) * TC_BK;
    for (int cb = 0; cb < C::CB; ++cb) {
      tc::tma_load_4d(kt_s + cb * C::BOX, mk, bar, cb * 64, kvh, row, b);
      tc::tma_load_4d(kt_s + C::KV_TILE + cb * C::BOX, mv, bar, cb * 64, kvh, row, b);
    }
  };
  if (tid == ISSUER)
    for (int j = 0; j < min(n, C::STAGES); ++j) issue(j);
  __syncwarp();

  // O: 64-column blocks, and at hd 96 a 32-column block (the first 16
  // registers of the 64-column layout)
  float acc[C::NB][32], acc32[C::N32 ? 16 : 1];
#pragma unroll
  for (int nb = 0; nb < C::NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;
#pragma unroll
  for (int i = 0; i < (C::N32 ? 16 : 1); ++i) acc32[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const int row0 = q_lo + wg * 64 + warp * 16 + (lane >> 2);  // and row0 + 8
  const uint32_t myQ = sQ + wg * C::Q_TILE;
  const float c2 = scale * LOG2E;  // unscaled scores to base-2 exponents
  // this warpgroup's q rows, and whether any of them sees some key of
  // tile j: a tile none of them sees is skipped (its probabilities would
  // be zeros, or, before the first visible key, terms that the first
  // visible tile's rescale by exp(NEG_INF - m) = 0 wipes out exactly)
  const int wq_lo = q_lo + wg * 64, wq_hi = wq_lo + 63;
  auto vis = [&](int j) {
    const int k_lo = (kt0 + j) * TC_BK;
    return wg_live && (!causal || k_lo <= wq_hi) &&
           (!window || k_lo + TC_BK - 1 > wq_lo - window);
  };

  for (int j = 0; j < n; ++j) {
    const int st = j % C::STAGES;
    const uint32_t sK = sKV + st * 2 * C::KV_TILE, sV = sK + C::KV_TILE;
    tc::mbar_wait(full + 8 * st, (j / C::STAGES) & 1);
    if (vis(j)) {
      // S = Q K^T, float32 sums of bf16 products
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      tc::fence();
#pragma unroll
      for (int kk = 0; kk < C::KSTEPS; ++kk)
        tc::mma_ss(s, tc::desc_k<64>(myQ, kk), tc::desc_k<TC_BK>(sK, kk), kk > 0);
      tc::commit();
      tc::wait<0>();
      tc::fence_regs(s);

      // mask and the online softmax on the fragment: rows row0 (r = 0)
      // and row0 + 8 (r = 1), each shared by the quad of lanes 4 (lane / 4)
      const int k_lo = (kt0 + j) * TC_BK;
      float mx[2] = {NEG_INF, NEG_INF};   // the tile's row max, unscaled
      if ((causal && k_lo + TC_BK - 1 > wq_lo) || (window && k_lo <= wq_hi - window)) {
        // a tile across the causal diagonal or the window's lower edge
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1, row = row0 + 8 * r;
          const int col = k_lo + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          bool ok = true;
          if (causal) ok = ok && col <= row;
          if (window) ok = ok && col > row - window;
          if (!ok) s[i] = NEG_INF;
          mx[r] = fmaxf(mx[r], s[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
      // base 2: m is the running max of s * c2 (rounding is monotonic, so
      // the max of the products is the product of the max), and
      // P = exp2(s * c2 - m) is one fma and one exp2
      float rs[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * c2);
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = exp2f(fmaf(s[i], c2, -m[r]));
        rs[r] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        l[r] = l[r] * alpha[r] + rs[r];
      }
#pragma unroll
      for (int nb = 0; nb < C::NB; ++nb)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[nb][i] *= alpha[(i >> 1) & 1];
      if constexpr (C::N32) {
#pragma unroll
        for (int i = 0; i < 16; ++i) acc32[i] *= alpha[(i >> 1) & 1];
      }

      // O += P_hi V + P_lo V over the real head dimension
      uint32_t ph[4][4], pl[4][4];
      tc::split_frag(s, ph, pl);
      tc::fence();
#pragma unroll
      for (int kk = 0; kk < TC_BK / 16; ++kk) {
#pragma unroll
        for (int nb = 0; nb < C::NB; ++nb) {
          const uint64_t dv = tc::desc_mn<TC_BK>(sV, kk, nb);
          tc::mma_rs(acc[nb], ph[kk], dv);
          tc::mma_rs(acc[nb], pl[kk], dv);
        }
        if constexpr (C::N32) {
          const uint64_t dv = tc::desc_mn<TC_BK>(sV, kk, C::NB);
          tc::mma_rs(acc32, ph[kk], dv);
          tc::mma_rs(acc32, pl[kk], dv);
        }
      }
      tc::commit();
      tc::wait<0>();
#pragma unroll
      for (int nb = 0; nb < C::NB; ++nb) tc::fence_regs(acc[nb]);
      if constexpr (C::N32) tc::fence_regs(acc32);
    }

    // this warp is done with the stage; once every warp is, the issuer
    // refills it
    __syncwarp();
    if (lane == 0) tc::mbar_arrive(empty + 8 * st);
    if (tid == ISSUER && j + C::STAGES < n) {
      tc::mbar_wait(empty + 8 * st, (j / C::STAGES) & 1);
      issue(j + C::STAGES);
    }
    __syncwarp();  // the issuer's warp reconverges before its next wgmma
  }

  if (!wg_live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const float lsum = l[r] == 0.f ? 1.f : l[r];
    if ((lane & 3) == 0)  // a natural log, as the reference's
      lse[((long long)b * H + h) * Sq + row] = m[r] * LN2 + logf(lsum);
    bf16* orow = o + ((long long)b * Sq + row) * ((long long)H * HD) + (long long)h * HD;
#pragma unroll
    for (int nb = 0; nb < C::NB; ++nb)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = nb * 64 + 8 * jj + 2 * (lane & 3), i = 4 * jj + 2 * r;
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[nb][i] / lsum, acc[nb][i + 1] / lsum);
      }
    if constexpr (C::N32) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = C::NB * 64 + 8 * jj + 2 * (lane & 3), i = 4 * jj + 2 * r;
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc32[i] / lsum, acc32[i + 1] / lsum);
      }
    }
  }
}

// cuTensorMapEncodeTiled, a libcuda function, resolved once through the
// CUDA runtime, so that the library needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a (batch, seq, heads, hd) bf16 tensor as a 4-d tensor map (innermost
// first) whose box is 64 columns of one head by 64 sequence rows, swizzled
// as wgmma reads it; returns 0 or the encode's CUresult
int make_map(CUtensorMap* map, const void* ptr, int batch, int seq, int heads, int hd) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)seq,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)seq * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                            const_cast<void*>(ptr), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return static_cast<int>(r);
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, void* lse,
                 int B, int Sq, int Skv, int H, int KV, int causal, int window,
                 float scale, cudaStream_t s) {
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, q, B, Sq, H, HD);
  if (err == 0) err = make_map(&mk, k, B, Skv, KV, HD);
  if (err == 0) err = make_map(&mv, v, B, Skv, KV, HD);
  if (err != 0) return err;
  constexpr int smem = TcFwd<HD>::SMEM;
  auto kern = flash_fwd_wgmma_kernel<HD>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + TC_BQ - 1) / TC_BQ, H, B);
  kern<<<grid, TC_THREADS, smem, s>>>(mq, mk, mv, static_cast<bf16*>(o),
                                      static_cast<float*>(lse), Sq, Skv, H, KV, causal,
                                      window, scale);
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
