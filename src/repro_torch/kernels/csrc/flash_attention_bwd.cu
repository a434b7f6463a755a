// Flash-attention backward: the two-pass formulation of causal /
// sliding-window GQA attention's gradients, from the forward's per-row
// log-sum-exp and D = rowsum(dO * O).
//
// Replaces src/repro/kernels/flash_attention/flash_attention.py
// (_dkv_kernel -> spot_flash_attention_dkv, _dq_kernel ->
// spot_flash_attention_dq, via flash_attention_bwd).
//
// What bounds them on an H100: operations. Per visible (q row, key) pair
// the dkv pass does four products over the head dimension (S = Q K^T,
// dP = dO V^T, dV += P^T dO, dK += dS^T Q) and the dq pass three (S, dP,
// dQ += dS K), against 2 * hd loaded values per row, far above the card's
// ~295 operations per byte; their floor is the FLOPs over the tensor-core
// rate (a fused one-pass backward needs five products for both, not
// seven), reachable only through wgmma.
//
// Both passes recompute P = exp(S - lse) and dS = P * (dP - D). Masked
// pairs get P = 0, and tiles with no visible pair (past the causal
// frontier, wholly outside the window) are skipped, as the reference's
// _visible skips them. No atomics: every output has one writer, so a
// resume is bit-exact (every gradient is the same from run to run).
//
// dkv in bfloat16: flash_dkv_wgmma_kernel, on the tensor cores. One CTA of
// two warpgroups per (64-key tile, query head, batch) walks the q tiles of
// 64 rows that can see it, everything in the transposed form so that the
// key rows are every product's M dimension: S^T = K Q^T and
// dP^T = V dO^T (SS wgmma, bf16 operands, float32 sums), then
// P^T = exp(S^T * scale - lse) (the scale applied in float32 after the
// product) and dS^T = P^T (dP^T - D) on the fragment in registers, then
// dV += P^T dO and dK += dS^T Q (RS wgmma, the fragment as A, dO and Q
// read transposed). P^T and dS^T go in as bf16 hi + lo pairs (hi =
// bf16(x), lo = bf16(x - hi)), two products into one float32
// accumulator: rounded once to bf16 they miss the gradient tolerance by
// 6.5-10.5x; split, the error uses about 1-2% of it. dK is multiplied by
// the scale once at the end, in float32. The crux is registers at hd 256:
// dK and dV of 64 keys x 256 columns in float32 are 128 registers a thread
// each over one warpgroup. Here the two warpgroups split the head
// dimension in halves for dK and dV (64 + 64 accumulator registers each)
// and each computes the whole S^T and dP^T itself (K-dim hd): the two
// halves need no exchange through shared memory and no barrier between
// the warpgroups beyond the tile loads, at the price of computing S^T and
// dP^T twice (8 units of tensor work per pair instead of 6 with the split;
// the other fitting design, dK accumulated in shared memory, was not
// built). Shared memory at hd 256: K and V 64 KB, Q and dO in two stages
// 128 KB (cp.async while the previous tile computes), lse and D; one CTA
// of 256 threads per SM. hd 64 and 96 are zero-padded to 128 in shared
// memory (zeros add nothing; padded columns are never stored). dK and dV
// are written once, in float32, per *query* head: (B, Skv, H, hd); the
// wrapper sums them over each KV head's group, as the reference does.
//
// dkv in float32, and dq in both dtypes: on the CUDA cores in float32
// (IEEE fmaf, never TF32), their bound shared-memory loads well above the
// floor. q is widened to float32, then scaled, as the forward does.
//  * dkv: one CTA of 8 warps per (key tile, query head, batch) walks the
//    q tiles that can see it. dK and dV of the tile stay in registers (warp
//    w owns keys w, w + 8, ...; lane j owns columns j, j + 32, ...).
//  * dq: one CTA per (q tile, query head, batch) walks the visible key
//    tiles; warp w owns q rows (its own rows of dS, so only a __syncwarp
//    lies between computing dS and reading it back) and writes dq * scale
//    in q's type.
// Their tiles are float32 in shared memory; K and V rows are padded to
// hd + 1 floats, so lane j reading key j's column d hits bank (j + d) % 32.
// At head dim 256 a 64-row set of K, V, Q and dO tiles would not fit in the
// 227 KB a block may use, so the tiles there are 32 rows (137 KB for dkv);
// at hd <= 128 they are 64 rows (161 KB at hd 128). Both opt into that
// much dynamic shared memory and run one CTA per SM.
//
// Shapes: q, do (B, Sq, H, hd); k, v (B, Skv, KV, hd); lse, dsum (B, H, Sq)
// float32; dk, dv out (B, Skv, H, hd) float32; dq out like q. Sq and Skv
// are multiples of 64 (the wrapper pads), hd is 64, 96, 128 or 256,
// H % KV == 0.
#include "common.cuh"
#include "wgmma.cuh"

#include <type_traits>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

template <int HD>
constexpr int tile_rows() { return HD > 128 ? 32 : 64; }

// global (row stride `stride`) -> shared float32 tile of `rows` x HD with
// leading dimension LD, each value times `mul`
template <typename T, int HD, int LD>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src,
                                          long long stride, int rows,
                                          float mul) {
  for (int i = threadIdx.x; i < rows * HD; i += THREADS) {
    const int r = i / HD, d = i - r * HD;
    dst[r * LD + d] = spot::to_f32<T>(src[r * stride + d]) * mul;
  }
}

// P and dS of one (q tile, key tile) pair. Warp w owns q rows
// w * RW .. w * RW + RW - 1, lane j owns keys j, j + 32 (BT / 32 of them).
// Ps may be null (the dq pass needs only dS).
template <int HD, int BT>
__device__ __forceinline__ void probs(const float* __restrict__ Qs,
                                      const float* __restrict__ dOs,
                                      const float* __restrict__ Ks,
                                      const float* __restrict__ Vs,
                                      const float* __restrict__ lse_s,
                                      const float* __restrict__ dsum_s,
                                      float* __restrict__ Ps,
                                      float* __restrict__ dSs, int q_lo,
                                      int k_lo, int causal, int window) {
  constexpr int RW = BT / WARPS, KC = BT / 32, LD = HD + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float s[RW][KC], dp[RW][KC];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int c = 0; c < KC; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float kk[KC][4], vv[KC][4];
#pragma unroll
    for (int c = 0; c < KC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        kk[c][e] = Ks[(lane + 32 * c) * LD + d + e];
        vv[c][e] = Vs[(lane + 32 * c) * LD + d + e];
      }
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int i = warp * RW + r;
      const float4 qv = *reinterpret_cast<const float4*>(Qs + i * HD + d);
      const float4 ov = *reinterpret_cast<const float4*>(dOs + i * HD + d);
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        s[r][c] = fmaf(qv.x, kk[c][0], s[r][c]);
        s[r][c] = fmaf(qv.y, kk[c][1], s[r][c]);
        s[r][c] = fmaf(qv.z, kk[c][2], s[r][c]);
        s[r][c] = fmaf(qv.w, kk[c][3], s[r][c]);
        dp[r][c] = fmaf(ov.x, vv[c][0], dp[r][c]);
        dp[r][c] = fmaf(ov.y, vv[c][1], dp[r][c]);
        dp[r][c] = fmaf(ov.z, vv[c][2], dp[r][c]);
        dp[r][c] = fmaf(ov.w, vv[c][3], dp[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int i = warp * RW + r, qpos = q_lo + i;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      const int j = lane + 32 * c, kpos = k_lo + j;
      bool ok = true;
      if (causal) ok = ok && kpos <= qpos;
      if (window) ok = ok && kpos > qpos - window;
      const float p = ok ? expf(s[r][c] - lse_s[i]) : 0.f;
      if (Ps != nullptr) Ps[i * BT + j] = p;
      dSs[i * BT + j] = p * (dp[r][c] - dsum_s[i]);
    }
  }
}

template <int HD, int BT>
constexpr size_t dkv_smem() {
  return sizeof(float) * (size_t)(2 * BT * (HD + 1) + 2 * BT * HD + 2 * BT * BT + 2 * BT);
}

template <int HD, int BT>
constexpr size_t dq_smem() {
  return sizeof(float) * (size_t)(2 * BT * (HD + 1) + 2 * BT * HD + BT * BT + 2 * BT);
}

template <typename T, int HD, int BT>
__global__ void __launch_bounds__(THREADS, 1)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ dsum,
                 float* __restrict__ dk, float* __restrict__ dv, int Sq,
                 int Skv, int H, int KV, int causal, int window, float scale) {
  constexpr int LD = HD + 1, RK = BT / WARPS, DC = HD / 32;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                 // BT x LD
  float* Vs = Ks + BT * LD;         // BT x LD
  float* Qs = Vs + BT * LD;         // BT x HD, scaled
  float* dOs = Qs + BT * HD;        // BT x HD
  float* Ps = dOs + BT * HD;        // BT x BT
  float* dSs = Ps + BT * BT;        // BT x BT
  float* lse_s = dSs + BT * BT;     // BT
  float* dsum_s = lse_s + BT;       // BT

  const int ki = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k_lo = ki * BT, k_hi = k_lo + BT - 1;
  const long long q_stride = (long long)H * HD, kv_stride = (long long)KV * HD;
  const long long kv_off = ((long long)b * Skv + k_lo) * kv_stride + (long long)kvh * HD;
  load_tile<T, HD, LD>(Ks, k + kv_off, kv_stride, BT, 1.f);
  load_tile<T, HD, LD>(Vs, v + kv_off, kv_stride, BT, 1.f);

  float dk_acc[RK][DC], dv_acc[RK][DC];
#pragma unroll
  for (int t = 0; t < RK; ++t)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[t][c] = dv_acc[t][c] = 0.f;

  const int nq = Sq / BT;
  for (int qi = 0; qi < nq; ++qi) {
    const int q_lo = qi * BT, q_hi = q_lo + BT - 1;
    if (causal && k_lo > q_hi) continue;          // no row of the tile sees it
    if (window && k_hi <= q_lo - window) break;   // nor any later tile
    __syncthreads();  // the previous tile's readers are done
    const long long q_off = ((long long)b * Sq + q_lo) * q_stride + (long long)h * HD;
    load_tile<T, HD, HD>(Qs, q + q_off, q_stride, BT, scale);
    load_tile<T, HD, HD>(dOs, dout + q_off, q_stride, BT, 1.f);
    const long long row = ((long long)b * H + h) * Sq + q_lo;
    for (int i = threadIdx.x; i < BT; i += THREADS) {
      lse_s[i] = lse[row + i];
      dsum_s[i] = dsum[row + i];
    }
    __syncthreads();
    probs<HD, BT>(Qs, dOs, Ks, Vs, lse_s, dsum_s, Ps, dSs, q_lo, k_lo, causal,
                  window);
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q over the tile's q rows
#pragma unroll 1
    for (int i = 0; i < BT; ++i) {
      float qv[DC], ov[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        qv[c] = Qs[i * HD + lane + 32 * c];
        ov[c] = dOs[i * HD + lane + 32 * c];
      }
#pragma unroll
      for (int t = 0; t < RK; ++t) {
        const int j = warp + WARPS * t;
        const float p = Ps[i * BT + j], ds = dSs[i * BT + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dv_acc[t][c] = fmaf(p, ov[c], dv_acc[t][c]);
          dk_acc[t][c] = fmaf(ds, qv[c], dk_acc[t][c]);
        }
      }
    }
  }

#pragma unroll
  for (int t = 0; t < RK; ++t) {
    const int j = warp + WARPS * t;
    const long long o = (((long long)b * Skv + k_lo + j) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[o + lane + 32 * c] = dk_acc[t][c];
      dv[o + lane + 32 * c] = dv_acc[t][c];
    }
  }
}

template <typename T, int HD, int BT>
__global__ void __launch_bounds__(THREADS, 1)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ dsum,
                T* __restrict__ dq, int Sq, int Skv, int H, int KV, int causal,
                int window, float scale) {
  constexpr int LD = HD + 1, RW = BT / WARPS, DC = HD / 32;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                 // BT x LD
  float* Vs = Ks + BT * LD;         // BT x LD
  float* Qs = Vs + BT * LD;         // BT x HD, scaled
  float* dOs = Qs + BT * HD;        // BT x HD
  float* dSs = dOs + BT * HD;       // BT x BT
  float* lse_s = dSs + BT * BT;     // BT
  float* dsum_s = lse_s + BT;       // BT

  const int qi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q_lo = qi * BT, q_hi = q_lo + BT - 1;
  const long long q_stride = (long long)H * HD, kv_stride = (long long)KV * HD;
  const long long q_off = ((long long)b * Sq + q_lo) * q_stride + (long long)h * HD;
  load_tile<T, HD, HD>(Qs, q + q_off, q_stride, BT, scale);
  load_tile<T, HD, HD>(dOs, dout + q_off, q_stride, BT, 1.f);
  const long long row = ((long long)b * H + h) * Sq + q_lo;
  for (int i = threadIdx.x; i < BT; i += THREADS) {
    lse_s[i] = lse[row + i];
    dsum_s[i] = dsum[row + i];
  }

  float acc[RW][DC];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;

  const int nk = Skv / BT;
  for (int ki = 0; ki < nk; ++ki) {
    const int k_lo = ki * BT, k_hi = k_lo + BT - 1;
    if (causal && k_lo > q_hi) break;              // past the causal frontier
    if (window && k_hi <= q_lo - window) continue;  // wholly outside the band
    __syncthreads();  // the previous tile's readers are done (and Q is loaded)
    const long long kv_off = ((long long)b * Skv + k_lo) * kv_stride + (long long)kvh * HD;
    load_tile<T, HD, LD>(Ks, k + kv_off, kv_stride, BT, 1.f);
    load_tile<T, HD, LD>(Vs, v + kv_off, kv_stride, BT, 1.f);
    __syncthreads();
    probs<HD, BT>(Qs, dOs, Ks, Vs, lse_s, dsum_s, nullptr, dSs, q_lo, k_lo,
                  causal, window);
    __syncwarp();  // each warp reads back only the dS rows it wrote
    // dQ += dS K over the tile's keys
#pragma unroll 1
    for (int j = 0; j < BT; ++j) {
      float kk[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) kk[c] = Ks[j * LD + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float ds = dSs[(warp * RW + r) * BT + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(ds, kk[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RW; ++r) {
    T* orow = dq + (((long long)b * Sq + q_lo + warp * RW + r) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      orow[lane + 32 * c] = spot::from_f32<T>(acc[r][c] * scale);
  }
}

// ---------------------------------------------------------------------------
// dkv in bfloat16 on the tensor cores
// ---------------------------------------------------------------------------

namespace tc = spot::tc;
using bf16 = __nv_bfloat16;

constexpr int TC_B = 64;              // keys per CTA, q rows per tile
constexpr int TC_THREADS = 256;       // two warpgroups

template <int HD>
struct TcDkv {
  static constexpr int HDP = HD <= 128 ? 128 : 256;   // padded head dim
  static constexpr int NBW = HDP / 128;  // 64-column blocks of dK, dV per warpgroup
  static constexpr int TILE = TC_B * HDP * 2;          // bytes
  // K, V; Q and dO in two stages; lse and D in two stages; alignment
  static constexpr int SMEM = 6 * TILE + 2 * 2 * TC_B * 4 + 1024;
};

template <int HD>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_dkv_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ dsum,
                       float* __restrict__ dk, float* __restrict__ dv, int Sq,
                       int Skv, int H, int KV, int causal, int window, float scale) {
  using C = TcDkv<HD>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = tc::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base, sV = base + C::TILE;
  const uint32_t sQ = base + 2 * C::TILE, sdO = base + 4 * C::TILE;  // + st * TILE
  float* stat = reinterpret_cast<float*>(smem_raw + (base - raw) + 6 * C::TILE);
  const uint32_t sStat = base + 6 * C::TILE;    // stage st: lse at + 512 st, D + 256

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = t & 31;
  const int k_lo = kt * TC_B, k_hi = k_lo + TC_B - 1;
  const long long qs = (long long)H * HD, kvs = (long long)KV * HD;

  // the q tiles with a row that sees some key of this tile: [qt0, qt1)
  const int nqt = Sq / TC_B;
  const int qt0 = causal ? k_lo / TC_B : 0;
  const int qt1 = window ? min(nqt, (k_hi + window - 1) / TC_B + 1) : nqt;

  const long long kv_off = ((long long)b * Skv + k_lo) * kvs + (long long)kvh * HD;
  tc::load_tile<TC_B, C::HDP, TC_THREADS>(sK, k + kv_off, kvs, TC_B, HD, tid);
  tc::load_tile<TC_B, C::HDP, TC_THREADS>(sV, v + kv_off, kvs, TC_B, HD, tid);
  auto load_q = [&](int qt, int st) {
    const long long off = ((long long)b * Sq + qt * TC_B) * qs + (long long)h * HD;
    tc::load_tile<TC_B, C::HDP, TC_THREADS>(sQ + st * C::TILE, q + off, qs, TC_B, HD, tid);
    tc::load_tile<TC_B, C::HDP, TC_THREADS>(sdO + st * C::TILE, dout + off, qs, TC_B, HD,
                                            tid);
    if (tid < 32) {  // 64 lse and 64 D values, 16 bytes a thread
      const long long row = ((long long)b * H + h) * Sq + qt * TC_B + (tid & 15) * 4;
      tc::cp_async16(sStat + st * 512 + (tid >> 4) * 256 + (tid & 15) * 16,
                     (tid < 16 ? lse : dsum) + row, true);
    }
  };
  if (qt0 < qt1) load_q(qt0, 0);
  tc::cp_async_commit();

  float dka[C::NBW][32], dva[C::NBW][32];
#pragma unroll
  for (int n = 0; n < C::NBW; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[n][i] = dva[n][i] = 0.f;
  const int key0 = k_lo + warp * 16 + (lane >> 2);  // and key0 + 8

  for (int qt = qt0; qt < qt1; ++qt) {
    const int st = (qt - qt0) & 1;
    if (qt + 1 < qt1) load_q(qt + 1, st ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    tc::fence_async_smem();
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T over the whole head dimension
    const uint32_t q_t = sQ + st * C::TILE, do_t = sdO + st * C::TILE;
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    tc::fence();
#pragma unroll
    for (int kk = 0; kk < C::HDP / 16; ++kk)
      tc::mma_ss(s, tc::desc_k<TC_B>(sK, kk), tc::desc_k<TC_B>(q_t, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < C::HDP / 16; ++kk)
      tc::mma_ss(dp, tc::desc_k<TC_B>(sV, kk), tc::desc_k<TC_B>(do_t, kk), kk > 0);
    tc::commit();
    tc::wait<0>();
    tc::fence_regs(s);
    tc::fence_regs(dp);

    // P^T and dS^T on the fragment: key rows key0 (+ 8), q columns
    const float* lse_s = stat + st * 128;
    const float* dsum_s = lse_s + 64;
    const int q_lo = qt * TC_B;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = key0 + 8 * ((i >> 1) & 1);
      const int c = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1), qpos = q_lo + c;
      bool ok = true;
      if (causal) ok = ok && key <= qpos;
      if (window) ok = ok && key > qpos - window;
      const float p = ok ? expf(s[i] * scale - lse_s[c]) : 0.f;
      s[i] = p;
      dp[i] = p * (dp[i] - dsum_s[c]);
    }
    uint32_t ph[4][4], pl[4][4], dh[4][4], dl[4][4];
    tc::split_frag(s, ph, pl);
    tc::split_frag(dp, dh, dl);

    // dV += P^T dO, dK += dS^T Q on this warpgroup's half of the columns
    tc::fence();
#pragma unroll
    for (int kk = 0; kk < TC_B / 16; ++kk)
#pragma unroll
      for (int n = 0; n < C::NBW; ++n) {
        const int nb = wg * C::NBW + n;
        const uint64_t d_do = tc::desc_mn<TC_B>(do_t, kk, nb);
        const uint64_t d_q = tc::desc_mn<TC_B>(q_t, kk, nb);
        tc::mma_rs(dva[n], ph[kk], d_do);
        tc::mma_rs(dva[n], pl[kk], d_do);
        tc::mma_rs(dka[n], dh[kk], d_q);
        tc::mma_rs(dka[n], dl[kk], d_q);
      }
    tc::commit();
    tc::wait<0>();
#pragma unroll
    for (int n = 0; n < C::NBW; ++n) {
      tc::fence_regs(dva[n]);
      tc::fence_regs(dka[n]);
    }
    __syncthreads();  // both warpgroups are done with this stage
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long o = (((long long)b * Skv + key0 + 8 * r) * H + h) * HD;
#pragma unroll
    for (int n = 0; n < C::NBW; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = (wg * C::NBW + n) * 64 + 8 * j + 2 * (lane & 3);
        if (col < HD) {
          const int i = 4 * j + 2 * r;
          *reinterpret_cast<float2*>(dk + o + col) =
              make_float2(dka[n][i] * scale, dka[n][i + 1] * scale);
          *reinterpret_cast<float2*>(dv + o + col) = make_float2(dva[n][i], dva[n][i + 1]);
        }
      }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *dsum;
  void *dq, *dk, *dv;
  int B, Sq, Skv, H, KV, causal, window;
  float scale;
};

template <typename T, int HD>
int launch_dkv(const Args& a, cudaStream_t s) {
  constexpr int BT = tile_rows<HD>();
  constexpr size_t smem = dkv_smem<HD, BT>();
  if (a.Sq % BT || a.Skv % BT) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_dkv_kernel<T, HD, BT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.Skv / BT, a.H, a.B);
  kern<<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.dsum),
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.Sq, a.Skv, a.H,
      a.KV, a.causal, a.window, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_dq(const Args& a, cudaStream_t s) {
  constexpr int BT = tile_rows<HD>();
  constexpr size_t smem = dq_smem<HD, BT>();
  if (a.Sq % BT || a.Skv % BT) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_dq_kernel<T, HD, BT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.Sq / BT, a.H, a.B);
  kern<<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.dsum),
      static_cast<T*>(a.dq), a.Sq, a.Skv, a.H, a.KV, a.causal, a.window,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dkv_wgmma(const Args& a, cudaStream_t s) {
  constexpr int smem = TcDkv<HD>::SMEM;
  if (a.Sq % TC_B || a.Skv % TC_B) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_dkv_wgmma_kernel<HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.Skv / TC_B, a.H, a.B);
  kern<<<grid, TC_THREADS, smem, s>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.dsum),
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.Sq, a.Skv, a.H, a.KV,
      a.causal, a.window, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// bfloat16 dkv on the tensor cores; float32 dkv and dq in both dtypes on
// the CUDA cores: a fixed choice by dtype
template <typename T, int HD, bool DKV>
int launch(const Args& a, cudaStream_t s) {
  if constexpr (!DKV) return launch_dq<T, HD>(a, s);
  else if constexpr (std::is_same_v<T, bf16>) return launch_dkv_wgmma<HD>(a, s);
  else return launch_dkv<T, HD>(a, s);
}

template <typename T, bool DKV>
int dispatch_hd(int hd, const Args& a, cudaStream_t s) {
  switch (hd) {
    case 64: return launch<T, 64, DKV>(a, s);
    case 96: return launch<T, 96, DKV>(a, s);
    case 128: return launch<T, 128, DKV>(a, s);
    case 256: return launch<T, 256, DKV>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool DKV>
int dispatch(int hd, int dtype_code, const Args& a, void* stream) {
  if (a.KV <= 0 || a.H % a.KV) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case spot::kF32: return dispatch_hd<float, DKV>(hd, a, s);
    case spot::kBF16: return dispatch_hd<__nv_bfloat16, DKV>(hd, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int spot_flash_attention_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dsum, void* dk, void* dv, int B, int Sq,
    int Skv, int H, int KV, int hd, int dtype_code, int causal, int window,
    float scale, void* stream) {
  const Args a{q, k, v, dout, lse, dsum, nullptr, dk, dv,
               B, Sq, Skv, H, KV, causal, window, scale};
  return dispatch<true>(hd, dtype_code, a, stream);
}

extern "C" int spot_flash_attention_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dsum, void* dq, int B, int Sq, int Skv,
    int H, int KV, int hd, int dtype_code, int causal, int window,
    float scale, void* stream) {
  const Args a{q, k, v, dout, lse, dsum, dq, nullptr, nullptr,
               B, Sq, Skv, H, KV, causal, window, scale};
  return dispatch<false>(hd, dtype_code, a, stream);
}

// dynamic shared memory of the bf16 tensor-core dkv pass at head dim hd
extern "C" int spot_flash_attention_dkv_wgmma_smem(int hd) {
  switch (hd) {
    case 64: return TcDkv<64>::SMEM;
    case 96: return TcDkv<96>::SMEM;
    case 128: return TcDkv<128>::SMEM;
    case 256: return TcDkv<256>::SMEM;
    default: return -1;
  }
}
