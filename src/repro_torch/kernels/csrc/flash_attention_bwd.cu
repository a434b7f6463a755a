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
// seven). This first version runs every product on the CUDA cores in
// float32 (IEEE fmaf, never TF32), well above that floor; tensor-core
// tiles are later work.
//
// Design. Both passes recompute P = exp(S - lse) from the scaled q (q is
// widened to float32, then scaled, as the forward does) and
// dS = P * (dP - D). Masked pairs get P = 0, and tiles with no visible
// pair (past the causal frontier, wholly outside the window) are
// skipped, as the reference's _visible skips them. No atomics: a resume is
// bit-exact only if every gradient is the same from run to run.
//  * dkv: one CTA of 8 warps per (key tile, query head, batch) walks the
//    q tiles that can see it. dK and dV of the tile stay in registers (warp
//    w owns keys w, w + 8, ...; lane j owns columns j, j + 32, ...) and are
//    written once, in float32, per *query* head: (B, Skv, H, hd). The
//    wrapper sums them over each KV head's group, as the reference does.
//  * dq: one CTA per (q tile, query head, batch) walks the visible key
//    tiles; warp w owns q rows (its own rows of dS, so only a __syncwarp
//    lies between computing dS and reading it back) and writes dq * scale
//    in q's type.
// Tiles are float32 in shared memory; K and V rows are padded to hd + 1
// floats, so lane j reading key j's column d hits bank (j + d) % 32. At
// head dim 256 a 64-row set of K, V, Q and dO tiles would not fit in the
// 227 KB a block may use, so the tiles there are 32 rows (137 KB for dkv);
// at hd <= 128 they are 64 rows (161 KB at hd 128). Both passes opt into
// that much dynamic shared memory and run one CTA per SM.
//
// Shapes: q, do (B, Sq, H, hd); k, v (B, Skv, KV, hd); lse, dsum (B, H, Sq)
// float32; dk, dv out (B, Skv, H, hd) float32; dq out like q. Sq and Skv
// are multiples of 64 (the wrapper pads), hd is 64, 96, 128 or 256,
// H % KV == 0. Built for float32 and bfloat16.
#include "common.cuh"

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

template <typename T, int HD, bool DKV>
int launch(const Args& a, cudaStream_t s) {
  if constexpr (DKV) return launch_dkv<T, HD>(a, s);
  else return launch_dq<T, HD>(a, s);
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
