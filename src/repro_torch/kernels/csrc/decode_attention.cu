// Flash decode: one query token per (batch, head) against a KV cache whose
// first valid_len rows are filled, with an online softmax.
//
// Replaces src/repro/kernels/decode_attention/decode_attention.py
// (_decode_kernel, via decode_attention) -> spot_decode_attention.
//
// What bounds it on an H100: bytes. Every cache row is read once per token
// and used for 2 * hd multiply-adds per query head that shares it, so the
// floor is the K/V bytes over the memory rate.
//
// Design: one CTA of 8 warps per (head, batch). Lane j holds the scaled
// float32 query columns j, j + 32, ... (hd / 32 of them) in registers.
// Warp w takes chunks of 32 keys (w, w + 8, ... in chunk units): for each
// key of the chunk the lanes read its row coalesced, form partial dot
// products and reduce them with shuffles; lane j keeps key j's score. One
// online-softmax rescale per chunk: the chunk max and the sum of exp over
// the chunk, then acc += p_j * v_j with p_j shuffled from lane j. At the end
// the 8 warps' (m, l, acc) merge through shared memory. valid_len is a
// runtime argument, so one build serves every decode position, and any
// cache depth S works (no block-multiple requirement); keys at or past
// valid_len are never read. The reference's guard is kept: a sum of 0
// divides by 1.
//
// A ring cache (sliding window) is read through the same kernel: every
// filled slot of a ring of size W holds a position within the window of the
// newest token, so the ring's validity mask is slot < min(pos + 1, W), and
// softmax does not depend on slot order.
//
// Shapes: q (B, H, hd), k/v (B, S, KV, hd), o (B, H, hd); hd is 64, 96, 128
// or 256 (at 96, phi3-mini's, each lane holds three columns);
// 1 <= valid_len <= S; H % KV == 0. Built for float32 and bfloat16, the
// dtypes the models serve in.
#include "common.cuh"

namespace {

constexpr float NEG_INF = -1073741824.0f;  // -2**30, the reference's mask value
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

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

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int S, int H,
              int KV, int valid_len, float scale) {
  constexpr int COLS = HD / 32;
  __shared__ float m_w[WARPS], l_w[WARPS];
  __shared__ float acc_w[WARPS][HD];

  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const T* qh = q + ((long long)b * H + h) * HD;
  float qr[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) qr[c] = spot::to_f32<T>(qh[lane + 32 * c]) * scale;

  const long long row = (long long)KV * HD;
  const T* kb = k + (long long)b * S * row + (long long)kvh * HD;
  const T* vb = v + (long long)b * S * row + (long long)kvh * HD;

  float m = NEG_INF, l = 0.f, acc[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) acc[c] = 0.f;

  for (int base = warp * 32; base < valid_len; base += WARPS * 32) {
    const int n = min(32, valid_len - base);
    float s_mine = NEG_INF;  // score of key base + lane
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const T* kr = kb + (long long)(base + j) * row;
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < COLS; ++c)
        part = fmaf(qr[c], spot::to_f32<T>(kr[lane + 32 * c]), part);
      part = warp_sum(part);
      if (lane == j) s_mine = part;
    }
    const float m_new = fmaxf(m, warp_max(s_mine));
    const float alpha = expf(m - m_new);
    const float p = lane < n ? expf(s_mine - m_new) : 0.f;
    l = l * alpha + warp_sum(p);
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[c] *= alpha;
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
      const T* vr = vb + (long long)(base + j) * row;
#pragma unroll
      for (int c = 0; c < COLS; ++c)
        acc[c] = fmaf(pj, spot::to_f32<T>(vr[lane + 32 * c]), acc[c]);
    }
    m = m_new;
  }

  if (lane == 0) {
    m_w[warp] = m;
    l_w[warp] = l;
  }
#pragma unroll
  for (int c = 0; c < COLS; ++c) acc_w[warp][lane + 32 * c] = acc[c];
  __syncthreads();

  float mx = NEG_INF;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, m_w[w]);
  float lsum = 0.f, f[WARPS];
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    f[w] = expf(m_w[w] - mx);
    lsum += l_w[w] * f[w];
  }
  if (lsum == 0.f) lsum = 1.f;
  T* oh = o + ((long long)b * H + h) * HD;
  for (int d = tid; d < HD; d += THREADS) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a = fmaf(acc_w[w][d], f[w], a);
    oh[d] = spot::from_f32<T>(a / lsum);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KV, int valid_len, float scale, cudaStream_t s) {
  const dim3 grid(H, B);
  decode_kernel<T, HD><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KV, valid_len, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                int B, int S, int H, int KV, int valid_len, float scale,
                cudaStream_t s) {
  switch (hd) {
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, KV, valid_len, scale, s);
    case 96: return launch<T, 96>(q, k, v, o, B, S, H, KV, valid_len, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, KV, valid_len, scale, s);
    case 256: return launch<T, 256>(q, k, v, o, B, S, H, KV, valid_len, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int spot_decode_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int S,
                                     int H, int KV, int hd, int valid_len,
                                     int dtype_code, float scale, void* stream) {
  if (valid_len < 1 || valid_len > S || KV <= 0 || H % KV)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case spot::kF32:
      return dispatch_hd<float>(hd, q, k, v, o, B, S, H, KV, valid_len, scale, s);
    case spot::kBF16:
      return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, S, H, KV, valid_len, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
