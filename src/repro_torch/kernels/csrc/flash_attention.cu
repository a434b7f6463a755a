// Flash-attention forward: causal / sliding-window GQA with an online
// softmax, returning the output and the per-row log-sum-exp.
//
// Replaces src/repro/kernels/flash_attention/flash_attention.py
// (_fwd_kernel, via flash_attention_fwd) -> spot_flash_attention_fwd.
// Two kernels behind the one entry point, chosen by dtype alone, both on
// the tensor cores: bfloat16 through wgmma, float32 through mma.sync in
// 3xTF32.
//
// What bounds it on an H100: operations. Per visible (q block, k block)
// pair the kernel does 2 * 64 * 64 * hd multiply-adds against 2 * 64 * hd
// loaded values, far above the card's ~295 operations per byte, so its
// floor is the FLOPs over the tensor-core rate: bf16's, or in float32 three
// TF32 products for each product.
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

// float32: flash_fwd_tf32x3_kernel, on the tensor cores in 3xTF32
// (mma.sync m16n8k8 tf32, float32 sums), the layout of the float32 dq pass
// (flash_attention_bwd.cu) with the online softmax in place of dP and dS,
// and O += P V in place of dQ += dS K. Every operand value x of S = Q K^T
// and of O += P V is split into hi, x rounded to TF32 as cvt.rna rounds
// it, and lo, x - hi rounded the same way (split_tf32, the backward's
// split), and a b ~ hi_a lo_b + lo_a hi_b
// + hi_a hi_b, the two small products first, into one float32 accumulator
// (tf32x3.cuh): about float32's error (the CPU emulation in
// tests/test_torch_flash_numerics.py), where one TF32 rounding misses the
// 2e-5 tolerance by 47-77x. q is scaled in float32 as its fragments load,
// before the split (the reference's q.astype(f32) * scale).
//  * Grid: one CTA of 8 warps per (64-row q tile, query head, batch), the
//    q tile in the slow grid dimension and, with a causal mask, the
//    heaviest first, so every head's heavy tiles start in the first wave.
//    Q stays in shared memory; K and V stream through a two-stage cp.async
//    ring (16 bytes a thread; the next tile's copies are issued right after
//    the one block barrier of each tile, so they overlap its products).
//    Key tiles of 32 at hd 256, 64 below. Rows are padded to hd + 4 floats,
//    so every fragment load is free of bank conflicts.
//  * S: the warps 2i and 2i + 1 (a pair) own q rows 16i .. 16i + 15. Each
//    computes S for the pair's rows and the whole key tile over its half of
//    the head dimension (each split Q fragment feeds every key block), and
//    the halves meet through shared memory, each warp keeping its half of
//    the keys (pair_sum), summed over the whole head dimension.
//  * Softmax: each warp keeps its own running max and sum over the keys it
//    keeps (half of every tile), in base 2 on the accumulator fragment:
//    m = max(s) * log2(e), P = exp2(fma(s, log2(e), -m)); the row max
//    combines across the quad (shuffles 1 and 2) and needs no other warp.
//    Masked scores take the reference's finite NEG_INF = -2**30, evaluated
//    only on a tile across the causal diagonal or the window's lower edge;
//    a tile none of the pair's rows sees is skipped, as _visible skips it,
//    and a warp skips the half tile none of its rows sees.
//  * O += P V: P goes from the accumulator layout to the A layout by
//    relabelling k (tf32x3.cuh), in registers, with no shared memory and no
//    shuffle; V is read down its rows as B under the same labels. Each warp
//    holds O for its 16 rows over the whole head dimension: hd / 2 floats
//    a thread, 128 at hd 256, where the kernel still fits in 255 registers
//    without spills (chip_smoke.py prints ptxas's counts). The alternative,
//    O's columns split across the pair, halves that but makes the pair
//    exchange P and the row max through shared memory on every tile.
//  * End: the two partial softmaxes of a pair merge once, through shared
//    memory: M = max(m0, m1), L = l0 2^(m0 - M) + l1 2^(m1 - M), each warp
//    writing its half of O's columns, O / L (a zero L divides by 1), and
//    the log-sum-exp as a natural log, M ln 2 + log L.
//  * What bounds it: the ALU work of the splits (a fragment value is one
//    shared-memory load and seven instructions) beside the tensor cores'
//    three products a product, with 8 warps an SM at hd 96-256 (16 at
//    hd 64) to hide their latencies.
//
// Shapes: q (B, Sq, H, hd), k/v (B, Skv, KV, hd), o like q, lse (B, H, Sq)
// float32; Sq and Skv are multiples of 64 (the wrapper pads), hd is 64, 96,
// 128 or 256, H % KV == 0 (query head h reads KV head h / (H / KV)). q, k
// and v start on 16-byte boundaries (a tensor map's base in bf16, cp.async's
// 16-byte copies in float32; the wrapper copies a view that does not).
#include <cuda.h>

#include "common.cuh"
#include "tf32x3.cuh"
#include "wgmma.cuh"

namespace {

constexpr float NEG_INF = -1073741824.0f;  // -2**30, the reference's mask value
constexpr int BLOCK = 64;   // Sq and Skv are multiples of it (the wrapper pads)
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// float32 on the tensor cores, 3xTF32
// ---------------------------------------------------------------------------

using namespace spot::tf32;

template <int HD>
struct F32Fwd {
  static constexpr int BQ = 64;                    // q rows per CTA
  static constexpr int BK = HD > 128 ? 32 : 64;    // keys per tile
  static constexpr int KW = BK / 2;                // keys a warp keeps
  static constexpr int NB = KW / 8;                // its 8-key blocks
  static constexpr int ND = HD / 8;                // O's 8-column blocks
  static constexpr int LD = HD + 4;                // tile row stride
  // Q; K and V in two stages; the pair sums' outboxes (NB float4 a lane)
  static constexpr int SMEM = 4 * (BQ * LD + 2 * 2 * BK * LD + F_THREADS * 4 * NB);
  // the end's exchange (half of O's blocks, then m and l: float4s a lane)
  // reuses the K and V stages
  static constexpr int NX = ND / 2 + 1;
  static_assert(F_THREADS * NX * 4 <= 2 * 2 * BK * LD, "the end's exchange fits");
  // two CTAs an SM where their shared memory fits (hd 64)
  static constexpr int MIN_BLOCKS = 2 * (SMEM + 1024) <= 232448 ? 2 : 1;
};

template <int HD>
__global__ void __launch_bounds__(F_THREADS, F32Fwd<HD>::MIN_BLOCKS)
flash_fwd_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, int Sq, int Skv, int H, int KV,
                        int causal, int window, float scale) {
  using C = F32Fwd<HD>;
  constexpr int BQ = C::BQ, BK = C::BK, KW = C::KW, NB = C::NB, ND = C::ND;
  constexpr int LD = C::LD;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                  // BQ x LD
  float* Ks = Qs + BQ * LD;          // two stages of BK x LD
  float* Vs = Ks + 2 * BK * LD;      // two stages of BK x LD
  float4* xch = reinterpret_cast<float4*>(Vs + 2 * BK * LD);  // pair sums

  // q tiles in the slow grid dimension, causal ones with the most visible
  // keys first, for every head
  const int nqt = Sq / BQ;
  const int qt = causal ? nqt - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int h = blockIdx.x % H, b = blockIdx.x / H, kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int half = warp & 1;          // its half of S's head dim and of the keys
  const int q_lo = qt * BQ, q_hi = q_lo + BQ - 1;
  const int r_lo = q_lo + (warp >> 1) * 16, r_hi = r_lo + 15;  // the pair's rows
  const long long qs = (long long)H * HD, kvs = (long long)KV * HD;

  // the key tiles some row of this q tile can see: [kt0, kt1)
  const int nkt = Skv / BK;
  const int kt1 = causal ? min(nkt, q_hi / BK + 1) : nkt;
  const int kt0 = window ? max(0, q_lo - window + 1) / BK : 0;

  const long long q_off = ((long long)b * Sq + q_lo) * qs + (long long)h * HD;
  load_rows<BQ, HD, LD>(Qs, q + q_off, qs, tid);
  const float* kb = k + (long long)b * Skv * kvs + (long long)kvh * HD;
  const float* vb = v + (long long)b * Skv * kvs + (long long)kvh * HD;
  auto load_kv = [&](int kt, int st) {
    const long long off = (long long)kt * BK * kvs;
    load_rows<BK, HD, LD>(Ks + st * BK * LD, kb + off, kvs, tid);
    load_rows<BK, HD, LD>(Vs + st * BK * LD, vb + off, kvs, tid);
  };
  if (kt0 < kt1) load_kv(kt0, 0);
  tc::cp_async_commit();

  // O for rows r_lo + g (r = 0) and + 8 (r = 1) over the whole head
  // dimension; m in base-2 units and this lane's part of l, over the keys
  // this warp keeps
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int kt = kt0; kt < kt1; ++kt) {
    const int st = (kt - kt0) & 1;
    tc::cp_async_wait<0>();
    __syncthreads();  // tile kt has landed; every warp is done with kt - 1
    if (kt + 1 < kt1) load_kv(kt + 1, st ^ 1);
    tc::cp_async_commit();
    const int k_lo = kt * BK;
    // a tile none of the pair's rows sees
    if ((causal && k_lo > r_hi) || (window && k_lo + BK - 1 <= r_lo - window)) continue;
    const float* Kt = Ks + st * BK * LD;
    const float* Vt = Vs + st * BK * LD;

    // S = (q scale) K^T on the pair's 16 rows x the whole tile, over this
    // warp's half of the head dimension; the halves meet, each warp
    // keeping its KW keys
    float s[2 * NB][4];
#pragma unroll
    for (int n = 0; n < 2 * NB; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
    {
      const int d0 = half * HD / 2;
      const float* qp = Qs + (r_lo - q_lo) * LD + d0;
      const float* kp = Kt + d0;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const FragA qa = frag_a<LD>(qp + kk * 8, lane, scale);
#pragma unroll
        for (int n = 0; n < 2 * NB; ++n)
          mma3(s[n], qa, frag_b_rows<LD>(kp + 8 * n * LD + kk * 8, lane, 1.f));
      }
    }
    float sk[NB][4];
    pair_sum<NB>(xch, warp, lane, half, s, sk, 1 + warp / 2);

    // this warp's keys w_lo .. w_lo + KW - 1: skipped if none of its rows
    // sees one, masked only across the causal diagonal or the window's
    // lower edge
    const int w_lo = k_lo + half * KW;
    if ((causal && w_lo > r_hi) || (window && w_lo + KW - 1 <= r_lo - window)) continue;
    const bool edge = (causal && w_lo + KW - 1 > r_lo) || (window && w_lo <= r_hi - window);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (edge) {
          const int row = r_lo + g + 8 * (i >> 1);
          const int key = w_lo + 8 * n + 2 * t + (i & 1);
          bool ok = true;
          if (causal) ok = key <= row;
          if (window) ok = ok && key > row - window;
          if (!ok) sk[n][i] = NEG_INF;
        }
        mx[i >> 1] = fmaxf(mx[i >> 1], sk[n][i]);
      }
    // base 2: m is the running max of s * log2(e) (rounding is monotonic,
    // so the max of the products is the product of the max)
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * LOG2E);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sk[n][i] = exp2f(fmaf(sk[n][i], LOG2E, -m[i >> 1]));
        l[i >> 1] += sk[n][i];
      }
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] *= alpha[i >> 1];

    // O += P V: P's 8-key block kk as an A fragment, k relabelled (k = t
    // is the key 2t of the block, k = t + 4 the key 2t + 1)
    FragA pa[NB];
#pragma unroll
    for (int kk = 0; kk < NB; ++kk) {
      split_tf32(sk[kk][0], pa[kk].hi[0], pa[kk].lo[0]);
      split_tf32(sk[kk][2], pa[kk].hi[1], pa[kk].lo[1]);
      split_tf32(sk[kk][1], pa[kk].hi[2], pa[kk].lo[2]);
      split_tf32(sk[kk][3], pa[kk].hi[3], pa[kk].lo[3]);
    }
    const float* vp = Vt + half * KW * LD;
#pragma unroll
    for (int kk = 0; kk < NB; ++kk)
#pragma unroll
      for (int n = 0; n < ND; ++n)
        mma3(acc[n], pa[kk], frag_b_cols<LD>(vp + kk * 8 * LD + 8 * n, lane, 1.f));
  }
  tc::cp_async_wait<0>();
  __syncthreads();  // every warp is done with K and V: the exchange reuses them

  // the pair's two partial softmaxes merge: each warp sends the other the
  // O blocks the other writes (warp half h writes blocks h ND / 2 ..), then
  // its m and its lanes' l (the pair's lanes hold the same rows and
  // columns); blocks are chosen by selects, not by a runtime index
  constexpr int NH = ND / 2;
  float4* xo = reinterpret_cast<float4*>(Ks);
  float4* out = xo + warp * C::NX * 32 + lane;
  const float4* in = xo + (warp ^ 1) * C::NX * 32 + lane;
#pragma unroll
  for (int n = 0; n < NH; ++n) {
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = half ? acc[n][i] : acc[NH + n][i];
    out[n * 32] = make_float4(x[0], x[1], x[2], x[3]);
  }
  out[NH * 32] = make_float4(m[0], m[1], l[0], l[1]);
  bar_sync(1 + warp / 2, 64);
  const float4 pm = in[NH * 32];
  const float m_p[2] = {pm.x, pm.y}, l_p[2] = {pm.z, pm.w};
  float f[2], f_p[2], den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mm = fmaxf(m[r], m_p[r]);
    f[r] = exp2f(m[r] - mm);
    f_p[r] = exp2f(m_p[r] - mm);
    float lsum = l[r] * f[r] + l_p[r] * f_p[r];
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    lsum = lsum == 0.f ? 1.f : lsum;
    den[r] = lsum;
    const int row = r_lo + g + 8 * r;
    if (half == 0 && t == 0)  // a natural log, as the reference's
      lse[((long long)b * H + h) * Sq + row] = mm * LN2 + logf(lsum);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* orow = o + ((long long)b * Sq + r_lo + g + 8 * r) * qs + (long long)h * HD +
                  half * (HD / 2) + 2 * t;
#pragma unroll
    for (int n = 0; n < NH; ++n) {
      const float4 pv = in[n * 32];
      const float p0 = r ? pv.z : pv.x, p1 = r ? pv.w : pv.y;
      const float a0 = half ? acc[NH + n][2 * r] : acc[n][2 * r];
      const float a1 = half ? acc[NH + n][2 * r + 1] : acc[n][2 * r + 1];
      *reinterpret_cast<float2*>(orow + 8 * n) =
          make_float2((a0 * f[r] + p0 * f_p[r]) / den[r], (a1 * f[r] + p1 * f_p[r]) / den[r]);
    }
  }
}

template <int HD>
int launch_tf32x3(const void* q, const void* k, const void* v, void* o, void* lse,
                  int B, int Sq, int Skv, int H, int KV, int causal, int window,
                  float scale, cudaStream_t s) {
  using C = F32Fwd<HD>;
  if (Sq % C::BQ || Skv % C::BK) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_fwd_tf32x3_kernel<HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H * B, Sq / C::BQ);
  kern<<<grid, F_THREADS, C::SMEM, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), static_cast<float*>(lse),
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
    case 64: return launch_tf32x3<64>(SPOT_FWD_ARGS);
    case 96: return launch_tf32x3<96>(SPOT_FWD_ARGS);
    case 128: return launch_tf32x3<128>(SPOT_FWD_ARGS);
    case 256: return launch_tf32x3<256>(SPOT_FWD_ARGS);
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
  if (Sq % BLOCK || Skv % BLOCK || KV <= 0 || H % KV) return static_cast<int>(cudaErrorInvalidValue);
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

// dynamic shared memory of the float32 (3xTF32) forward at head dim hd
extern "C" int spot_flash_attention_fwd_tf32x3_smem(int hd) {
  switch (hd) {
    case 64: return F32Fwd<64>::SMEM;
    case 96: return F32Fwd<96>::SMEM;
    case 128: return F32Fwd<128>::SMEM;
    case 256: return F32Fwd<256>::SMEM;
    default: return -1;
  }
}
