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
// seven): bf16 through wgmma, float32 as three TF32 products per product.
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
// dq in bfloat16: flash_dq_wgmma_kernel, the dkv kernel's layout mirrored.
// One CTA of two warpgroups per (64-row q tile, query head, batch) walks
// the key tiles of 64 that the q tile can see (causal frontier and window;
// causal q tiles longest first), K and V double-buffered by cp.async, Q,
// dO, lse and D loaded once. Each warpgroup computes the whole S = Q K^T
// and dP = dO V^T (SS wgmma over the real head dimension: 6 K steps at
// hd 96), then P = exp(S * scale - lse) under the mask (evaluated only on
// a tile across the causal diagonal or the window's lower edge) and
// dS = P (dP - D) on the fragment, then dQ += dS K into its half of dQ's
// columns (RS wgmma, K read transposed; at hd 64 the CTA is one warpgroup
// that owns all 64 columns, so no tensor work lands past HD). dS goes in as a
// bf16 hi + lo pair: rounded once it misses dq's bf16 tolerance by 3.4 to
// 5.9x in the CPU emulation (tests/test_torch_flash_numerics.py), so the
// quarter of the tensor work one product would save is not taken. dQ is
// multiplied by the scale once, in float32, and written in bf16. Why this
// layout rather than the forward's (128 q rows, each warpgroup owning all
// of dQ for 64 of them): at hd 256 that needs dQ (128 floats a thread), S
// and dP (32 each) live at once, and split by columns dQ is 64 registers;
// it also gives 256 CTAs at gemma3's training shape, not 128 on 132 SMs.
// The price: S and dP are computed twice, 12 units of tensor work per
// pair and head dimension against 8 for one warpgroup per row block.
// Shared memory at hd 256: Q, dO 64 KB + K, V in two stages 128 KB.
//
// dkv and dq in float32: flash_dkv_tf32x3_kernel and flash_dq_tf32x3_kernel,
// on the tensor cores in 3xTF32 (mma.sync m16n8k8 tf32 with float32 sums).
// Every operand value x of the five products (S, dP, and dV, dK or dQ) is
// split into hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi), and
// a b ~ hi_a lo_b + lo_a hi_b + hi_a hi_b, the two small products issued
// first, into one float32 accumulator: about float32's error (the CPU
// emulation in tests/test_torch_flash_numerics.py errs 0.85-1.67x as much
// as the plain float32 version against float64), where one TF32 rounding
// misses the gradient tolerance by 1.5-4.7x. Why mma.sync and not wgmma: tf32 wgmma
// reads shared-memory operands only K-major and 3xTF32 needs both halves
// of every operand, so dkv would need hi and lo copies of K and V and
// transposed ones of Q and dO, far past 227 KB at hd 256 in float32;
// mma.sync takes its fragments from registers, so each float32 tile is
// kept once in shared memory, split as a fragment is loaded, and a
// transposed operand is another load pattern. q is scaled (q * scale,
// float32) as its fragments are loaded, before the split, as the plain
// version widens and then scales it.
//
// The fragments, the split and the three products are tf32x3.cuh's. P^T
// and dS^T (and dS) go from the accumulator layout to the A layout of the
// next product by relabelling k, and the B operand (dO, Q or K, read down
// its rows) follows the same labels. Each warp writes its accumulator
// columns of P^T and dS^T (or dS) to shared memory as float2 pairs, and
// after a barrier of the warps that share its rows reads the whole row
// block back as float2 pairs, no shuffles.
//
//  * dkv: one CTA of 8 warps per (BK-key tile, query head, batch) walks the
//    32-row q tiles that can see it. K and V stay in shared memory; Q, dO,
//    lse and D stream through a two-stage cp.async ring (16 bytes a
//    thread; the next tile's copies are issued right after the one block
//    barrier of each tile, so they overlap the tile's products). For S^T
//    and dP^T, warp w owns 16 key rows (w / NWD); warps w and w ^ 1
//    compute their 2 QW q columns together, each over half the head
//    dimension (a K or V fragment, split once, feeds twice the products),
//    and add the halves through shared memory, each keeping its QW columns
//    (w % NWD). For dV and dK, warp w owns 32 key rows (two groups, whose
//    warps meet at a barrier) and DW columns of the head dimension, so
//    each split dO or Q fragment feeds two 16-row products. BK 32 at
//    hd 256 (NWD 4: QW 8, DW 32), else 64 (NWD 2: QW 16, DW = hd / 4).
//  * dq: one CTA of 8 warps per (BQ-row q tile, query head, batch) walks
//    the 32-key tiles the q tile can see; Q and dO stay, K and V stream
//    through the ring. S and dP are computed as in dkv: warp w owns 16 q
//    rows, pairs split the head dimension, each warp keeps KW keys; then
//    dQ += dS K with warp w owning 32 q rows and DW columns; dQ is
//    multiplied by the scale once. BQ 32 at hd 256 (NWD 4: KW 8, DW 32),
//    else 64 (NWD 2: KW 16, DW = hd / 4).
// The loops over the head dimension are unrolled in full (faster than by
// four at hd 256; PERF.md section 6).
// Both grids put the tiles in the slow dimension, with a causal mask the
// heaviest first (dkv: the first key tiles; dq: the last q tiles), so
// every head's heavy tiles start in the first wave.
// Shared-memory rows are padded to hd + 4 floats and P/dS rows to the tile
// width + 8, so every fragment load and store is free of bank conflicts:
// scalar loads of (g, t) at rows hd + 4 apart hit bank 4g + t, of (2t, g)
// bank 8t + g, and float2 pairs of (g, 2t) at rows width + 8 apart cover
// the 32 banks once per half-warp. Shared memory: dkv 218,624 B at hd 256,
// dq 212,992 B (one CTA per SM); the other head dims are smaller
// (spot_flash_attention_{dkv,dq}_tf32x3_smem).
//
// Shapes: q, do (B, Sq, H, hd); k, v (B, Skv, KV, hd); lse, dsum (B, H, Sq)
// float32; dk, dv out (B, Skv, H, hd) float32; dq out like q. Sq and Skv
// are multiples of 64 (the wrapper pads), hd is 64, 96, 128 or 256,
// H % KV == 0.
#include "common.cuh"
#include "tf32x3.cuh"
#include "wgmma.cuh"

#include <type_traits>

namespace {

namespace tc = spot::tc;
using namespace spot::tf32;

// ---------------------------------------------------------------------------
// dkv and dq in float32 on the tensor cores, 3xTF32 (tf32x3.cuh)
// ---------------------------------------------------------------------------

template <int HD>
struct F32Dkv {
  static constexpr int BK = HD > 128 ? 32 : 64;    // keys per CTA
  static constexpr int BQ = 32;                    // q rows per tile
  static constexpr int NWK = BK / 16;              // 16-key groups
  static constexpr int NWD = F_WARPS / NWK;        // warps per 16-key group
  static constexpr int QW = BQ / NWD;              // S^T columns per warp
  static constexpr int DW = HD / (2 * NWD);        // dK, dV columns per warp
  static constexpr int LD = HD + 4;                // tile row stride
  static constexpr int LDP = BQ + 8;               // P^T, dS^T row stride
  // K, V; Q and dO in two stages; P^T, dS^T; lse and D in two stages;
  // the pair sums' outboxes (QW columns of S^T and of dP^T, 16 rows a warp)
  static constexpr int SMEM =
      4 * (2 * BK * LD + 2 * 2 * BQ * LD + 2 * BK * LDP + 2 * 2 * BQ + F_THREADS * QW);
};

template <int HD>
struct F32Dq {
  static constexpr int BQ = HD > 128 ? 32 : 64;    // q rows per CTA
  static constexpr int BK = 32;                    // keys per tile
  static constexpr int NWQ = BQ / 16;              // 16-row groups
  static constexpr int NWD = F_WARPS / NWQ;        // warps per 16-row group
  static constexpr int KW = BK / NWD;              // S, dP columns per warp
  static constexpr int DW = HD / (2 * NWD);        // dQ columns per warp
  static constexpr int LD = HD + 4;
  static constexpr int LDS = BK + 8;               // dS row stride
  // Q, dO; K and V in two stages; dS; the pair sums' outboxes
  static constexpr int SMEM =
      4 * (2 * BQ * LD + 2 * 2 * BK * LD + BQ * LDS + F_THREADS * KW);
};

template <int HD>
__global__ void __launch_bounds__(F_THREADS, 1)
flash_dkv_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ dsum,
                        float* __restrict__ dk, float* __restrict__ dv, int Sq,
                        int Skv, int H, int KV, int causal, int window, float scale) {
  using C = F32Dkv<HD>;
  constexpr int BK = C::BK, BQ = C::BQ, LD = C::LD, LDP = C::LDP;
  constexpr int NB = C::QW / 8, ND = C::DW / 8;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                  // BK x LD
  float* Vs = Ks + BK * LD;          // BK x LD
  float* Qs = Vs + BK * LD;          // two stages of BQ x LD
  float* dOs = Qs + 2 * BQ * LD;     // two stages of BQ x LD
  float* Ps = dOs + 2 * BQ * LD;     // BK x LDP
  float* dSs = Ps + BK * LDP;        // BK x LDP
  float* stat = dSs + BK * LDP;      // stage st: lse at 2 BQ st, D after it
  float4* xch = reinterpret_cast<float4*>(stat + 2 * 2 * BQ);  // pair sums

  // key tiles in the slow grid dimension: with a causal mask the first
  // ones see the most q tiles, and every head's first ones launch first
  const int kt = blockIdx.y, h = blockIdx.x % H, b = blockIdx.x / H;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kr = (warp / C::NWD) * 16;       // this warp's 16 keys of S^T
  const int qc = (warp % C::NWD) * C::QW;    // its S^T columns
  const int half = warp & 1;                 // its half of S^T's head dim
  const int pc = qc - half * C::QW;          // the pair's S^T columns
  const int kb = (warp / (2 * C::NWD)) * 32;     // its 32 keys of dK, dV
  const int dc = (warp % (2 * C::NWD)) * C::DW;  // and their columns
  const int k_lo = kt * BK, k_hi = k_lo + BK - 1;
  const long long qs = (long long)H * HD, kvs = (long long)KV * HD;

  // the q tiles with a row that sees some key of this tile: [qt0, qt1)
  const int nqt = Sq / BQ;
  const int qt0 = causal ? k_lo / BQ : 0;
  const int qt1 = window ? min(nqt, (k_hi + window - 1) / BQ + 1) : nqt;

  const long long kv_off = ((long long)b * Skv + k_lo) * kvs + (long long)kvh * HD;
  load_rows<BK, HD, LD>(Ks, k + kv_off, kvs, tid);
  load_rows<BK, HD, LD>(Vs, v + kv_off, kvs, tid);
  auto load_q = [&](int qt, int st) {
    const long long off = ((long long)b * Sq + qt * BQ) * qs + (long long)h * HD;
    load_rows<BQ, HD, LD>(Qs + st * BQ * LD, q + off, qs, tid);
    load_rows<BQ, HD, LD>(dOs + st * BQ * LD, dout + off, qs, tid);
    if (tid < BQ / 2) {  // BQ lse and BQ D values, 16 bytes a thread
      const int c = (tid % (BQ / 4)) * 4, which = tid / (BQ / 4);
      const long long row = ((long long)b * H + h) * Sq + qt * BQ + c;
      tc::cp_async16(tc::smem_u32(stat + st * 2 * BQ + which * BQ + c),
                     (which ? dsum : lse) + row, true);
    }
  };
  if (qt0 < qt1) load_q(qt0, 0);
  tc::cp_async_commit();

  float dka[2][ND][4], dva[2][ND][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) dka[m][n][i] = dva[m][n][i] = 0.f;

  for (int qt = qt0; qt < qt1; ++qt) {
    const int st = (qt - qt0) & 1;
    tc::cp_async_wait<0>();
    __syncthreads();  // tile qt has landed; every warp is done with qt - 1
    if (qt + 1 < qt1) load_q(qt + 1, st ^ 1);
    tc::cp_async_commit();
    const float* Qt = Qs + st * BQ * LD;
    const float* dOt = dOs + st * BQ * LD;
    const float* lse_s = stat + st * 2 * BQ;
    const float* dsum_s = lse_s + BQ;

    // S^T = K (q scale)^T and dP^T = V dO^T on 16 keys x the pair's 2 QW
    // q columns, over this warp's half of the head dimension; the halves
    // meet through shared memory, each warp keeping its QW columns
    float s[2 * NB][4], dp[2 * NB][4];
#pragma unroll
    for (int n = 0; n < 2 * NB; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
    {
      const int d0 = half * HD / 2;
      const float* kp = Ks + kr * LD + d0;
      const float* vp = Vs + kr * LD + d0;
      const float* qp = Qt + pc * LD + d0;
      const float* op = dOt + pc * LD + d0;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const FragA ka = frag_a<LD>(kp + kk * 8, lane, 1.f);
        const FragA va = frag_a<LD>(vp + kk * 8, lane, 1.f);
#pragma unroll
        for (int n = 0; n < 2 * NB; ++n) {
          const int o = 8 * n * LD + kk * 8;
          mma3(s[n], ka, frag_b_rows<LD>(qp + o, lane, scale));
          mma3(dp[n], va, frag_b_rows<LD>(op + o, lane, 1.f));
        }
      }
    }
    float sk[NB][4], dpk[NB][4];  // this warp's QW columns, both halves summed
    pair_sum<NB>(xch, warp, lane, half, s, dp, sk, dpk, 1 + C::NWK + warp / 2);

    // P^T and dS^T: key rows kr + g (+ 8), q columns qc + 8n + 2t (+ 1)
    const int q_lo = qt * BQ;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k_lo + kr + g + 8 * (i >> 1);
        const int c = qc + 8 * n + 2 * t + (i & 1), qpos = q_lo + c;
        bool ok = true;
        if (causal) ok = key <= qpos;
        if (window) ok = ok && key > qpos - window;
        const float p = ok ? expf(sk[n][i] - lse_s[c]) : 0.f;
        sk[n][i] = p;
        dpk[n][i] = p * (dpk[n][i] - dsum_s[c]);
      }
      store_pairs<LDP>(Ps + kr * LDP + qc + 8 * n, lane, sk[n]);
      store_pairs<LDP>(dSs + kr * LDP + qc + 8 * n, lane, dpk[n]);
    }
    // the columns of the 32 keys' two groups are in
    bar_sync(1 + warp / (2 * C::NWD), 2 * C::NWD * 32);

    // dV += P^T dO and dK += dS^T (q scale): 32 keys x this warp's DW
    // columns, each B fragment split once for both 16-key halves
#pragma unroll
    for (int kk = 0; kk < BQ / 8; ++kk) {
      FragA pa[2], da[2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        pa[m] = frag_a_pairs<LDP>(Ps + (kb + 16 * m) * LDP + kk * 8, lane);
        da[m] = frag_a_pairs<LDP>(dSs + (kb + 16 * m) * LDP + kk * 8, lane);
      }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int o = kk * 8 * LD + dc + 8 * n;
        const FragB bo = frag_b_cols<LD>(dOt + o, lane, 1.f);
        const FragB bq = frag_b_cols<LD>(Qt + o, lane, scale);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma3(dva[m][n], pa[m], bo);
          mma3(dka[m][n], da[m], bq);
        }
      }
    }
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k_lo + kb + 16 * m + g + 8 * r;
      const long long o = (((long long)b * Skv + key) * H + h) * HD + dc + 2 * t;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        *reinterpret_cast<float2*>(dk + o + 8 * n) =
            make_float2(dka[m][n][2 * r], dka[m][n][2 * r + 1]);
        *reinterpret_cast<float2*>(dv + o + 8 * n) =
            make_float2(dva[m][n][2 * r], dva[m][n][2 * r + 1]);
      }
    }
}

template <int HD>
__global__ void __launch_bounds__(F_THREADS, 1)
flash_dq_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ dsum,
                       float* __restrict__ dq, int Sq, int Skv, int H, int KV,
                       int causal, int window, float scale) {
  using C = F32Dq<HD>;
  constexpr int BK = C::BK, BQ = C::BQ, LD = C::LD, LDS = C::LDS;
  constexpr int NB = C::KW / 8, ND = C::DW / 8;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                  // BQ x LD
  float* dOs = Qs + BQ * LD;         // BQ x LD
  float* Ks = dOs + BQ * LD;         // two stages of BK x LD
  float* Vs = Ks + 2 * BK * LD;      // two stages of BK x LD
  float* dSs = Vs + 2 * BK * LD;     // BQ x LDS
  float4* xch = reinterpret_cast<float4*>(dSs + BQ * LDS);  // pair sums

  // q tiles in the slow grid dimension, causal ones with the most visible
  // keys first, for every head
  const int nqt = Sq / BQ;
  const int qt = causal ? nqt - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int h = blockIdx.x % H, b = blockIdx.x / H, kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qr = (warp / C::NWD) * 16;       // this warp's 16 q rows of S
  const int kc = (warp % C::NWD) * C::KW;    // its S, dP columns
  const int half = warp & 1;                 // its half of S's head dim
  const int pc = kc - half * C::KW;          // the pair's S columns
  const int rb = (warp / (2 * C::NWD)) * 32;     // its 32 q rows of dQ
  const int dc = (warp % (2 * C::NWD)) * C::DW;  // and their columns
  const int q_lo = qt * BQ, q_hi = q_lo + BQ - 1;
  const long long qs = (long long)H * HD, kvs = (long long)KV * HD;

  // the key tiles some row of this q tile can see: [kt0, kt1)
  const int nkt = Skv / BK;
  const int kt1 = causal ? min(nkt, q_hi / BK + 1) : nkt;
  const int kt0 = window ? max(0, q_lo - window + 1) / BK : 0;

  const long long q_off = ((long long)b * Sq + q_lo) * qs + (long long)h * HD;
  load_rows<BQ, HD, LD>(Qs, q + q_off, qs, tid);
  load_rows<BQ, HD, LD>(dOs, dout + q_off, qs, tid);
  const float* kb = k + (long long)b * Skv * kvs + (long long)kvh * HD;
  const float* vb = v + (long long)b * Skv * kvs + (long long)kvh * HD;
  auto load_kv = [&](int kt, int st) {
    const long long off = (long long)kt * BK * kvs;
    load_rows<BK, HD, LD>(Ks + st * BK * LD, kb + off, kvs, tid);
    load_rows<BK, HD, LD>(Vs + st * BK * LD, vb + off, kvs, tid);
  };
  if (kt0 < kt1) load_kv(kt0, 0);
  tc::cp_async_commit();

  // this thread's rows: q_lo + qr + g (r = 0) and + 8 (r = 1)
  const long long srow = ((long long)b * H + h) * Sq + q_lo + qr + g;
  const float lse_r[2] = {lse[srow], lse[srow + 8]};
  const float ds_r[2] = {dsum[srow], dsum[srow + 8]};

  float dqa[2][ND][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) dqa[m][n][i] = 0.f;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int st = (kt - kt0) & 1;
    tc::cp_async_wait<0>();
    __syncthreads();  // tile kt has landed; every warp is done with kt - 1
    if (kt + 1 < kt1) load_kv(kt + 1, st ^ 1);
    tc::cp_async_commit();
    const float* Kt = Ks + st * BK * LD;
    const float* Vt = Vs + st * BK * LD;

    // S = (q scale) K^T and dP = dO V^T on 16 q rows x the pair's 2 KW
    // keys, over this warp's half of the head dimension, as in dkv
    float s[2 * NB][4], dp[2 * NB][4];
#pragma unroll
    for (int n = 0; n < 2 * NB; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
    {
      const int d0 = half * HD / 2;
      const float* qp = Qs + qr * LD + d0;
      const float* op = dOs + qr * LD + d0;
      const float* kp = Kt + pc * LD + d0;
      const float* vp = Vt + pc * LD + d0;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const FragA qa = frag_a<LD>(qp + kk * 8, lane, scale);
        const FragA oa = frag_a<LD>(op + kk * 8, lane, 1.f);
#pragma unroll
        for (int n = 0; n < 2 * NB; ++n) {
          const int o = 8 * n * LD + kk * 8;
          mma3(s[n], qa, frag_b_rows<LD>(kp + o, lane, 1.f));
          mma3(dp[n], oa, frag_b_rows<LD>(vp + o, lane, 1.f));
        }
      }
    }
    float sk[NB][4], dpk[NB][4];  // this warp's KW columns, both halves summed
    pair_sum<NB>(xch, warp, lane, half, s, dp, sk, dpk, 1 + C::NWQ + warp / 2);

    // dS = P (dP - D): q rows qr + g (+ 8), key columns kc + 8n + 2t (+ 1)
    const int k_lo = kt * BK;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1, row = q_lo + qr + g + 8 * r;
        const int key = k_lo + kc + 8 * n + 2 * t + (i & 1);
        bool ok = true;
        if (causal) ok = key <= row;
        if (window) ok = ok && key > row - window;
        const float p = ok ? expf(sk[n][i] - lse_r[r]) : 0.f;
        dpk[n][i] = p * (dpk[n][i] - ds_r[r]);
      }
      store_pairs<LDS>(dSs + qr * LDS + kc + 8 * n, lane, dpk[n]);
    }
    // the columns of the 32 rows' two groups are in
    bar_sync(1 + warp / (2 * C::NWD), 2 * C::NWD * 32);

    // dQ += dS K: 32 q rows x this warp's DW columns
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      FragA da[2];
#pragma unroll
      for (int m = 0; m < 2; ++m)
        da[m] = frag_a_pairs<LDS>(dSs + (rb + 16 * m) * LDS + kk * 8, lane);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const FragB bk = frag_b_cols<LD>(Kt + kk * 8 * LD + dc + 8 * n, lane, 1.f);
#pragma unroll
        for (int m = 0; m < 2; ++m) mma3(dqa[m][n], da[m], bk);
      }
    }
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float* orow = dq + ((long long)b * Sq + q_lo + rb + 16 * m + g + 8 * r) * qs +
                    (long long)h * HD + dc + 2 * t;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<float2*>(orow + 8 * n) =
            make_float2(dqa[m][n][2 * r] * scale, dqa[m][n][2 * r + 1] * scale);
    }
}

// ---------------------------------------------------------------------------
// dkv in bfloat16 on the tensor cores
// ---------------------------------------------------------------------------

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
    __syncthreads();  // every warpgroup is done with this stage
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

// ---------------------------------------------------------------------------
// dq in bfloat16 on the tensor cores
// ---------------------------------------------------------------------------

template <int HD>
struct TcDq {
  static constexpr int NWG = HD <= 64 ? 1 : 2;         // warpgroups per CTA
  static constexpr int THREADS = NWG * 128;
  static constexpr int HDP = HD <= 64 ? 64 : (HD <= 128 ? 128 : 256);  // padded
  static constexpr int NBW = HDP / (64 * NWG);  // 64-column blocks of dQ per warpgroup
  static constexpr int KSTEPS = HD / 16;  // K steps of S and dP: no padded ones
  static constexpr int TILE = TC_B * HDP * 2;          // bytes
  // Q, dO; K and V in two stages; alignment
  static constexpr int SMEM = 6 * TILE + 1024;
};

template <int HD>
__global__ void __launch_bounds__(TcDq<HD>::THREADS, 1)
flash_dq_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ dsum,
                      bf16* __restrict__ dq, int Sq, int Skv, int H, int KV,
                      int causal, int window, float scale) {
  using C = TcDq<HD>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (tc::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sdO = base + C::TILE;
  const uint32_t sK = base + 2 * C::TILE, sV = base + 4 * C::TILE;  // + st * TILE

  // causal: the q tiles with the most visible keys launch first
  const int nqt = Sq / TC_B;
  const int qt = causal ? nqt - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KV);
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = t & 31;
  const int q_lo = qt * TC_B, q_hi = q_lo + TC_B - 1;
  const long long qs = (long long)H * HD, kvs = (long long)KV * HD;

  // the key tiles some row of this q tile can see: [kt0, kt1)
  const int nkt = Skv / TC_B;
  const int kt1 = causal ? min(nkt, q_hi / TC_B + 1) : nkt;
  const int kt0 = window ? max(0, q_lo - window + 1) / TC_B : 0;

  const long long q_off = ((long long)b * Sq + q_lo) * qs + (long long)h * HD;
  tc::load_tile<TC_B, C::HDP, C::THREADS>(sQ, q + q_off, qs, TC_B, HD, tid);
  tc::load_tile<TC_B, C::HDP, C::THREADS>(sdO, dout + q_off, qs, TC_B, HD, tid);
  const bf16* kb = k + (long long)b * Skv * kvs + (long long)kvh * HD;
  const bf16* vb = v + (long long)b * Skv * kvs + (long long)kvh * HD;
  auto load_kv = [&](int kt, int st) {
    const long long off = (long long)kt * TC_B * kvs;
    tc::load_tile<TC_B, C::HDP, C::THREADS>(sK + st * C::TILE, kb + off, kvs, TC_B, HD,
                                            tid);
    tc::load_tile<TC_B, C::HDP, C::THREADS>(sV + st * C::TILE, vb + off, kvs, TC_B, HD,
                                            tid);
  };
  if (kt0 < kt1) load_kv(kt0, 0);
  tc::cp_async_commit();

  // this thread's rows: row0 (r = 0) and row0 + 8 (r = 1)
  const int row0 = q_lo + warp * 16 + (lane >> 2);
  const long long srow = ((long long)b * H + h) * Sq + row0;
  const float lse_r[2] = {lse[srow], lse[srow + 8]};
  const float ds_r[2] = {dsum[srow], dsum[srow + 8]};

  float dqa[C::NBW][32];
#pragma unroll
  for (int n = 0; n < C::NBW; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[n][i] = 0.f;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int st = (kt - kt0) & 1;
    if (kt + 1 < kt1) load_kv(kt + 1, st ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    tc::fence_async_smem();
    __syncthreads();

    // S = Q K^T and dP = dO V^T over the real head dimension
    const uint32_t k_t = sK + st * C::TILE, v_t = sV + st * C::TILE;
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    tc::fence();
#pragma unroll
    for (int kk = 0; kk < C::KSTEPS; ++kk)
      tc::mma_ss(s, tc::desc_k<TC_B>(sQ, kk), tc::desc_k<TC_B>(k_t, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < C::KSTEPS; ++kk)
      tc::mma_ss(dp, tc::desc_k<TC_B>(sdO, kk), tc::desc_k<TC_B>(v_t, kk), kk > 0);
    tc::commit();
    tc::wait<0>();
    tc::fence_regs(s);
    tc::fence_regs(dp);

    // P and dS on the fragment: q rows row0 (+ 8), key columns. The mask
    // is evaluated only on a tile that straddles the causal diagonal or
    // the window's lower edge; every pair of any other visible tile is
    // visible.
    const int k_lo = kt * TC_B;
    const bool edge = (causal && k_lo + TC_B - 1 > q_lo) ||
                      (window && k_lo <= q_hi - window);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      bool ok = true;
      if (edge) {
        const int row = row0 + 8 * r;
        const int key = k_lo + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        if (causal) ok = key <= row;
        if (window) ok = ok && key > row - window;
      }
      const float p = ok ? expf(s[i] * scale - lse_r[r]) : 0.f;
      dp[i] = p * (dp[i] - ds_r[r]);
    }
    uint32_t dh[4][4], dl[4][4];
    tc::split_frag(dp, dh, dl);

    // dQ += dS K on this warpgroup's columns (K read transposed)
    tc::fence();
#pragma unroll
    for (int kk = 0; kk < TC_B / 16; ++kk)
#pragma unroll
      for (int n = 0; n < C::NBW; ++n) {
        const uint64_t d_k = tc::desc_mn<TC_B>(k_t, kk, wg * C::NBW + n);
        tc::mma_rs(dqa[n], dh[kk], d_k);
        tc::mma_rs(dqa[n], dl[kk], d_k);
      }
    tc::commit();
    tc::wait<0>();
#pragma unroll
    for (int n = 0; n < C::NBW; ++n) tc::fence_regs(dqa[n]);
    __syncthreads();  // every warpgroup is done with this stage
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bf16* orow = dq + ((long long)b * Sq + row0 + 8 * r) * qs + (long long)h * HD;
#pragma unroll
    for (int n = 0; n < C::NBW; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = (wg * C::NBW + n) * 64 + 8 * j + 2 * (lane & 3);
        if (col < HD) {
          const int i = 4 * j + 2 * r;
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(dqa[n][i] * scale, dqa[n][i + 1] * scale);
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

template <int HD>
int launch_dkv_tf32x3(const Args& a, cudaStream_t s) {
  using C = F32Dkv<HD>;
  if (a.Sq % C::BQ || a.Skv % C::BK) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_dkv_tf32x3_kernel<HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.H * a.B, a.Skv / C::BK);
  kern<<<grid, F_THREADS, C::SMEM, s>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.dsum),
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.Sq, a.Skv, a.H, a.KV,
      a.causal, a.window, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dq_tf32x3(const Args& a, cudaStream_t s) {
  using C = F32Dq<HD>;
  if (a.Sq % C::BQ || a.Skv % C::BK) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_dq_tf32x3_kernel<HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.H * a.B, a.Sq / C::BQ);
  kern<<<grid, F_THREADS, C::SMEM, s>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.dsum),
      static_cast<float*>(a.dq), a.Sq, a.Skv, a.H, a.KV, a.causal, a.window, a.scale);
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

template <int HD>
int launch_dq_wgmma(const Args& a, cudaStream_t s) {
  constexpr int smem = TcDq<HD>::SMEM;
  if (a.Sq % TC_B || a.Skv % TC_B) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_dq_wgmma_kernel<HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.Sq / TC_B, a.H, a.B);
  kern<<<grid, TcDq<HD>::THREADS, smem, s>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.dsum),
      static_cast<bf16*>(a.dq), a.Sq, a.Skv, a.H, a.KV, a.causal, a.window, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// both passes route by dtype alone: bfloat16 on wgmma, float32 on mma.sync
// in 3xTF32
template <typename T, int HD, bool DKV>
int launch(const Args& a, cudaStream_t s) {
  if constexpr (std::is_same_v<T, bf16>) {
    if constexpr (DKV) return launch_dkv_wgmma<HD>(a, s);
    else return launch_dq_wgmma<HD>(a, s);
  } else {
    if constexpr (DKV) return launch_dkv_tf32x3<HD>(a, s);
    else return launch_dq_tf32x3<HD>(a, s);
  }
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

// dynamic shared memory of the bf16 tensor-core dq pass at head dim hd
extern "C" int spot_flash_attention_dq_wgmma_smem(int hd) {
  switch (hd) {
    case 64: return TcDq<64>::SMEM;
    case 96: return TcDq<96>::SMEM;
    case 128: return TcDq<128>::SMEM;
    case 256: return TcDq<256>::SMEM;
    default: return -1;
  }
}

// dynamic shared memory of the float32 (3xTF32) dkv and dq passes at head dim hd
extern "C" int spot_flash_attention_dkv_tf32x3_smem(int hd) {
  switch (hd) {
    case 64: return F32Dkv<64>::SMEM;
    case 96: return F32Dkv<96>::SMEM;
    case 128: return F32Dkv<128>::SMEM;
    case 256: return F32Dkv<256>::SMEM;
    default: return -1;
  }
}

extern "C" int spot_flash_attention_dq_tf32x3_smem(int hd) {
  switch (hd) {
    case 64: return F32Dq<64>::SMEM;
    case 96: return F32Dq<96>::SMEM;
    case 128: return F32Dq<128>::SMEM;
    case 256: return F32Dq<256>::SMEM;
    default: return -1;
  }
}
