// Selective scan (Mamba-1): the recurrence
//     h_t = exp(dt_t * A) * h_{t-1} + dt_t * u_t * B_t,   h_{-1} = 0
//     y_t = C_t . h_t + D * u_t
// per (batch row, channel), with N states per channel.
//
// Replaces src/repro/kernels/ssm_scan/ssm_scan.py (_ssm_kernel, via
// ssm_scan) -> spot_ssm_scan.
//
// What bounds it on an H100: the exponentials. Each (step, channel, state)
// needs exp(dt * A): N of them per step and channel against 3 values of
// u, dt and y moved, so the floor is the B * S * DI * N exponentials over
// the special-function units (16 per SM per clock), above the bytes' floor
// of u, dt and y over the memory rate.
//
// Design: the reference's log-depth associative scan inside a chunk is a
// TPU choice (its vector unit wants the channel dimension). Here the
// recurrence is sequential in t and independent per (batch row, channel),
// so each thread owns one channel of one batch row and walks the sequence
// with its N = 16 states in float32 registers; neighbouring threads own
// neighbouring channels, so every load of u and dt and every store of y by
// a warp is one contiguous span. B_t and C_t, which all channels of a batch
// row share, are staged a chunk of steps at a time in shared memory and
// read there as broadcasts. The state update is a multiply, a multiply and
// an add, each rounded on its own (no contraction into an fma), as the
// plain sequential version computes it; y's sum over the N states runs in
// another order than the plain version's, so the two agree within float32
// rounding. A TPU grid carried the state between chunks in scratch; here
// the loop inside the thread takes that place. The exponentials do not
// depend on h, so they pipeline; only one rounded multiply-add per state
// lies on the dependence chain of a step.
//
// Shapes: u, dt (B, S, DI) float32 or bfloat16; A (DI, N), B, C (B, S, N),
// D (DI,) float32; y (B, S, DI) in u's type, h_last (B, DI, N) float32.
// Built for N = 16 (falcon-mamba's d_state).
#include "common.cuh"

namespace {

constexpr int THREADS = 64;   // channels per block
constexpr int CHUNK = 64;     // steps of B_t and C_t staged at a time

template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
ssm_kernel(const T* __restrict__ u, const T* __restrict__ dt,
           const float* __restrict__ A, const float* __restrict__ Bm,
           const float* __restrict__ Cm, const float* __restrict__ Dv,
           T* __restrict__ y, float* __restrict__ h_last, int S, int DI) {
  __shared__ float Bs[CHUNK * N];
  __shared__ float Cs[CHUNK * N];
  const int ch = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  const bool active = ch < DI;
  float a[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = active ? A[(long long)ch * N + n] : 0.f;
    h[n] = 0.f;
  }
  const float dd = active ? Dv[ch] : 0.f;
  const long long base = (long long)b * S * DI + ch;
  const float* Bb = Bm + (long long)b * S * N;
  const float* Cb = Cm + (long long)b * S * N;

  for (int t0 = 0; t0 < S; t0 += CHUNK) {
    const int len = min(CHUNK, S - t0);
    __syncthreads();  // the previous chunk's readers are done
    for (int i = threadIdx.x; i < len * N; i += THREADS) {
      Bs[i] = Bb[(long long)t0 * N + i];
      Cs[i] = Cb[(long long)t0 * N + i];
    }
    __syncthreads();
    if (!active) continue;
#pragma unroll 4
    for (int t = 0; t < len; ++t) {
      const long long off = base + (long long)(t0 + t) * DI;
      const float uu = spot::to_f32<T>(u[off]);
      const float d = spot::to_f32<T>(dt[off]);
      const float du = __fmul_rn(d, uu);
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float dA = expf(__fmul_rn(d, a[n]));
        h[n] = __fadd_rn(__fmul_rn(dA, h[n]), __fmul_rn(du, Bs[t * N + n]));
        acc = fmaf(h[n], Cs[t * N + n], acc);
      }
      y[off] = spot::from_f32<T>(__fadd_rn(acc, __fmul_rn(uu, dd)));
    }
  }
  if (active) {
#pragma unroll
    for (int n = 0; n < N; ++n) h_last[((long long)b * DI + ch) * N + n] = h[n];
  }
}

template <typename T>
int launch(const void* u, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* Dv, void* y, void* h_last, int B,
           int S, int DI, int N, cudaStream_t s) {
  if (N != 16) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((DI + THREADS - 1) / THREADS, B);
  ssm_kernel<T, 16><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(Dv),
      static_cast<T*>(y), static_cast<float*>(h_last), S, DI);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int spot_ssm_scan(const void* u, const void* dt, const void* A,
                             const void* Bm, const void* Cm, const void* Dv,
                             void* y, void* h_last, int B, int S, int DI,
                             int N, int dtype_code, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case spot::kF32:
      return launch<float>(u, dt, A, Bm, Cm, Dv, y, h_last, B, S, DI, N, s);
    case spot::kBF16:
      return launch<__nv_bfloat16>(u, dt, A, Bm, Cm, Dv, y, h_last, B, S, DI, N, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
