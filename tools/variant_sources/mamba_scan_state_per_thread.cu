// K6: the selective (S6) scan of the mamba mixer, from a state in to a
// state out.
//
//   h[d][n] <- exp(dt_t[d] A[d][n]) h[d][n] + (dt_t[d] x_t[d]) B_t[n]
//   y_t[d]   = sum_n h[d][n] C_t[n] + D[d] x_t[d]
//
// x, dt and y (B, L, di), B_t and C_t (B, L, N), A (di, N), D (di,), the
// states (B, di, N), all float32.  Replaces src/repro/kernels/ssm_scan.py::
// mamba_scan_pallas, which starts every sequence from a zero state and
// drops its final state; serving needs both, and from a zero state this
// kernel computes what the Pallas kernel computes.
//
// What bounds it on an H100: at the serve path's prefill (B = 8, L = 512,
// di = 16384, N = 16) it moves ~823 MB (x, dt read once, y written once,
// the state in and out; 0.25 ms at 3.35 TB/s) and computes 1.07e9
// exponentials, ~0.26 ms at the SFU's 16 per clock per SM; the ~6 FLOP per
// (t, d, n) are below both.  At decode (L = 1) the state dominates
// (2 x 8.4 MB, ~5 us).  The design, simple and right first:
//   * one thread per (b, d) channel, blocks of 128 channels of one b: at
//     jamba's shape 131,072 threads, all resident at once;
//   * h[N] and A[d][:] stay in registers for the whole sequence, so the
//     state touches device memory once in and once out;
//   * x and dt are loaded TT steps ahead into registers (coalesced across
//     the channels, TT independent loads in flight); B_t and C_t, shared
//     by the block's channels, go through shared memory;
//   * y_t[d] is written per step (coalesced), in the reference's order:
//     the sum over n first, then D x.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;  // channels per block
constexpr int TT = 16;        // time steps per tile

template <int N>
__global__ void __launch_bounds__(THREADS) mamba_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ a, const float* __restrict__ dskip,
    const float* h_in, float* __restrict__ y, float* h_out, int L, int DI) {
  __shared__ float sb[TT][N], sc[TT][N];
  const int b = blockIdx.y;
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const bool live = d < DI;

  float h[N], an[N];
  float dsk = 0.f;
  const size_t hoff = ((size_t)b * DI + d) * N;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    h[n] = live ? h_in[hoff + n] : 0.f;
    an[n] = live ? a[(size_t)d * N + n] : 0.f;
  }
  if (live) dsk = dskip[d];

  const size_t xb = (size_t)b * L * DI + d;  // x[b, t, d] = xb + t * DI
  const size_t nb = (size_t)b * L * N;       // B_t[b, t, n] = nb + t*N + n
  for (int t0 = 0; t0 < L; t0 += TT) {
    const int nt = min(TT, L - t0);
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < nt * N; e += THREADS) {
      const size_t off = nb + (size_t)t0 * N + e;
      sb[e / N][e % N] = bm[off];
      sc[e / N][e % N] = cm[off];
    }
    float xv[TT], dv[TT];
#pragma unroll
    for (int tt = 0; tt < TT; ++tt) {
      const bool on = live && tt < nt;
      const size_t off = xb + (size_t)(t0 + tt) * DI;
      xv[tt] = on ? x[off] : 0.f;
      dv[tt] = on ? dt[off] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int tt = 0; tt < TT; ++tt) {
      if (tt < nt) {  // uniform across the block
        const float dtx = dv[tt] * xv[tt];
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float decay = expf(dv[tt] * an[n]);
          h[n] = fmaf(h[n], decay, dtx * sb[tt][n]);
          acc = fmaf(h[n], sc[tt][n], acc);
        }
        if (live) y[xb + (size_t)(t0 + tt) * DI] = fmaf(dsk, xv[tt], acc);
      }
    }
  }

  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) h_out[hoff + n] = h[n];
  }
}

template <int N>
cudaError_t launch(const float* x, const float* dt, const float* bm,
                   const float* cm, const float* a, const float* dskip,
                   const float* h_in, float* y, float* h_out, int B, int L,
                   int DI, cudaStream_t stream) {
  const dim3 grid((DI + THREADS - 1) / THREADS, B);
  mamba_scan_kernel<N><<<grid, THREADS, 0, stream>>>(
      x, dt, bm, cm, a, dskip, h_in, y, h_out, L, DI);
  return cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaError_t; cudaErrorInvalidValue for a state size
// N that is not instantiated (4: the reduced test configurations, 16:
// jamba).
extern "C" int mamba_scan_launch(const float* x, const float* dt,
                                 const float* bm, const float* cm,
                                 const float* a, const float* dskip,
                                 const float* h_in, float* y, float* h_out,
                                 int B, int L, int DI, int N,
                                 cudaStream_t stream) {
  switch (N) {
    case 4:
      return launch<4>(x, dt, bm, cm, a, dskip, h_in, y, h_out, B, L, DI,
                       stream);
    case 16:
      return launch<16>(x, dt, bm, cm, a, dskip, h_in, y, h_out, B, L, DI,
                        stream);
    default:
      return cudaErrorInvalidValue;
  }
}
