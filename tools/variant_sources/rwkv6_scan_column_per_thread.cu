// K7: the rwkv6 time-mix recurrence, from a state in to a state out.
//
//   o_t[j]    = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//   S[i][j]  <- w_t[i] S[i][j] + k_t[i] v_t[j]
//
// r, k, v, w and o (B, L, H, K), u (H, K), the states (B, H, K, K) keyed
// [key i, value j], all float32.  Replaces src/repro/kernels/ssm_scan.py::
// rwkv6_scan_pallas, which starts every sequence from a zero state and
// drops its final state; serving needs both (the decode cache's state goes
// in and the next one comes out), and from a zero state this kernel
// computes what the Pallas kernel computes.
//
// What bounds it on an H100: at the serve path's prefill (B = 8, L = 512,
// H = 64, K = 64) it moves ~352 MB (r, k, v, w read once, o written once,
// the state read and written once), ~0.105 ms at 3.35 TB/s, and the
// function needs ~5.5 GFLOP (5 per (t, i, j); the bonus term is one scalar
// sum_i r_i u_i k_i per step), ~0.08 ms, so bytes bound it; this kernel
// recomputes u_i k_i v_j inside every (i, j), 7 flops there.  At decode
// (L = 1) the state dominates (2 x 8.4 MB, ~5 us).  The design, simple and
// right first:
//   * one block per (b, h), K threads; thread j keeps column S[:, j] (K
//     floats) in registers for the whole sequence, so the state touches
//     device memory once in and once out;
//   * r_t, k_t, v_t and w_t are staged TT steps at a time in shared memory
//     (coalesced: thread j loads element j of each row); r, k and w are read
//     back as broadcasts, v_t[j] by its own thread;
//   * u stays in registers; o_t[j] is written per step (coalesced);
//   * the per-element update order is the reference's: the output reads
//     the state before the step updates it.
// Known gap: a (b, h) pair is one block of K threads, so at K = 64 each SM
// holds 2-warp blocks and the step's K-long dependent chain is exposed;
// splitting i across threads (with a reduction for o) is later work.
#include <cuda_runtime.h>

namespace {

constexpr int TT = 32;  // time steps staged per tile

template <int K>
__global__ void __launch_bounds__(K) rwkv6_scan_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* s_in, float* __restrict__ o,
    float* s_out, int L, int H) {
  __shared__ float sr[TT][K], sk[TT][K], sv[TT][K], sw[TT][K];
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H, h = bh - b * H;
  const int j = threadIdx.x;  // the value column this thread owns

  float s[K], uu[K];
  const float* s0 = s_in + (size_t)bh * K * K;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    s[i] = s0[(size_t)i * K + j];
    uu[i] = u[(size_t)h * K + i];
  }

  const size_t step = (size_t)H * K;                // stride of t
  const size_t base = ((size_t)b * L * H + h) * K + j;
  for (int t0 = 0; t0 < L; t0 += TT) {
    const int n = min(TT, L - t0);
    __syncthreads();  // the previous tile is consumed
#pragma unroll
    for (int tt = 0; tt < TT; ++tt) {
      if (tt < n) {
        const size_t off = base + (size_t)(t0 + tt) * step;
        sr[tt][j] = r[off];
        sk[tt][j] = k[off];
        sv[tt][j] = v[off];
        sw[tt][j] = w[off];
      }
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = sv[tt][j];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const float kv = sk[tt][i] * vj;
        acc = fmaf(sr[tt][i], fmaf(uu[i], kv, s[i]), acc);
        s[i] = fmaf(s[i], sw[tt][i], kv);
      }
      o[base + (size_t)(t0 + tt) * step] = acc;
    }
  }

  float* s1 = s_out + (size_t)bh * K * K;
#pragma unroll
  for (int i = 0; i < K; ++i) s1[(size_t)i * K + j] = s[i];
}

template <int K>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* s_in,
                   float* o, float* s_out, int B, int L, int H,
                   cudaStream_t stream) {
  rwkv6_scan_kernel<K><<<B * H, K, 0, stream>>>(r, k, v, w, u, s_in, o,
                                                s_out, L, H);
  return cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaError_t; cudaErrorInvalidValue for a head size
// K that is not instantiated (16: the reduced test configurations, 64:
// rwkv6-7b).
extern "C" int rwkv6_scan_launch(const float* r, const float* k,
                                 const float* v, const float* w,
                                 const float* u, const float* s_in, float* o,
                                 float* s_out, int B, int L, int H, int K,
                                 cudaStream_t stream) {
  switch (K) {
    case 16:
      return launch<16>(r, k, v, w, u, s_in, o, s_out, B, L, H, stream);
    case 64:
      return launch<64>(r, k, v, w, u, s_in, o, s_out, B, L, H, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
