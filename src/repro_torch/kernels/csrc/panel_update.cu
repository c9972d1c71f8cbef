// K3/K4: supernodal panel update in IEEE float32.
//
//   out = acc - L @ U        (M, N) = (M, N) - (M, K) @ (K, N)
//
// K3 replaces src/repro/kernels/panel_update.py::panel_update_pallas; K4
// replaces panel_update_batched_pallas, the vmap of K3 over a stack of
// same-shape panels.
//
// What bounds it on an H100: at the panel shapes of the supernodal sweep
// (tens of rows, a few to a few hundred columns) the work is tiny and the
// launch and the bytes dominate; at large panels it is bound by float32
// operations on the CUDA cores.  The contract is true fp32 (the reference
// accumulates with preferred_element_type=float32), so no TF32 tensor-core
// path is used.  The design:
//   * a 64 x 64 output tile per block, 4 x 4 outputs per thread kept in
//     registers, L and U staged through shared memory in 16-deep K steps;
//   * every product is one explicit __fmaf_rn in ascending k order and the
//     final subtraction is __fsub_rn, so the compiler cannot contract or
//     reorder the arithmetic differently between instantiations;
//   * K4 is the SAME kernel body with the stack index as blockIdx.z
//     (template flag Batched only offsets the pointers), so every slice of
//     K4 is bitwise equal to K3 on that slice.  The two instantiations keep
//     distinct names, so a profiler trace tells them apart;
//   * ragged M/N/K edges are bounds-checked while staging (zeros), so
//     nothing is padded in device memory.
#include <cstddef>

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int TM = 4;         // rows per thread, strided by 16
constexpr int TN = 4;         // columns per thread, strided by 16

template <bool Batched>
__global__ void __launch_bounds__(THREADS)
panel_update_kernel(const float* __restrict__ acc,
                    const float* __restrict__ L,
                    const float* __restrict__ U, float* __restrict__ out,
                    int M, int N, int K) {
  if (Batched) {
    const size_t b = blockIdx.z;
    acc += b * M * N;
    out += b * M * N;
    L += b * M * K;
    U += b * K * N;
  }
  __shared__ float sL[BK][BM + 1];  // transposed: sL[k][m]
  __shared__ float sU[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float sum[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) sum[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int idx = i * THREADS + tid;
      const int r = idx / BK;
      const int c = idx % BK;
      const int m = m0 + r;
      const int k = k0 + c;
      sL[c][r] = (m < M && k < K) ? L[static_cast<size_t>(m) * K + k] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      const int idx = i * THREADS + tid;
      const int r = idx / BN;
      const int c = idx % BN;
      const int k = k0 + r;
      const int n = n0 + c;
      sU[r][c] = (k < K && n < N) ? U[static_cast<size_t>(k) * N + n] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
      float b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = sL[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = sU[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) sum[i][j] = __fmaf_rn(a[i], b[j], sum[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m < M && n < N) {
        const size_t o = static_cast<size_t>(m) * N + n;
        out[o] = __fsub_rn(acc[o], sum[i][j]);
      }
    }
  }
}

}  // namespace

// acc/out (B, M, N), L (B, M, K), U (B, K, N) float32, contiguous on the
// current device; M, N, K >= 1.  batched = 0 launches the per-panel
// instantiation (B must be 1), otherwise the stacked one over B slices.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int panel_update_launch(const void* acc, const void* L,
                                   const void* U, void* out, int B, int M,
                                   int N, int K, int batched, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(acc);
  const float* l = static_cast<const float*>(L);
  const float* u = static_cast<const float*>(U);
  float* o = static_cast<float*>(out);
  if (batched) {
    panel_update_kernel<true><<<grid, THREADS, 0, st>>>(a, l, u, o, M, N, K);
  } else {
    if (B != 1) return static_cast<int>(cudaErrorInvalidValue);
    panel_update_kernel<false><<<grid, THREADS, 0, st>>>(a, l, u, o, M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}
