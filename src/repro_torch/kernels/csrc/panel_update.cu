// K3/K4: supernodal panel update in IEEE float32, and its float64 instance.
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
//   * every product is one explicit round-to-nearest FMA (__fmaf_rn, or
//     __fma_rn for double) in ascending k order and the final subtraction
//     is __fsub_rn / __dsub_rn, so the compiler cannot contract or reorder
//     the arithmetic differently between instantiations;
//   * the body is a template on the element type: the float64 instance is
//     the default ("numpy") backend's trailing GEMM on the card, where it
//     makes segment batching bitwise (a stacked cuBLAS DGEMM sums in
//     another order than a per-panel one).  Its tiles are the same; its
//     shared staging is twice the bytes (16.5 KB);
//   * K4 is the SAME kernel body with the stack index as blockIdx.z
//     (template flag Batched only offsets the pointers), so every slice of
//     K4 is bitwise equal to K3 on that slice.  The two instantiations keep
//     distinct names, so a profiler trace tells them apart;
//   * ragged M/N/K edges are bounds-checked while staging (zeros), so
//     nothing is padded in device memory.
#include <cstddef>

#include <cuda_runtime.h>

namespace {

// explicit round-to-nearest arithmetic per element type
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int TM = 4;         // rows per thread, strided by 16
constexpr int TN = 4;         // columns per thread, strided by 16

template <typename T, bool Batched>
__global__ void __launch_bounds__(THREADS)
panel_update_kernel(const T* __restrict__ acc, const T* __restrict__ L,
                    const T* __restrict__ U, T* __restrict__ out, int M,
                    int N, int K) {
  if (Batched) {
    const size_t b = blockIdx.z;
    acc += b * M * N;
    out += b * M * N;
    L += b * M * K;
    U += b * K * N;
  }
  __shared__ T sL[BK][BM + 1];  // transposed: sL[k][m]
  __shared__ T sU[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  T sum[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) sum[i][j] = T(0);

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int idx = i * THREADS + tid;
      const int r = idx / BK;
      const int c = idx % BK;
      const int m = m0 + r;
      const int k = k0 + c;
      sL[c][r] = (m < M && k < K) ? L[static_cast<size_t>(m) * K + k] : T(0);
    }
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      const int idx = i * THREADS + tid;
      const int r = idx / BN;
      const int c = idx % BN;
      const int k = k0 + r;
      const int n = n0 + c;
      sU[r][c] = (k < K && n < N) ? U[static_cast<size_t>(k) * N + n] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      T a[TM];
      T b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = sL[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = sU[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) sum[i][j] = fma_rn(a[i], b[j], sum[i][j]);
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
        out[o] = sub_rn(acc[o], sum[i][j]);
      }
    }
  }
}

template <typename T>
int launch(const void* acc, const void* L, const void* U, void* out, int B,
           int M, int N, int K, int batched, cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, B);
  const T* a = static_cast<const T*>(acc);
  const T* l = static_cast<const T*>(L);
  const T* u = static_cast<const T*>(U);
  T* o = static_cast<T*>(out);
  if (batched) {
    panel_update_kernel<T, true><<<grid, THREADS, 0, st>>>(a, l, u, o, M, N,
                                                           K);
  } else {
    if (B != 1) return static_cast<int>(cudaErrorInvalidValue);
    panel_update_kernel<T, false><<<grid, THREADS, 0, st>>>(a, l, u, o, M, N,
                                                            K);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// acc/out (B, M, N), L (B, M, K), U (B, K, N), contiguous on the current
// device, all float32 (f64 = 0) or all float64 (f64 = 1); M, N, K >= 1.
// batched = 0 launches the per-panel instantiation (B must be 1), otherwise
// the stacked one over B slices.  Returns the cudaError_t of the launch (0
// on success).
extern "C" int panel_update_launch(const void* acc, const void* L,
                                   const void* U, void* out, int B, int M,
                                   int N, int K, int batched, int f64,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f64) return launch<double>(acc, L, U, out, B, M, N, K, batched, st);
  return launch<float>(acc, L, U, out, B, M, N, K, batched, st);
}
