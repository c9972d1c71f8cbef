// K5: blocked online-softmax (flash) attention, causal with a KV offset.
//
//   out[bh, s] = softmax_t(scale * q[bh, s] . k[bh, t]) @ v[bh, t]
//   over keys t <= s + (T - S) when causal, over all T keys otherwise
//
// q (BH, S, D), k and v (BH, T, D), T >= S when causal; float32 or bfloat16
// in, the softmax and both products accumulated in float32, the output in
// q's dtype.  Replaces src/repro/kernels/flash_attention.py::
// flash_attention_pallas (the TPU wrapper's padding of D to 128 lanes is a
// TPU layout artifact and is not carried over).
//
// What bounds it on an H100: at the serve path's prefill (S = T = 512,
// D = 64) the useful causal work is ~4.3 GFLOP against ~67 MB of q/k/v/o,
// so it is bound by operations; this kernel runs them as float32 FMAs on
// the CUDA cores (67 TFLOP/s peak), not on the tensor cores, because TF32
// would move the numbers off the float32 reference.  At decode (S = 1 over
// a T-deep cache) it is bound by reading K and V once.  The design, simple
// and right first:
//   * one block of 256 threads per (bh, 64-query tile); the query tile is
//     staged once, transposed, in shared memory;
//   * 64-row K and V tiles are staged through shared memory; each thread
//     computes a 4 x 4 patch of the 64 x 64 score tile (rows ty + 16 i,
//     keys tx + 16 j), so a row's scores sit in the 16 lanes of one
//     half-warp and its max and sum are two shuffle reductions;
//   * the running max and sum of each query row stay in registers, the
//     output rows (4 rows x D / 16 columns per thread) too; the tile's
//     probabilities go through shared memory to the P @ V product;
//   * causal tiles past a query tile's last visible key are skipped;
//     masked scores never reach the sum (explicit select, as the reference);
//   * D is a template parameter: 64 (smollm), 128 (qwen3) and 16 (the
//     reduced test configurations).
// Known gap: a decode call (S = 1) fills one row of the 64-row query tile,
// so 63/64 of its score work is wasted; the redesign with wgmma and TMA
// (and a query tile over the GQA group) is later work (ROADMAP Queue B 5).
#include <cstddef>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 64;       // key/value rows per tile
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int TM = 4;         // query rows per thread, strided by 16
constexpr int TN = 4;         // keys per thread and tile, strided by 16
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// max / sum over the 16 lanes of a half-warp (one query row's keys)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// shared-memory layout, in floats
template <int D>
struct Smem {
  static constexpr int kQ = 0;                    // sQ[d][r], stride BQ + 1
  static constexpr int kK = kQ + D * (BQ + 1);    // sK[d][j], stride BKV + 1
  static constexpr int kV = kK + D * (BKV + 1);   // sV[j][d], stride D
  static constexpr int kP = kV + BKV * D;         // sP[r][j], stride BKV + 1
  static constexpr size_t bytes =
      sizeof(float) * static_cast<size_t>(kP + BQ * (BKV + 1));
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
                       int Tk, int causal, float scale) {
  constexpr int DN = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem + Smem<D>::kQ;
  float* sK = smem + Smem<D>::kK;
  float* sV = smem + Smem<D>::kV;
  float* sP = smem + Smem<D>::kP;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int kv_offset = Tk - S;
  q += bh * S * D;
  out += bh * S * D;
  k += bh * Tk * D;
  v += bh * Tk * D;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D;
    const int c = idx % D;
    sQ[c * (BQ + 1) + r] =
        q0 + r < S ? to_f32(q[static_cast<size_t>(q0 + r) * D + c]) : 0.0f;
  }

  float m[TM], l[TM], o[TM][DN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = NEG;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DN; ++c) o[i][c] = 0.0f;
  }

  int n_tiles = (Tk + BKV - 1) / BKV;
  if (causal) {
    const int last_key = min(q0 + BQ, S) - 1 + kv_offset;
    n_tiles = min(n_tiles, last_key / BKV + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // the previous tile's reads of sK/sV/sP are done
    for (int idx = tid; idx < BKV * D; idx += THREADS) {
      const int j = idx / D;
      const int c = idx % D;
      const bool in = k0 + j < Tk;
      const size_t g = static_cast<size_t>(k0 + j) * D + c;
      sK[c * (BKV + 1) + j] = in ? to_f32(k[g]) : 0.0f;
      sV[j * D + c] = in ? to_f32(v[g]) : 0.0f;
    }
    __syncthreads();

    float sc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) sc[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = sQ[d * (BQ + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = sK[d * (BKV + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) sc[i][j] = fmaf(a[i], b[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = q0 + ty + 16 * i;
      bool ok[TN];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int key = k0 + tx + 16 * j;
        ok[j] = key < Tk && (!causal || key <= row + kv_offset);
        sc[i][j] = ok[j] ? sc[i][j] * scale : NEG;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.0f;
        sP[(ty + 16 * i) * (BKV + 1) + tx + 16 * j] = p;
        psum += p;
      }
      l[i] = l[i] * alpha + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DN; ++c) o[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int j = 0; j < BKV; ++j) {
      float p[TM], vv[DN];
#pragma unroll
      for (int i = 0; i < TM; ++i) p[i] = sP[(ty + 16 * i) * (BKV + 1) + j];
#pragma unroll
      for (int c = 0; c < DN; ++c) vv[c] = sV[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c = 0; c < DN; ++c) o[i][c] = fmaf(p[i], vv[c], o[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < S) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < DN; ++c)
        out[static_cast<size_t>(row) * D + tx + 16 * c] =
            from_f32<T>(o[i][c] / denom);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int S, int Tk, int causal, float scale, cudaStream_t st) {
  // above 48 KB a block's shared memory must be asked for, once per kernel
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Smem<D>::bytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(BH, (S + BQ - 1) / BQ);
  flash_attention_kernel<T, D><<<grid, THREADS, Smem<D>::bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Tk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int BH,
             int S, int Tk, int D, int causal, float scale, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, BH, S, Tk, causal, scale, st);
    case 64: return launch<T, 64>(q, k, v, out, BH, S, Tk, causal, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, out, BH, S, Tk, causal, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q/out (BH, S, D), k/v (BH, Tk, D), contiguous on the current device, all
// float32 (bf16 = 0) or all bfloat16 (bf16 = 1); D in {16, 64, 128};
// S >= 1, BH >= 1, and Tk >= S when causal.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int BH, int S,
                                      int Tk, int D, int causal, float scale,
                                      int bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_d<__nv_bfloat16>(q, k, v, out, BH, S, Tk, D, causal, scale,
                                   st);
  return launch_d<float>(q, k, v, out, BH, S, Tk, D, causal, scale, st);
}
