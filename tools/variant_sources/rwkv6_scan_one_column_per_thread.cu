// K7 with the keys split across 4 threads per value column and one column
// per thread: a redesign step measured against the committed kernel by
// tools/kernel_variants.py (k7 one_column_per_thread).
//
//   o_t[j]    = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//   S[i][j]  <- w_t[i] S[i][j] + k_t[i] v_t[j]
//
//   * the bonus term is one scalar per step, sum_i r_i u_i k_i, computed by
//     a warp while the tile is staged: 3 FP32 instructions per (i, j);
//   * G = 4 threads per value column, K / G keys each, summed with two
//     shuffles; at K = 64 a (b, h) pair is one block of 256 threads;
//   * r, k and w read from shared memory as float4, rows padded by 4
//     floats per key group.
#include <cuda_runtime.h>

namespace {

constexpr int G = 4;    // threads per value column (key groups)
constexpr int TT = 32;  // time steps staged per tile

// 4 consecutive floats of shared memory, 16-byte aligned: one load
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int K>
__global__ void __launch_bounds__(G * K) rwkv6_scan_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* s_in, float* __restrict__ o,
    float* s_out, int L, int H) {
  constexpr int KG = K / G;          // keys per thread
  constexpr int GROW = KG + 4;       // a key group's padded stride
  constexpr int ROW = G * GROW;      // a padded row of r, k or w
  constexpr int THREADS = G * K;
  constexpr int WARPS = THREADS / 32;
  static_assert(KG % 4 == 0 && THREADS % 32 == 0 && 32 % G == 0,
                "K must be a multiple of 4 G, G a divisor of 32");
  __shared__ __align__(16) float sr[TT][ROW];
  __shared__ __align__(16) float sk[TT][ROW];
  __shared__ __align__(16) float sw[TT][ROW];
  __shared__ float sv[TT][K], sbonus[TT];
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = tid % G;  // this thread's keys: g KG .. g KG + KG - 1
  const int j = tid / G;  // the value column this thread works on

  float s[KG];
  const float* s0 = s_in + ((size_t)bh * K + g * KG) * K + j;
#pragma unroll
  for (int ii = 0; ii < KG; ++ii) s[ii] = s0[(size_t)ii * K];
  // u at the keys lane, lane + 32, ... for the bonus sums
  constexpr int UL = (K + 31) / 32;
  float uu[UL];
#pragma unroll
  for (int q = 0; q < UL; ++q) {
    const int i = lane + 32 * q;
    uu[q] = i < K ? u[(size_t)h * K + i] : 0.f;
  }

  const size_t step = (size_t)H * K;                 // stride of t
  const size_t base = ((size_t)b * L * H + h) * K;   // r[b, 0, h, 0]
  for (int t0 = 0; t0 < L; t0 += TT) {
    const int n = min(TT, L - t0);
    __syncthreads();  // the previous tile is consumed
#pragma unroll
    for (int e0 = 0; e0 < TT * K; e0 += THREADS) {
      const int e = e0 + tid, tt = e / K, i = e % K;
      if (tt < n) {
        const size_t off = base + (size_t)(t0 + tt) * step + i;
        const int p = i + (i / KG) * (GROW - KG);
        sr[tt][p] = r[off];
        sk[tt][p] = k[off];
        sw[tt][p] = w[off];
        sv[tt][i] = v[off];
      }
    }
    __syncthreads();
    // the bonus sums sum_i r_i u_i k_i, one warp per step
    for (int tt = warp; tt < n; tt += WARPS) {
      float p = 0.f;
#pragma unroll
      for (int q = 0; q < UL; ++q) {
        const int i = lane + 32 * q;
        if (i < K) {
          const int c = i + (i / KG) * (GROW - KG);
          p = fmaf(sr[tt][c] * uu[q], sk[tt][c], p);
        }
      }
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) {
        p += __shfl_xor_sync(0xffffffffu, p, m);
      }
      if (lane == 0) sbonus[tt] = p;
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {  // n is uniform across the block
      const float *rg = &sr[tt][g * GROW], *kg = &sk[tt][g * GROW],
                  *wg = &sw[tt][g * GROW];
      const float vj = sv[tt][j];
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < KG / 4; ++q) {
        const float4 rq = lds4(rg + 4 * q), kq = lds4(kg + 4 * q),
                     wq = lds4(wg + 4 * q);
        const float ri[4] = {rq.x, rq.y, rq.z, rq.w};
        const float ki[4] = {kq.x, kq.y, kq.z, kq.w};
        const float wi[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float& sij = s[4 * q + c];
          const float kv = ki[c] * vj;
          acc = fmaf(ri[c], sij, acc);
          sij = fmaf(sij, wi[c], kv);
        }
      }
#pragma unroll
      for (int m = 1; m < G; m <<= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, m);
      }
      if (g == 0) {
        o[base + (size_t)(t0 + tt) * step + j] = fmaf(sbonus[tt], vj, acc);
      }
    }
  }

  float* s1 = s_out + ((size_t)bh * K + g * KG) * K + j;
#pragma unroll
  for (int ii = 0; ii < KG; ++ii) s1[(size_t)ii * K] = s[ii];
}

template <int K>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* s_in,
                   float* o, float* s_out, int B, int L, int H,
                   cudaStream_t stream) {
  rwkv6_scan_kernel<K><<<B * H, G * K, 0, stream>>>(r, k, v, w, u, s_in, o,
                                                    s_out, L, H);
  return cudaGetLastError();
}

}  // namespace

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
