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
// the state read and written once), ~0.105 ms at 3.35 TB/s, and needs
// ~5.5 GFLOP, ~0.08 ms at 67 TFLOP/s, so bytes bound it.  At decode
// (L = 1) the state dominates (2 x 8.4 MB, ~5 us).  The work per step is
// K^2 (key i, value j) pairs, each needing r_i, k_i, w_i and v_j; handing
// each pair its three key floats from shared memory (32 floats a clock an
// SM, whatever the load width) costs more than the pairs' FMAs.  So:
//   * the bonus term is one scalar per step,
//       o_t[j] = sum_i r_i S[i][j] + (sum_i r_i u_i k_i) v_j,
//     and the inner loop is 3 FP32 instructions per (i, j): kv = k_i v_j,
//     acc_j += r_i S_ij, S_ij = S_ij w_i + kv;
//   * a thread holds a block of the state, K / G keys x J value columns
//     (16 x 4 at K = 64, 64 threads a head), in registers for the whole
//     sequence: each key float it reads serves J pairs, a quarter of the
//     shared-memory traffic of one column a thread.  The G threads that
//     share columns sit in one warp; their partial outputs are summed
//     with G - 1 shuffles that halve the columns at each exchange, so each
//     ends holding one column's output.  The bonus sums take the same
//     groups: each thread its keys' part, then log2 G shuffles;
//   * r_t, k_t, v_t and w_t are copied TT steps at a time into shared
//     memory with cp.async, the next tile streaming in under the current
//     one; 16 bytes a copy when the four are 16-byte aligned (the model's
//     fresh projections), else 4 (a view may start anywhere).  r, k and w
//     are read back as float4, from rows padded by 4 floats per key group
//     so the G groups' reads of a warp fall in different banks;
//   * two steps are in flight (the loop unrolled by 2), so one step's
//     shuffles wait under the next one's FMAs;
//   * the state is read and written once, each warp instruction covering
//     4 rows x 8 consecutive columns (4 full 32-byte sectors);
//   * the output reads the state before the step updates it, as in the
//     reference.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// a head of size K is split across G key groups x K / J column slots: each
// thread has K / G keys and J value columns
constexpr int G = 4;
constexpr int J = 4;
constexpr int TT = 16;  // time steps per tile

// 4 consecutive floats of shared memory, 16-byte aligned: one load
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// the shared-memory address of p
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// one float from device memory to shared memory address dst, asynchronously
__device__ __forceinline__ void cp_async4(unsigned dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// 16 bytes from device memory to shared memory address dst, both aligned
__device__ __forceinline__ void cp_async16(unsigned dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// whether every pointer is 16-byte aligned
template <typename... P>
__device__ __forceinline__ bool aligned16(const P*... p) {
  return ((reinterpret_cast<uintptr_t>(p) | ...) & 15) == 0;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most PENDING of this thread's copy groups are in flight
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

template <int K>
__global__ void __launch_bounds__(G*(K / J)) rwkv6_scan_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* s_in, float* __restrict__ o,
    float* s_out, int L, int H) {
  constexpr int KG = K / G;        // keys per thread
  constexpr int GROW = KG + 4;     // a key group's padded stride
  constexpr int ROW = G * GROW;    // a padded row of r, k or w
  constexpr int SLOTS = K / J;     // a thread's columns: slot + SLOTS c
  constexpr int THREADS = G * SLOTS;
  constexpr int LANES = THREADS < 32 ? THREADS : 32;
  constexpr unsigned MASK = LANES == 32 ? 0xffffffffu : (1u << LANES) - 1;
  static_assert(G == J && (G & (G - 1)) == 0 && KG % 4 == 0 &&
                    LANES % G == 0 && THREADS % LANES == 0 &&
                    TT % (THREADS / G) == 0,
                "G = J a power of 2, K a multiple of 4 G");
  __shared__ __align__(16) float sr[2][TT][ROW];
  __shared__ __align__(16) float sk[2][TT][ROW];
  __shared__ __align__(16) float sw[2][TT][ROW];
  __shared__ float sv[2][TT][K], sbonus[TT];
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x;
  const int g = tid % G;     // this thread's keys: g KG .. g KG + KG - 1
  const int slot = tid / G;  // and columns slot + SLOTS c, c < J

  float s[KG][J];
  const float* s0 = s_in + ((size_t)bh * K + g * KG) * K + slot;
#pragma unroll
  for (int ii = 0; ii < KG; ++ii) {
#pragma unroll
    for (int c = 0; c < J; ++c) s[ii][c] = s0[(size_t)ii * K + c * SLOTS];
  }
  // u at this thread's keys, for its part of the bonus sums
  float ug[KG];
#pragma unroll
  for (int ii = 0; ii < KG; ++ii) ug[ii] = u[(size_t)h * K + g * KG + ii];

  const size_t step = (size_t)H * K;                 // stride of t
  const size_t base = ((size_t)b * L * H + h) * K;   // r[b, 0, h, 0]
  const int tiles = (L + TT - 1) / TT;
  // tile -> buffer tile % 2, copied asynchronously, one group per tile.
  // 16 bytes a copy when r, k, v and w are 16-byte aligned (this thread:
  // keys 4 i4 .. 4 i4 + 3 of the steps tid / (K / 4) + THREADS / (K / 4) q),
  // else 4 (key i of the steps tid / K + THREADS / K q)
  const bool wide = aligned16(r, k, v, w);
  const int i = wide ? 4 * (tid % (K / 4)) : tid % K;
  const int t_first = wide ? tid / (K / 4) : tid / K;
  const int t_step = wide ? THREADS / (K / 4) : THREADS / K;
  const int pad = i + (i / KG) * (GROW - KG);   // key i in a padded row
  const unsigned dr = smem_addr(&sr[0][0][pad]), dk = smem_addr(&sk[0][0][pad]),
                 dw = smem_addr(&sw[0][0][pad]), dv = smem_addr(&sv[0][0][i]);
  auto stage = [&](int tile) {
    const int t0 = tile * TT;
    const unsigned bo = (tile & 1) * TT * ROW * 4, bv = (tile & 1) * TT * K * 4;
    for (int tt = t_first; tt < TT; tt += t_step) {
      if (t0 + tt < L) {
        const size_t off = base + (size_t)(t0 + tt) * step + i;
        const unsigned o_rkw = bo + tt * ROW * 4, o_v = bv + tt * K * 4;
        if (wide) {
          cp_async16(dr + o_rkw, r + off);
          cp_async16(dk + o_rkw, k + off);
          cp_async16(dw + o_rkw, w + off);
          cp_async16(dv + o_v, v + off);
        } else {
          cp_async4(dr + o_rkw, r + off);
          cp_async4(dk + o_rkw, k + off);
          cp_async4(dw + o_rkw, w + off);
          cp_async4(dv + o_v, v + off);
        }
      }
    }
    cp_async_commit();
  };
  if (tiles > 0) stage(0);
  for (int tile = 0; tile < tiles; ++tile) {
    const int buf = tile & 1, t0 = tile * TT, n = min(TT, L - t0);
    if (tile + 1 < tiles) {  // the next tile streams in under this one
      stage(tile + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // the bonus sums sum_i r_i u_i k_i: the G threads of a step each take
    // their keys, then add (every step of the tile, so that all lanes
    // shuffle; the steps past n are never read)
    for (int tt = tid / G; tt < TT; tt += THREADS / G) {
      float p = 0.f;
#pragma unroll
      for (int q = 0; q < KG / 4; ++q) {
        const float4 rq = lds4(&sr[buf][tt][g * GROW + 4 * q]),
                     kq = lds4(&sk[buf][tt][g * GROW + 4 * q]);
        p = fmaf(rq.x * ug[4 * q], kq.x, p);
        p = fmaf(rq.y * ug[4 * q + 1], kq.y, p);
        p = fmaf(rq.z * ug[4 * q + 2], kq.z, p);
        p = fmaf(rq.w * ug[4 * q + 3], kq.w, p);
      }
#pragma unroll
      for (int m = 1; m < G; m <<= 1) p += __shfl_xor_sync(MASK, p, m);
      if (g == 0) sbonus[tt] = p;
    }
    __syncthreads();
#pragma unroll 2
    for (int tt = 0; tt < n; ++tt) {  // n is uniform across the block
      const float *rg = &sr[buf][tt][g * GROW], *kg = &sk[buf][tt][g * GROW],
                  *wg = &sw[buf][tt][g * GROW];
      float vj[J], acc[J];
#pragma unroll
      for (int c = 0; c < J; ++c) {
        vj[c] = sv[buf][tt][slot + c * SLOTS];
        acc[c] = 0.f;
      }
#pragma unroll
      for (int q = 0; q < KG / 4; ++q) {
        const float4 rq = lds4(rg + 4 * q), kq = lds4(kg + 4 * q),
                     wq = lds4(wg + 4 * q);
        const float ri[4] = {rq.x, rq.y, rq.z, rq.w};
        const float ki[4] = {kq.x, kq.y, kq.z, kq.w};
        const float wi[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int c = 0; c < J; ++c) {
            float& sij = s[4 * q + e][c];
            const float kv = ki[e] * vj[c];
            acc[c] = fmaf(ri[e], sij, acc[c]);
            sij = fmaf(sij, wi[e], kv);
          }
        }
      }
      // sum the G groups' partial outputs, halving the columns at each
      // exchange: thread g ends with column slot + SLOTS g over every key
#pragma unroll
      for (int m = G / 2, width = J / 2; m > 0; m >>= 1, width >>= 1) {
        const bool upper = g & m;
#pragma unroll
        for (int c = 0; c < width; ++c) {
          const float keep = upper ? acc[c + width] : acc[c];
          const float send = upper ? acc[c] : acc[c + width];
          acc[c] = keep + __shfl_xor_sync(MASK, send, m);
        }
      }
      const int col = slot + SLOTS * g;
      o[base + (size_t)(t0 + tt) * step + col] =
          fmaf(sbonus[tt], sv[buf][tt][col], acc[0]);
    }
    __syncthreads();  // this buffer and the bonus sums are consumed
  }

  float* s1 = s_out + ((size_t)bh * K + g * KG) * K + slot;
#pragma unroll
  for (int ii = 0; ii < KG; ++ii) {
#pragma unroll
    for (int c = 0; c < J; ++c) s1[(size_t)ii * K + c * SLOTS] = s[ii][c];
  }
}

template <int K>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* s_in,
                   float* o, float* s_out, int B, int L, int H,
                   cudaStream_t stream) {
  rwkv6_scan_kernel<K><<<B * H, G * (K / J), 0, stream>>>(
      r, k, v, w, u, s_in, o, s_out, L, H);
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
