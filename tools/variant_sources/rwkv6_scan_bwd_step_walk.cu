// K7's backward as it was before its redesign: the step-by-step walk
// (one key row and 16 value columns of the state a
// thread, K^2 FMAs a step on the CUDA cores; a forward sweep saving the state every 8 steps).
// Kept for tools/kernel_variants.py (group k7bwd); its entry points
// take the committed kernel's arguments.
//
// K7's backward: the gradient of the rwkv6 recurrence (rwkv6_scan.cu)
//
//   o_t[j]    = sum_i r_t[i] (S_{t-1}[i][j] + u[i] k_t[i] v_t[j])
//   S_t[i][j] = w_t[i] S_{t-1}[i][j] + k_t[i] v_t[j]
//
// for the upstream do (B, L, H, K) of o and ds (B, H, K, K) of the final
// state.  With G the gradient of S_t (G = ds after the last step), walking
// back in time:
//
//   dr_t[i] = sum_j S_{t-1}[i][j] do_t[j] + u_i k_t[i] (v_t . do_t)
//   dk_t[i] = sum_j G[i][j] v_t[j]        + u_i r_t[i] (v_t . do_t)
//   dv_t[j] = sum_i G[i][j] k_t[i]        + do_t[j] sum_i r_t[i] u_i k_t[i]
//   dw_t[i] = sum_j G[i][j] S_{t-1}[i][j]
//   du[i]  += r_t[i] k_t[i] (v_t . do_t)          (over B and L)
//   G      <- diag(w_t) G + r_t^T do_t
//
// and dstate is G after the first step.  All float32.  Replaces no TPU
// kernel: the JAX package trains through jax.value_and_grad of the lax.scan
// recurrence (src/repro/models/rwkv6.py::_recurrence) and has no Pallas
// backward; this is the train path's gradient of K7 (rwkv6_scan_pallas).
//
// What bounds it on an H100: at rwkv6-7b's train shape (B = 8, L = 512,
// H = 64, K = 64) it must read r, k, v, w, do and write dr, dk, dv, dw
// (~604 MB, 0.18 ms at 3.35 TB/s); the ~10 FP32 operations per (t, i, j)
// (the state's recompute 2 a pass, the walk 6) are ~1.1e10, 0.16 ms at
// 67 TFLOP/s.  dw needs S_{t-1} and G together, one walking forward and
// one back, so the design is about getting S_{t-1} in reverse order:
//   * S is never un-stepped (S_{t-1} = (S_t - k^T v) / w_t blows up where
//     w is tiny or 0).  A first sweep runs the recurrence forward from the
//     state in and saves S every TT steps into a scratch buffer (B H L/TT
//     K^2 floats, 537 MB at the train shape: every step's state would be
//     4.3 GB); the walk back takes the tiles in reverse, recomputes each
//     tile's TT states from its saved state and keeps them in registers;
//   * a thread owns one key row i and CW = 16 value columns of S and of G
//     (K / 16 column blocks of K threads: 256 threads a head at K = 64),
//     so the row sums of dr, dk and dw are its own 16 FMAs, and the column
//     sums of dv are halving shuffles over the warp's keys (each exchange
//     halves the columns a lane holds) and one add across the two warps of
//     a column block in shared memory;
//   * r, k, v, w and do of a tile are copied into shared memory with
//     cp.async, the next tile (the previous one, walking back) streaming in
//     under the current one; v_t and do_t are read as float4 broadcasts
//     (every lane of a warp reads the same 16 columns), r, k, w at the
//     lane's key (no bank conflicts);
//   * every sum is in a fixed order and there are no atomics: du is a
//     partial per (b, h), summed over B by a second kernel, so two calls
//     on the same inputs agree bitwise.
#include <cuda_runtime.h>

namespace {

constexpr int TT = 8;   // steps per tile, and between saved states
constexpr int CW = 16;  // value columns of one thread

// one float from device memory to shared memory address dst, asynchronously
__device__ __forceinline__ void cp_async4(unsigned dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most PENDING of this thread's copy groups are in flight
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Sums v[0 .. W) over the lanes that differ in the bits M, M / 2, .., 1 of
// the lane index: while more than one value is left, each exchange halves
// the values a lane holds (the lanes with bit M set keep the upper half),
// then the lanes add what they hold.  v[0] ends as the sum of value idx
// (idx accumulates the kept halves' offsets).  The widths are template
// arguments, so every loop unrolls and v stays in registers.
template <int W, int M>
__device__ __forceinline__ void halve(float* v, int lane, int& idx,
                                      unsigned mask) {
  if constexpr (M > 0) {
    if constexpr (W > 1) {
      constexpr int H = W / 2;
      const bool upper = lane & M;
#pragma unroll
      for (int e = 0; e < H; ++e) {
        const float keep = upper ? v[e + H] : v[e];
        const float send = upper ? v[e] : v[e + H];
        v[e] = keep + __shfl_xor_sync(mask, send, M);
      }
      if (upper) idx += H;
      halve<H, M / 2>(v, lane, idx, mask);
    } else {
      v[0] += __shfl_xor_sync(mask, v[0], M);
      halve<1, M / 2>(v, lane, idx, mask);
    }
  }
}

// the dynamic shared memory of a head of size K, in floats: r, k, v, w, do
// double-buffered (5, 2, TT, K), u (K), v . do and sum r u k (2, TT), the
// row partials (3, TT, K / CW, K) and the column partials (TT, K / LANES,
// K)
template <int K>
constexpr int smem_floats() {
  return 10 * TT * K + K + 2 * TT + 3 * TT * (K / CW) * K +
         TT * (K / (K < 32 ? K : 32)) * K;
}

template <int K>
__global__ void __launch_bounds__(K*(K / CW), 1) rwkv6_scan_bwd_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* __restrict__ s_in,
    const float* __restrict__ dout, const float* __restrict__ ds,
    float* __restrict__ dr, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ dw, float* __restrict__ dstate,
    float* __restrict__ chk, float* __restrict__ du_part, int L, int H) {
  constexpr int CB = K / CW;               // column blocks
  constexpr int THREADS = K * CB;
  constexpr int LANES = K < 32 ? K : 32;   // keys of a column block a warp
  constexpr int HALVES = K / LANES;        // warps of a column block
  constexpr int WL = THREADS < 32 ? THREADS : 32;  // lanes of a warp
  constexpr int NW = THREADS / WL;                 // warps
  // the warp's active lanes (a warp may hold two column blocks of K = 16)
  constexpr unsigned WMASK = WL == 32 ? 0xffffffffu : (1u << WL) - 1;
  constexpr int SEQ = 2 * TT * K;          // one sequence, both buffers
  static_assert(K % CW == 0 && LANES >= CW && (LANES & (LANES - 1)) == 0,
                "K = 16 or a multiple of 32");
  extern __shared__ __align__(16) float smem[];
  // sequence q (r, k, v, w, do), buffer buf, step tt, key: [q][buf][tt][key]
  float* const sseq = smem;
  float* const su = smem + 5 * SEQ;
  float* const svdo = su + K;
  float* const sruk = svdo + TT;
  float* const srow = sruk + TT;                // [3][TT][CB][K]
  float* const scol = srow + 3 * TT * CB * K;   // [TT][HALVES][K]
  auto at = [&](int q, int buf, int tt, int key) -> float& {
    return sseq[q * SEQ + (buf * TT + tt) * K + key];
  };
  enum { QR, QK, QV, QW, QDO };  // the sequences' slots

  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x;
  const int cb = tid / K;           // this thread's columns j0 .. j0 + 15
  const int i = tid - cb * K;       // and key
  const int j0 = cb * CW;
  const int lane = i % LANES, wh = i / LANES;
  const int wl = tid % WL, warp = tid / WL;
  const size_t step = (size_t)H * K;                 // stride of t
  const size_t base = ((size_t)b * L * H + h) * K;   // r[b, 0, h, 0]
  const int nc = (L + TT - 1) / TT;
  // saved state c of this thread: CW floats, column jj at jj * THREADS
  float* const my_chk = chk + (size_t)bh * nc * CW * THREADS + tid;

  for (int e = tid; e < K; e += THREADS) su[e] = u[(size_t)h * K + e];
  // copy tile c's steps of k, v, w (and r, do with all) into buffer c % 2,
  // asynchronously, as one copy group (the steps past L are not copied and
  // not read)
  const unsigned s0 = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  auto stage = [&](int c, bool all) {
    const int t0 = c * TT, buf = c & 1;
    for (int e = tid; e < TT * K; e += THREADS) {
      const int tt = e / K, key = e - tt * K;
      if (t0 + tt < L) {
        const size_t off = base + (size_t)(t0 + tt) * step + key;
        const unsigned dst = s0 + 4 * ((buf * TT + tt) * K + key);
        cp_async4(dst + 4 * QK * SEQ, k + off);
        cp_async4(dst + 4 * QV * SEQ, v + off);
        cp_async4(dst + 4 * QW * SEQ, w + off);
        if (all) {
          cp_async4(dst + 4 * QR * SEQ, r + off);
          cp_async4(dst + 4 * QDO * SEQ, dout + off);
        }
      }
    }
    cp_async_commit();
  };
  // one step of the recurrence on this thread's part of the state
  auto advance = [&](float (&s)[CW], int buf, int tt) {
    const float ki = at(QK, buf, tt, i), wi = at(QW, buf, tt, i);
    const float* vrow = &at(QV, buf, tt, j0);
#pragma unroll
    for (int q = 0; q < CW / 4; ++q) {
      const float4 vq = *reinterpret_cast<const float4*>(vrow + 4 * q);
      s[4 * q] = fmaf(s[4 * q], wi, ki * vq.x);
      s[4 * q + 1] = fmaf(s[4 * q + 1], wi, ki * vq.y);
      s[4 * q + 2] = fmaf(s[4 * q + 2], wi, ki * vq.z);
      s[4 * q + 3] = fmaf(s[4 * q + 3], wi, ki * vq.w);
    }
  };

  // sweep 1: forward from the state in, saving the state before each tile
  {
    float s[CW];
    const float* s_row = s_in + ((size_t)bh * K + i) * K + j0;
#pragma unroll
    for (int jj = 0; jj < CW; ++jj) s[jj] = s_row[jj];
    if (nc > 1) stage(0, false);
    for (int c = 0; c < nc; ++c) {
      float* dst = my_chk + (size_t)c * CW * THREADS;
#pragma unroll
      for (int jj = 0; jj < CW; ++jj) dst[(size_t)jj * THREADS] = s[jj];
      if (c + 1 == nc) break;  // the last tile's steps are not needed
      if (c + 2 < nc) {        // the next tile streams in under this one
        stage(c + 1, false);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
#pragma unroll
      for (int tt = 0; tt < TT; ++tt) advance(s, c & 1, tt);  // whole tile
      __syncthreads();  // this buffer is consumed before it is refilled
    }
  }

  // sweep 2: back in time, tile by tile
  float g[CW];
  const size_t srow0 = ((size_t)bh * K + i) * K + j0;
#pragma unroll
  for (int jj = 0; jj < CW; ++jj) g[jj] = ds[srow0 + jj];
  float du_acc = 0.f;
  if (nc > 0) stage(nc - 1, true);
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * TT, n = min(TT, L - t0), buf = c & 1;
    if (c > 0) {  // the previous tile streams in under this one
      stage(c - 1, true);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // the step's scalars v . do and sum_i r u k: one warp a step, its
    // lanes over the keys, then a butterfly
    for (int tt = warp; tt < n; tt += NW) {
      float p = 0.f, q = 0.f;
      for (int key = wl; key < K; key += WL) {
        p = fmaf(at(QV, buf, tt, key), at(QDO, buf, tt, key), p);
        q = fmaf(at(QR, buf, tt, key) * su[key], at(QK, buf, tt, key), q);
      }
#pragma unroll
      for (int m = WL / 2; m > 0; m >>= 1) {
        p += __shfl_xor_sync(WMASK, p, m);
        q += __shfl_xor_sync(WMASK, q, m);
      }
      if (wl == 0) {
        svdo[tt] = p;
        sruk[tt] = q;
      }
    }
    // the tile's states S_{t-1}, recomputed from the saved one
    float hist[TT][CW];
    {
      const float* src = my_chk + (size_t)c * CW * THREADS;
#pragma unroll
      for (int jj = 0; jj < CW; ++jj) hist[0][jj] = src[(size_t)jj * THREADS];
#pragma unroll
      for (int tt = 1; tt < TT; ++tt) {
        if (tt < n) {
#pragma unroll
          for (int jj = 0; jj < CW; ++jj) hist[tt][jj] = hist[tt - 1][jj];
          advance(hist[tt], buf, tt - 1);
        }
      }
    }
    __syncthreads();  // the scalars are in place
#pragma unroll
    for (int tt = TT - 1; tt >= 0; --tt) {
      if (tt < n) {  // n is uniform across the block
        const float ri = at(QR, buf, tt, i), ki = at(QK, buf, tt, i),
                    wi = at(QW, buf, tt, i);
        const float* vrow = &at(QV, buf, tt, j0);
        const float* drow = &at(QDO, buf, tt, j0);
        float pr = 0.f, pk = 0.f, pw = 0.f, col[CW];
#pragma unroll
        for (int q = 0; q < CW / 4; ++q) {
          const float4 vq = *reinterpret_cast<const float4*>(vrow + 4 * q);
          const float4 dq = *reinterpret_cast<const float4*>(drow + 4 * q);
          const float vj[4] = {vq.x, vq.y, vq.z, vq.w};
          const float dj[4] = {dq.x, dq.y, dq.z, dq.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int jj = 4 * q + e;
            const float sp = hist[tt][jj];
            pr = fmaf(sp, dj[e], pr);
            pw = fmaf(g[jj], sp, pw);
            pk = fmaf(g[jj], vj[e], pk);
            col[jj] = g[jj] * ki;
            g[jj] = fmaf(g[jj], wi, ri * dj[e]);
          }
        }
        srow[((0 * TT + tt) * CB + cb) * K + i] = pr;
        srow[((1 * TT + tt) * CB + cb) * K + i] = pk;
        srow[((2 * TT + tt) * CB + cb) * K + i] = pw;
        // the column sums over the warp's keys; lane ends with column
        // j0 + cj
        int cj = 0;
        halve<CW, LANES / 2>(col, lane, cj, WMASK);
        if ((lane & (LANES / CW - 1)) == 0)
          scol[(tt * HALVES + wh) * K + j0 + cj] = col[0];
        if (cb == 0) du_acc = fmaf(ri * ki, svdo[tt], du_acc);
      }
    }
    __syncthreads();  // the partial sums are in place
    // the tile's gradients: the partials in a fixed order, the bonus terms
    for (int e = tid; e < n * K; e += THREADS) {
      const int tt = e / K, key = e - tt * K;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int q = 0; q < CB; ++q) {
        a0 += srow[((0 * TT + tt) * CB + q) * K + key];
        a1 += srow[((1 * TT + tt) * CB + q) * K + key];
        a2 += srow[((2 * TT + tt) * CB + q) * K + key];
      }
#pragma unroll
      for (int q = 0; q < HALVES; ++q) a3 += scol[(tt * HALVES + q) * K + key];
      const size_t off = base + (size_t)(t0 + tt) * step + key;
      const float uk = su[key];
      dr[off] = fmaf(uk * at(QK, buf, tt, key), svdo[tt], a0);
      dk[off] = fmaf(uk * at(QR, buf, tt, key), svdo[tt], a1);
      dw[off] = a2;
      dv[off] = fmaf(at(QDO, buf, tt, key), sruk[tt], a3);
    }
    __syncthreads();  // this buffer is consumed before it is refilled
  }
#pragma unroll
  for (int jj = 0; jj < CW; ++jj) dstate[srow0 + jj] = g[jj];
  if (cb == 0) du_part[(size_t)bh * K + i] = du_acc;
}

// du[h][i] = sum over b, in order, of du_part[b][h][i]
__global__ void rwkv6_du_sum_kernel(const float* __restrict__ du_part,
                                    float* __restrict__ du, int B, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc += du_part[(size_t)b * n + e];
  du[e] = acc;
}

template <int K>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* s_in,
                   const float* dout, const float* ds, float* dr, float* dk,
                   float* dv, float* dw, float* du, float* dstate,
                   float* chk, float* du_part, int B, int L, int H,
                   cudaStream_t stream) {
  const size_t smem = smem_floats<K>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_scan_bwd_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  rwkv6_scan_bwd_kernel<K><<<B * H, K * (K / CW), smem, stream>>>(
      r, k, v, w, u, s_in, dout, ds, dr, dk, dv, dw, dstate, chk, du_part,
      L, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = H * K;
  rwkv6_du_sum_kernel<<<(n + 255) / 256, 256, 0, stream>>>(du_part, du, B,
                                                           n);
  return cudaGetLastError();
}

}  // namespace

// The states the kernel saves for L steps, each of a sequence and head:
// the wrapper allocates B H K^2 floats of scratch for each.
extern "C" int rwkv6_scan_bwd_saved(int L) { return (L + TT - 1) / TT; }

// Returns the launches' cudaError_t; cudaErrorInvalidValue for a head size
// K that is not instantiated (16: the reduced test configurations, 64:
// rwkv6-7b).  chk holds rwkv6_scan_bwd_scratch floats, du_part B H K.
extern "C" int rwkv6_scan_bwd_launch(
    const float* r, const float* k, const float* v, const float* w,
    const float* u, const float* s_in, const float* dout, const float* ds,
    float* dr, float* dk, float* dv, float* dw, float* du, float* dstate,
    float* chk, float* du_part, int B, int L, int H, int K,
    cudaStream_t stream) {
  switch (K) {
    case 16:
      return launch<16>(r, k, v, w, u, s_in, dout, ds, dr, dk, dv, dw, du,
                        dstate, chk, du_part, B, L, H, stream);
    case 64:
      return launch<64>(r, k, v, w, u, s_in, dout, ds, dr, dk, dv, dw, du,
                        dstate, chk, du_part, B, L, H, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
