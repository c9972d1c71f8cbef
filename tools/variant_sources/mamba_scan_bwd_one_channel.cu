// K6's backward as it was before its redesign: the step-by-step walk
// (one channel's N states a thread, the warp's sums
// of dB_t and dC_t for each channel; a forward sweep saving the state every 8 steps).
// Kept for tools/kernel_variants.py (group k6bwd); its entry points
// take the committed kernel's arguments.
//
// K6's backward: the gradient of the selective (S6) scan (mamba_scan.cu)
//
//   h_t[d][n] = a_t[d][n] h_{t-1}[d][n] + dt_t[d] x_t[d] B_t[n],
//   a_t = exp(dt_t[d] A[d][n]),   y_t[d] = sum_n h_t[d][n] C_t[n] + D[d] x_t[d]
//
// for the upstream dy (B, L, di) of y and dh (B, di, N) of the final state.
// With g the gradient of h_t, walking back in time:
//
//   g_t   = a_{t+1} g_{t+1} + dy_t[d] C_t[n]       (g_L = dh + dy_L C_L)
//   dx_t  = D dy_t + dt_t (g_t . B_t)
//   ddt_t = sum_n g_t h_{t-1} a_t A + x_t (g_t . B_t)
//   dB_t  = sum_d g_t dt_t x_t,   dC_t = sum_d dy_t h_t      (over di)
//   dA   += g_t h_{t-1} a_t dt_t, dD += dy_t x_t           (over B and L)
//
// and dh0 is a_1 g_1.  All float32.  Replaces no TPU kernel: the JAX
// package trains through jax.value_and_grad of the lax.scan recurrence
// (src/repro/models/mamba.py::_selective_scan) and has no Pallas backward;
// this is the train path's gradient of K6 (mamba_scan_pallas).
//
// What bounds it on an H100: at the jamba period's train shape (B = 8,
// L = 512, di = 16384, N = 16) it must read x, dt, dy, B_t, C_t and write
// dx, ddt, dB, dC (~1.3 GB, 0.40 ms at 3.35 TB/s), and it computes
// exp(dt A) per (t, d, n) in each of its three passes: 3.2e9 exponentials,
// 0.77 ms at the special function units' 16 a clock an SM.  The design:
//   * h is never un-stepped (dividing by a_t blows up where it underflows).
//     A first sweep runs the recurrence forward from h0 and saves h every
//     TT steps into a scratch buffer (B di N L/TT floats, 537 MB at the
//     train shape); the walk back takes the tiles in reverse, recomputes
//     each tile's states h_{t-1} from its saved state into shared memory
//     (TT x N x 128 floats, each thread's own, conflict-free) and keeps
//     h_t in registers as it walks;
//   * a thread owns one channel d and its N states (blocks of 128 channels
//     of one b), A scaled by log2(e) once, and exp as one ex2.approx (as
//     the forward);
//   * a tile's x, dt, dy (each thread its own channel, coalesced) and B_t,
//     C_t are loaded into registers during the tile before, so no tile
//     waits on device memory;
//   * dB_t and dC_t sum over all di channels: each step's 2N products are
//     summed over the warp by halving shuffles, the 4 warps' sums are added
//     in shared memory in a fixed order into a partial per block, and a
//     second kernel adds the blocks' partials in a fixed order; dA and dD
//     are partials per b, added over B by that kernel.  No atomics, so two
//     calls on the same inputs agree bitwise.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;  // channels per block, one a thread
constexpr int TT = 8;         // steps per tile, and between saved states
constexpr int WARPS = THREADS / 32;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// 2^x on the special function unit
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Sums v[0 .. W) over the lanes that differ in the bits M, M / 2, .., 1 of
// the lane index: while more than one value is left, each exchange halves
// the values a lane holds (the lanes with bit M set keep the upper half),
// then the lanes add what they hold.  v[0] ends as the sum of value idx
// (idx accumulates the kept halves' offsets).  The widths are template
// arguments, so every loop unrolls and v stays in registers.
template <int W, int M>
__device__ __forceinline__ void halve(float* v, int lane, int& idx) {
  if constexpr (M > 0) {
    if constexpr (W > 1) {
      constexpr int H = W / 2;
      const bool upper = lane & M;
#pragma unroll
      for (int e = 0; e < H; ++e) {
        const float keep = upper ? v[e + H] : v[e];
        const float send = upper ? v[e] : v[e + H];
        v[e] = keep + __shfl_xor_sync(0xffffffffu, send, M);
      }
      if (upper) idx += H;
      halve<H, M / 2>(v, lane, idx);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], M);
      halve<1, M / 2>(v, lane, idx);
    }
  }
}

// the dynamic shared memory of one block, in floats: the tile's states
// (TT, N, THREADS), B_t and C_t (TT, N) each, the warps' sums (TT, WARPS,
// 2N)
template <int N>
constexpr int smem_floats() {
  return TT * N * THREADS + 2 * TT * N + TT * WARPS * 2 * N;
}

template <int N>
__global__ void __launch_bounds__(THREADS) mamba_scan_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ a, const float* __restrict__ dskip,
    const float* __restrict__ h_in, const float* __restrict__ dy,
    const float* __restrict__ dh, float* __restrict__ dx,
    float* __restrict__ ddt, float* __restrict__ dh0,
    float* __restrict__ chk, float* __restrict__ part_bc,
    float* __restrict__ part_a, float* __restrict__ part_d, int B, int L,
    int DI) {
  constexpr int N2 = 2 * N;                     // dB_t and dC_t together
  static_assert(N2 <= 32 && (N2 & (N2 - 1)) == 0 && TT * N <= THREADS,
                "N a power of 2, at most 16");
  extern __shared__ __align__(16) float smem[];
  float* const shist = smem;                    // [tt][n][thread]
  float* const sb = shist + TT * N * THREADS;   // [tt][n]
  float* const sc = sb + TT * N;
  float* const swarp = sc + TT * N;             // [tt][warp][2N]

  const int b = blockIdx.y, blk = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int d = blk * THREADS + tid;
  const bool live = d < DI;
  const int nc = (L + TT - 1) / TT;
  const size_t xb = (size_t)b * L * DI + d;   // x[b, t, d] = xb + t DI
  const size_t nb = (size_t)b * L * N;        // B_t[b, t, n] = nb + t N + n
  const size_t hrow = ((size_t)b * DI + d) * N;
  // saved state c of this thread: N floats, state n at n * THREADS
  float* const my_chk =
      chk + ((size_t)b * gridDim.x + blk) * nc * N * THREADS + tid;

  float al[N];  // A log2(e)
#pragma unroll
  for (int n = 0; n < N; ++n) al[n] = live ? a[(size_t)d * N + n] * LOG2E : 0.f;
  const float dsk = live ? dskip[d] : 0.f;

  // a tile's x, dt (and dy) in registers, and its B_t and C_t in shared
  // memory: fetch loads tile c into the next set of registers (this
  // thread's x, dt, dy and its element of B_t, C_t) while the current tile
  // is computed, install makes it the current one; the steps past L and
  // the channels past DI read as 0
  float xs[TT], dts[TT], dys[TT], nx[TT], ndt[TT], ndy[TT], nbv = 0.f,
      ncv = 0.f;
  auto fetch = [&](int c, bool all) {
    const int t0 = c * TT;
    if (tid < TT * N) {
      const bool on = t0 + tid / N < L;
      nbv = on ? bm[nb + (size_t)t0 * N + tid] : 0.f;
      ncv = on && all ? cm[nb + (size_t)t0 * N + tid] : 0.f;
    }
#pragma unroll
    for (int tt = 0; tt < TT; ++tt) {
      const bool on = live && t0 + tt < L;
      const size_t off = xb + (size_t)(t0 + tt) * DI;
      nx[tt] = on ? x[off] : 0.f;
      ndt[tt] = on ? dt[off] : 0.f;
      ndy[tt] = on && all ? dy[off] : 0.f;
    }
  };
  auto install = [&]() {
    if (tid < TT * N) {
      sb[tid] = nbv;
      sc[tid] = ncv;
    }
#pragma unroll
    for (int tt = 0; tt < TT; ++tt) {
      xs[tt] = nx[tt];
      dts[tt] = ndt[tt];
      dys[tt] = ndy[tt];
    }
  };
  // one step of the recurrence on this thread's states
  auto advance = [&](float (&h)[N], int tt) {
    const float dtx = dts[tt] * xs[tt];
#pragma unroll
    for (int n = 0; n < N; ++n)
      h[n] = fmaf(h[n], ex2(dts[tt] * al[n]), dtx * sb[tt * N + n]);
  };

  float h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) h[n] = live ? h_in[hrow + n] : 0.f;
  // sweep 1: forward from h0, saving the state before each tile
  if (nc > 1) fetch(0, false);
  for (int c = 0; c < nc; ++c) {
#pragma unroll
    for (int n = 0; n < N; ++n) my_chk[((size_t)c * N + n) * THREADS] = h[n];
    if (c + 1 == nc) break;  // the last tile's steps are not needed
    __syncthreads();         // the previous tile is consumed
    install();
    if (c + 2 < nc) fetch(c + 1, false);  // streams in under this tile
    __syncthreads();
#pragma unroll
    for (int tt = 0; tt < TT; ++tt) advance(h, tt);  // a whole tile
  }

  // sweep 2: back in time, tile by tile
  float g[N], da[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    g[n] = live ? dh[hrow + n] : 0.f;
    da[n] = 0.f;
  }
  float dd = 0.f;
  if (nc > 0) fetch(nc - 1, true);
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * TT, nt = min(TT, L - t0);
    __syncthreads();  // the previous tile's shared memory is consumed
    install();
    if (c > 0) fetch(c - 1, true);  // streams in under this tile
    __syncthreads();
    // the tile's states h_{t-1}, recomputed from the saved one; h ends as
    // the state after the tile's last step
#pragma unroll
    for (int n = 0; n < N; ++n) h[n] = my_chk[((size_t)c * N + n) * THREADS];
#pragma unroll
    for (int tt = 0; tt < TT; ++tt) {
      if (tt < nt) {  // nt is uniform across the block
#pragma unroll
        for (int n = 0; n < N; ++n) shist[(tt * N + n) * THREADS + tid] = h[n];
        advance(h, tt);
      }
    }
#pragma unroll
    for (int tt = TT - 1; tt >= 0; --tt) {
      if (tt < nt) {
        const float xv = xs[tt], dtv = dts[tt], dyv = dys[tt];
        const float dtx = dtv * xv;
        float col[N2], gb = 0.f, dec = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          g[n] = fmaf(dyv, sc[tt * N + n], g[n]);  // g_t
          const float hp = shist[(tt * N + n) * THREADS + tid];
          const float an = ex2(dtv * al[n]);
          const float gd = g[n] * hp * an;  // the gradient of dt_t A
          col[n] = g[n] * dtx;              // dB_t's term
          col[N + n] = dyv * h[n];          // dC_t's term (h = h_t)
          gb = fmaf(g[n], sb[tt * N + n], gb);
          dec = fmaf(gd, al[n], dec);
          da[n] = fmaf(gd, dtv, da[n]);
          g[n] *= an;
          h[n] = hp;                        // h_{t-1}: the next step's h_t
        }
        if (live) {
          const size_t off = xb + (size_t)(t0 + tt) * DI;
          dx[off] = fmaf(dsk, dyv, dtv * gb);
          ddt[off] = fmaf(dec, LN2, xv * gb);
        }
        dd = fmaf(dyv, xv, dd);
        // the warp's sums of the 2N terms; lane ends with term q
        int q = 0;
        halve<N2, 16>(col, lane, q);
        if ((lane & (32 / N2 - 1)) == 0)
          swarp[(tt * WARPS + warp) * N2 + q] = col[0];
      }
    }
    __syncthreads();  // the warps' sums are in place
    // the block's partial of dB_t and dC_t: the warps in a fixed order
    for (int e = tid; e < nt * N2; e += THREADS) {
      const int tt = e / N2, q = e - tt * N2;
      float acc = 0.f;
#pragma unroll
      for (int wp = 0; wp < WARPS; ++wp) acc += swarp[(tt * WARPS + wp) * N2 + q];
      part_bc[(((size_t)blk * B + b) * L + t0 + tt) * N2 + q] = acc;
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      dh0[hrow + n] = g[n];
      part_a[hrow + n] = da[n];
    }
    part_d[(size_t)b * DI + d] = dd;
  }
}

// The second pass, one output a thread, each a fixed-order sum: dB and dC
// over the channel blocks' partials, dA and dD over B
template <int N>
__global__ void mamba_bwd_sum_kernel(const float* __restrict__ part_bc,
                                     const float* __restrict__ part_a,
                                     const float* __restrict__ part_d,
                                     float* __restrict__ db,
                                     float* __restrict__ dc,
                                     float* __restrict__ da,
                                     float* __restrict__ dd, int B, int L,
                                     int DI, int blocks) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n_bc = (long long)B * L * 2 * N, n_a = (long long)DI * N;
  if (e < n_bc) {
    float acc = 0.f;
    for (int k = 0; k < blocks; ++k) acc += part_bc[(size_t)k * n_bc + e];
    const long long bt = e / (2 * N), q = e - bt * 2 * N;
    if (q < N)
      db[bt * N + q] = acc;
    else
      dc[bt * N + q - N] = acc;
  } else if (e < n_bc + n_a) {
    const long long i = e - n_bc;
    float acc = 0.f;
    for (int k = 0; k < B; ++k) acc += part_a[(size_t)k * n_a + i];
    da[i] = acc;
  } else if (e < n_bc + n_a + DI) {
    const long long i = e - n_bc - n_a;
    float acc = 0.f;
    for (int k = 0; k < B; ++k) acc += part_d[(size_t)k * DI + i];
    dd[i] = acc;
  }
}

template <int N>
cudaError_t launch(const float* x, const float* dt, const float* bm,
                   const float* cm, const float* a, const float* dskip,
                   const float* h_in, const float* dy, const float* dh,
                   float* dx, float* ddt, float* db, float* dc, float* da,
                   float* dd, float* dh0, float* chk, float* part_bc,
                   float* part_a, float* part_d, int B, int L, int DI,
                   cudaStream_t stream) {
  const int blocks = (DI + THREADS - 1) / THREADS;
  const size_t smem = smem_floats<N>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mamba_scan_bwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  mamba_scan_bwd_kernel<N><<<dim3(blocks, B), THREADS, smem, stream>>>(
      x, dt, bm, cm, a, dskip, h_in, dy, dh, dx, ddt, dh0, chk, part_bc,
      part_a, part_d, B, L, DI);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = (long long)B * L * 2 * N + (long long)DI * N + DI;
  mamba_bwd_sum_kernel<N><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      part_bc, part_a, part_d, db, dc, da, dd, B, L, DI, blocks);
  return cudaGetLastError();
}

}  // namespace

// The layout the wrapper allocates scratch for: which = 0, the steps
// between saved states (TT); 1, the channels of a block (THREADS).  The
// saved states take B ceil(di / THREADS) THREADS N ceil(L / TT) floats, the
// blocks' partials of dB and dC ceil(di / THREADS) B L 2N, of dA and dD
// B di N and B di.
extern "C" int mamba_scan_bwd_layout(int which) {
  return which == 0 ? TT : THREADS;
}

// Returns the launches' cudaError_t; cudaErrorInvalidValue for a state size
// N that is not instantiated (4: the reduced test configurations, 16:
// jamba).
extern "C" int mamba_scan_bwd_launch(
    const float* x, const float* dt, const float* bm, const float* cm,
    const float* a, const float* dskip, const float* h_in, const float* dy,
    const float* dh, float* dx, float* ddt, float* db, float* dc, float* da,
    float* dd, float* dh0, float* chk, float* part_bc, float* part_a,
    float* part_d, int B, int L, int DI, int N, cudaStream_t stream) {
  switch (N) {
    case 4:
      return launch<4>(x, dt, bm, cm, a, dskip, h_in, dy, dh, dx, ddt, db,
                       dc, da, dd, dh0, chk, part_bc, part_a, part_d, B, L,
                       DI, stream);
    case 16:
      return launch<16>(x, dt, bm, cm, a, dskip, h_in, dy, dh, dx, ddt, db,
                        dc, da, dd, dh0, chk, part_bc, part_a, part_d, B, L,
                        DI, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
