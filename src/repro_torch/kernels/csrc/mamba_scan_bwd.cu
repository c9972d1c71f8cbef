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
// dx, ddt, dB, dC (~1.3 GB, 0.40 ms at 3.35 TB/s); with the forward sweep's
// second read of x and dt and the saved states written and read, it moves
// ~2.9 GB (0.88 ms).  It computes exp(dt A) per (t, d, n) in each of its
// three passes: 3.2e9 exponentials, 0.77-0.86 ms at the special function
// units' 16 a clock an SM.  The decay varies per (d, n), so there is no
// matrix form: the work stays on the CUDA cores, ~26 instructions per
// (t, d, n) over the three passes (11 in the walk's own arithmetic, 4 of
// warp sums), 0.9 ms of issue; what holds it back is issue and latency at
// 8 warps an SM, not the shared memory pipe (tools/kernel_variants.py
// k6bwd).  The design:
//   * h is never un-stepped (dividing by a_t blows up where it underflows).
//     A first sweep runs the recurrence forward from h0 and saves h every
//     TT steps into a scratch buffer (B di N L/TT floats, 537 MB at the
//     train shape); the walk back takes the tiles in reverse, recomputes
//     each tile's states h_{t-1} from its saved state into shared memory
//     and keeps h_t in registers as it walks; the next tile's saved state
//     is loaded during the walk, into the registers its first steps free
//     (two blocks an SM, 8 warps);
//   * a thread owns two channels (c and c + 64 of a block's 128) and, at
//     N = 16, half of their states (two threads a channel pair, adjacent
//     lanes): the tile's states are stored and read back as 16-byte words,
//     each thread's own, and B_t, C_t are 16-byte broadcasts, so the walk
//     takes under one shared-memory instruction per (t, d, n);
//   * dB_t and dC_t sum over all di channels: a thread first adds its two
//     channels' terms in registers, so the halving shuffles over the warp
//     (each exchange halves the values a lane holds) run once for two
//     channels; the 4 warps' sums are added in shared memory in a fixed
//     order into a partial per block, and a second kernel adds the blocks'
//     partials in a fixed order; dA and dD are partials per b, added over
//     B by that kernel.  No atomics, so two calls on the same inputs agree
//     bitwise;
//   * each thread loads x, dt, dy of one of its channels (coalesced, a
//     tile ahead, into registers) and trades them with its neighbour lane
//     at each step; g . B_t and the decay's sum over n are added across
//     the two lanes of a pair, each keeping its own channel's, which it
//     writes;
//   * A scaled by log2(e) once, and exp as one ex2.approx (as the forward).
#include <cuda_runtime.h>

namespace {

constexpr int CPB = 128;      // channels a block: c * (CPB / 2) + pair
constexpr int TT = 8;         // steps per tile, and between saved states
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// a state size's layout: NS threads share a channel pair's N states
template <int N>
struct Cfg {
  static constexpr int NS = N >= 8 ? 2 : 1;
  static constexpr int NPT = N / NS;            // states a thread a channel
  static constexpr int NQ = NPT / 4;            // 16-byte words of them
  static constexpr int THREADS = CPB / 2 * NS;  // two channels a thread
  static constexpr int WARPS = THREADS / 32;
  static constexpr int N2 = 2 * N;              // dB_t and dC_t together
  // shared memory in floats: the tile's states [tt][q][c][thread] (16-byte
  // words), B_t and C_t [tt][n] each, the warps' sums [tt][warp][2N]
  static constexpr int HIST = TT * NQ * 2 * THREADS * 4;
  static constexpr int FLOATS = HIST + 2 * TT * N + TT * WARPS * N2;
};

// 2^x on the special function unit
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float at4(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Sums v[0 .. W) over the lanes that differ in the bits M, M / 2, .., LO
// of the lane index: while more than one value is left, each exchange
// halves the values a lane holds (the lanes with bit M set keep the upper
// half), then the lanes add what they hold.  v[0] ends as the sum of value
// idx (idx accumulates the kept halves' offsets).  The widths are template
// arguments, so every loop unrolls and v stays in registers.
template <int W, int M, int LO>
__device__ __forceinline__ void halve(float* v, int lane, int& idx) {
  if constexpr (M >= LO) {
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
      halve<H, M / 2, LO>(v, lane, idx);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], M);
      halve<1, M / 2, LO>(v, lane, idx);
    }
  }
}

template <int N>
__global__ void __launch_bounds__(Cfg<N>::THREADS, 2) mamba_scan_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ a, const float* __restrict__ dskip,
    const float* __restrict__ h_in, const float* __restrict__ dy,
    const float* __restrict__ dh, float* __restrict__ dx,
    float* __restrict__ ddt, float* __restrict__ dh0,
    float* __restrict__ chk, float* __restrict__ part_bc,
    float* __restrict__ part_a, float* __restrict__ part_d, int B, int L,
    int DI) {
  using G = Cfg<N>;
  constexpr int NS = G::NS, NPT = G::NPT, NQ = G::NQ, THREADS = G::THREADS;
  constexpr int WARPS = G::WARPS, N2 = G::N2;
  constexpr int W0 = 2 * NPT;  // a thread's dB_t, dC_t terms
  // the lanes that end a warp's sums with the same value: the pair lanes
  // of N = 4 (NS = 1) hold duplicates, the two halves at N = 16 do not
  constexpr int DUP = (32 / W0 - 1) & ~(NS - 1);
  static_assert(NPT % 4 == 0 && W0 <= 32 && TT * N <= 2 * THREADS,
                "N = 4 or 16");
  extern __shared__ __align__(16) float smem[];
  float4* const hist = reinterpret_cast<float4*>(smem);  // [tt][q][c][tid]
  float* const sb = smem + G::HIST;                      // [tt][n]
  float* const sc = sb + TT * N;
  float* const swarp = sc + TT * N;                      // [tt][warp][2N]

  const int b = blockIdx.y, blk = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int half = NS == 2 ? (tid & 1) : 0;  // which states of the pair
  const int pr = tid / NS;                   // the channel pair
  const int nb = half * NPT;                 // this thread's first state
  int d[2];
  bool live[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    d[c] = blk * CPB + c * (CPB / 2) + pr;
    live[c] = d[c] < DI;
  }
  // the channel whose x, dt, dy this thread loads and whose dx, ddt, dD
  // it writes: at N = 16 the pair's lane 0 takes c = 0, lane 1 c = 1
  const int own = half;
  const int nc = (L + TT - 1) / TT;
  const size_t nbase = (size_t)b * L * N;    // B_t[b, t, n] = nbase + t N + n
  // saved state cc of this thread: [cc][q][c] 16-byte words, at tid
  float4* const my_chk = reinterpret_cast<float4*>(chk) +
                         ((size_t)b * gridDim.x + blk) * nc * NQ * 2 *
                             THREADS + tid;

  float al[2][NPT];  // A log2(e)
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int j = 0; j < NPT; ++j)
      al[c][j] = live[c] ? a[(size_t)d[c] * N + nb + j] * LOG2E : 0.f;

  // a tile's x, dt, dy in registers (each thread one channel's, two at
  // N = 4), and B_t, C_t in shared memory: fetch loads tile cc into the
  // next registers while the current tile is computed, install makes it
  // the current one; the steps past L and the channels past DI read as 0
  constexpr int OWN = NS == 2 ? 1 : 2;       // channels a thread loads
  float xs[OWN][TT], dts[OWN][TT], dys[OWN][TT];
  float nx[OWN][TT], ndt[OWN][TT], ndy[OWN][TT];
  float nbv[2] = {0.f, 0.f}, ncv[2] = {0.f, 0.f};
  auto load_c = [&](int k) { return OWN == 1 ? own : k; };
  auto fetch = [&](int cc, bool all) {
    const int t0 = cc * TT;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int e = tid + r * THREADS;
      if (e < TT * N) {
        const bool on = t0 + e / N < L;
        nbv[r] = on ? bm[nbase + (size_t)t0 * N + e] : 0.f;
        ncv[r] = on && all ? cm[nbase + (size_t)t0 * N + e] : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < OWN; ++k) {
      const int c = load_c(k);
#pragma unroll
      for (int tt = 0; tt < TT; ++tt) {
        const bool on = live[c] && t0 + tt < L;
        const size_t off = ((size_t)b * L + t0 + tt) * DI + d[c];
        nx[k][tt] = on ? x[off] : 0.f;
        ndt[k][tt] = on ? dt[off] : 0.f;
        ndy[k][tt] = on && all ? dy[off] : 0.f;
      }
    }
  };
  auto install = [&]() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int e = tid + r * THREADS;
      if (e < TT * N) {
        sb[e] = nbv[r];
        sc[e] = ncv[r];
      }
    }
#pragma unroll
    for (int k = 0; k < OWN; ++k)
#pragma unroll
      for (int tt = 0; tt < TT; ++tt) {
        xs[k][tt] = nx[k][tt];
        dts[k][tt] = ndt[k][tt];
        dys[k][tt] = ndy[k][tt];
      }
  };
  // step tt's x, dt, dy of channel c: the neighbour lane's channel by a
  // shuffle at N = 16
  auto step_vals = [&](int tt, float (&xv)[2], float (&dtv)[2],
                       float (&dyv)[2]) {
    if constexpr (OWN == 1) {
      const float px = __shfl_xor_sync(0xffffffffu, xs[0][tt], 1);
      const float pdt = __shfl_xor_sync(0xffffffffu, dts[0][tt], 1);
      const float pdy = __shfl_xor_sync(0xffffffffu, dys[0][tt], 1);
      xv[0] = own ? px : xs[0][tt];
      xv[1] = own ? xs[0][tt] : px;
      dtv[0] = own ? pdt : dts[0][tt];
      dtv[1] = own ? dts[0][tt] : pdt;
      dyv[0] = own ? pdy : dys[0][tt];
      dyv[1] = own ? dys[0][tt] : pdy;
    } else {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        xv[c] = xs[c][tt];
        dtv[c] = dts[c][tt];
        dyv[c] = dys[c][tt];
      }
    }
  };
  // one step of the recurrence on this thread's states; with keep, the
  // states before it are stored as the tile's history
  float h[2][NPT];
  auto advance = [&](int tt, bool keep) {
    float xv[2], dtv[2], dyv[2];
    step_vals(tt, xv, dtv, dyv);
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const float4 bq = *reinterpret_cast<const float4*>(sb + tt * N + nb +
                                                          4 * q);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (keep)
          hist[((tt * NQ + q) * 2 + c) * THREADS + tid] = make_float4(
              h[c][4 * q], h[c][4 * q + 1], h[c][4 * q + 2], h[c][4 * q + 3]);
        const float dtx = dtv[c] * xv[c];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * q + e;
          h[c][j] = fmaf(h[c][j], ex2(dtv[c] * al[c][j]), dtx * at4(bq, e));
        }
      }
    }
  };

#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int j = 0; j < NPT; ++j)
      h[c][j] = live[c] ? h_in[((size_t)b * DI + d[c]) * N + nb + j] : 0.f;
  // sweep 1: forward from h0, saving the state before each tile
  if (nc > 1) fetch(0, false);
  for (int cc = 0; cc < nc; ++cc) {
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        my_chk[((size_t)(cc * NQ + q) * 2 + c) * THREADS] = make_float4(
            h[c][4 * q], h[c][4 * q + 1], h[c][4 * q + 2], h[c][4 * q + 3]);
    if (cc + 1 == nc) break;  // the last tile's steps are not needed
    __syncthreads();          // the previous tile is consumed
    install();
    if (cc + 2 < nc) fetch(cc + 1, false);  // streams in under this tile
    __syncthreads();
#pragma unroll
    for (int tt = 0; tt < TT; ++tt) advance(tt, false);  // a whole tile
  }

  // sweep 2: back in time, tile by tile
  float g[2][NPT], da[2][NPT];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      g[c][j] = live[c] ? dh[((size_t)b * DI + d[c]) * N + nb + j] : 0.f;
      da[c][j] = 0.f;
    }
  float dd[OWN], dsk[OWN];
#pragma unroll
  for (int k = 0; k < OWN; ++k) {
    dd[k] = 0.f;
    dsk[k] = live[load_c(k)] ? dskip[d[load_c(k)]] : 0.f;
  }
  // the saved state of the tile walked next, loaded during this tile's
  // walk (its first steps free the registers it needs)
  float4 nh[NQ][2];
  auto load_saved = [&](int cc) {
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        nh[q][c] = my_chk[((size_t)(cc * NQ + q) * 2 + c) * THREADS];
  };
  if (nc > 0) {
    fetch(nc - 1, true);
    load_saved(nc - 1);
  }
  for (int cc = nc - 1; cc >= 0; --cc) {
    const int t0 = cc * TT, nt = min(TT, L - t0);
    __syncthreads();  // the previous tile's shared memory is consumed
    install();
    if (cc > 0) fetch(cc - 1, true);  // streams in under this tile
    __syncthreads();
    // the tile's states h_{t-1}, recomputed from the saved one into the
    // history; h ends as the state after the tile's last step
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        h[c][4 * q] = nh[q][c].x, h[c][4 * q + 1] = nh[q][c].y;
        h[c][4 * q + 2] = nh[q][c].z, h[c][4 * q + 3] = nh[q][c].w;
      }
#pragma unroll
    for (int tt = 0; tt < TT; ++tt)
      if (tt < nt) advance(tt, true);  // nt is uniform across the block
#pragma unroll
    for (int tt = TT - 1; tt >= 0; --tt) {
      if (tt == TT - 3 && cc > 0) load_saved(cc - 1);
      if (tt < nt) {
        float xv[2], dtv[2], dyv[2];
        step_vals(tt, xv, dtv, dyv);
        float col[W0], gb[2] = {0.f, 0.f}, dec[2] = {0.f, 0.f};
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int n0 = nb + 4 * q;
          const float4 bq = *reinterpret_cast<const float4*>(sb + tt * N + n0);
          const float4 cq = *reinterpret_cast<const float4*>(sc + tt * N + n0);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float4 hq = hist[((tt * NQ + q) * 2 + c) * THREADS + tid];
            const float dtx = dtv[c] * xv[c];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int j = 4 * q + e;
              float& gj = g[c][j];
              gj = fmaf(dyv[c], at4(cq, e), gj);           // g_t
              const float hp = at4(hq, e);                 // h_{t-1}
              const float an = ex2(dtv[c] * al[c][j]);
              const float gd = gj * hp * an;  // the gradient of dt_t A
              // dB_t's and dC_t's terms (h = h_t), the two channels added
              col[j] = c == 0 ? gj * dtx : fmaf(gj, dtx, col[j]);
              col[NPT + j] = c == 0 ? dyv[c] * h[c][j]
                                    : fmaf(dyv[c], h[c][j], col[NPT + j]);
              gb[c] = fmaf(gj, at4(bq, e), gb[c]);
              dec[c] = fmaf(gd, al[c][j], dec[c]);
              da[c][j] = fmaf(gd, dtv[c], da[c][j]);
              gj *= an;
              h[c][j] = hp;  // h_{t-1}: the next step's h_t
            }
          }
        }
        // g . B_t and the decay's sum over all N states: at N = 16 the
        // pair's lanes add their halves, each keeping its own channel's
        float gbo[2], deco[2];
        if constexpr (NS == 2) {
          const float gk = own ? gb[1] : gb[0], gs = own ? gb[0] : gb[1];
          const float dk = own ? dec[1] : dec[0], ds = own ? dec[0] : dec[1];
          gbo[0] = gk + __shfl_xor_sync(0xffffffffu, gs, 1);
          deco[0] = dk + __shfl_xor_sync(0xffffffffu, ds, 1);
        } else {
          gbo[0] = gb[0], gbo[1] = gb[1], deco[0] = dec[0], deco[1] = dec[1];
        }
#pragma unroll
        for (int k = 0; k < OWN; ++k) {
          const int c = load_c(k);
          if (live[c]) {
            const size_t off = ((size_t)b * L + t0 + tt) * DI + d[c];
            dx[off] = fmaf(dsk[k], dys[k][tt], dts[k][tt] * gbo[k]);
            ddt[off] = fmaf(deco[k], LN2, xs[k][tt] * gbo[k]);
          }
          dd[k] = fmaf(dys[k][tt], xs[k][tt], dd[k]);
        }
        // the warp's sums of the 2N terms; lane ends with term idx of its
        // half's
        int idx = 0;
        halve<W0, 16, NS>(col, lane, idx);
        if ((lane & DUP) == 0) {
          const int q = idx < NPT ? nb + idx : N + nb + idx - NPT;
          swarp[(tt * WARPS + warp) * N2 + q] = col[0];
        }
      }
    }
    __syncthreads();  // the warps' sums are in place
    // the block's partial of dB_t and dC_t: the warps in a fixed order
    for (int e = tid; e < nt * N2; e += THREADS) {
      const int tt = e / N2, q = e - tt * N2;
      float acc = 0.f;
#pragma unroll
      for (int wp = 0; wp < WARPS; ++wp)
        acc += swarp[(tt * WARPS + wp) * N2 + q];
      part_bc[(((size_t)blk * B + b) * L + t0 + tt) * N2 + q] = acc;
    }
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (!live[c]) continue;
    const size_t hrow = ((size_t)b * DI + d[c]) * N + nb;
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      dh0[hrow + j] = g[c][j];
      part_a[hrow + j] = da[c][j];
    }
  }
#pragma unroll
  for (int k = 0; k < OWN; ++k) {
    const int c = load_c(k);
    if (live[c]) part_d[(size_t)b * DI + d[c]] = dd[k];
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
  const int blocks = (DI + CPB - 1) / CPB;
  const size_t smem = Cfg<N>::FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mamba_scan_bwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  mamba_scan_bwd_kernel<N><<<dim3(blocks, B), Cfg<N>::THREADS, smem,
                              stream>>>(
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
// between saved states (TT); 1, the channels of a block (CPB).  The saved
// states take B ceil(di / CPB) CPB N ceil(L / TT) floats, the blocks'
// partials of dB and dC ceil(di / CPB) B L 2N, of dA and dD B di N and
// B di.
extern "C" int mamba_scan_bwd_layout(int which) {
  return which == 0 ? TT : CPB;
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
