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
// (2 x 8.4 MB, ~5 us).  What the design does about it:
//   * one MUFU.EX2 per (t, d, n): A is scaled by log2(e) once, when it is
//     loaded, and exp(dt A) is ex2.approx(dt A log2 e) (relative error
//     ~2^-22, far inside the 1e-4 the scan is held to), so an element is
//     FMUL, EX2, FMUL and two FFMA;
//   * a thread keeps CH = 2 channels' h[N] and A[d][:] in registers for the
//     whole sequence (blocks of 128 threads, 256 channels of one b; at
//     jamba's shape 512 blocks, all resident at once), so each B_t / C_t
//     float it reads from shared memory (as float4, a broadcast) serves two
//     elements;
//   * x, dt, B_t and C_t are copied TT steps at a time into shared memory
//     with cp.async, the next tile streaming in under the current one (x
//     and dt 16 bytes a copy when both are 16-byte aligned and di is a
//     multiple of 4, else 4); y_t[d] is written per step (coalesced), in
//     the reference's order: the sum over n, then D x;
//   * the block's slices of h_in, A and h_out (256 channels x N,
//     contiguous) go through shared memory (the tiles' memory, before and
//     after them) with coalesced loads and stores, rows padded to N + 1 so
//     each thread's own rows read without bank conflicts; read straight
//     into registers, each thread's N-float row would cost a warp
//     instruction one 32-byte sector per lane for 4 useful bytes.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 128;         // threads per block
constexpr int CH = 2;                // channels per thread
constexpr int BLOCK = THREADS * CH;  // channels per block
constexpr int TT = 8;                // time steps per tile
constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the special function unit
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 4 consecutive floats of shared memory, 16-byte aligned: one load
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
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

template <int N>
__global__ void __launch_bounds__(THREADS) mamba_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ a, const float* __restrict__ dskip,
    const float* h_in, float* __restrict__ y, float* h_out, int L, int DI) {
  static_assert(N % 4 == 0, "N must be a multiple of 4");
  constexpr int HP = N + 1;  // a padded row of the staged state and A
  // one tile: x and dt (TT, BLOCK), then B_t and C_t (TT, N)
  constexpr int TILE = 2 * TT * BLOCK + 2 * TT * N;
  constexpr int STATE = 2 * BLOCK * HP;  // the state's and A's rows
  // the state goes in and out through the same memory as the tiles
  __shared__ __align__(16) float smem[STATE > 2 * TILE ? STATE : 2 * TILE];
  float* sh = smem;
  float* sa = smem + BLOCK * HP;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * BLOCK;  // thread t: channels d0 + t + THREADS c
  // the block's slice of the state and of A: nlive contiguous floats
  const int nlive = min(BLOCK, DI - d0) * N;
  const size_t hoff = ((size_t)b * DI + d0) * N;

  for (int e = threadIdx.x; e < BLOCK * N; e += THREADS) {
    const bool on = e < nlive;
    sh[(e / N) * HP + e % N] = on ? h_in[hoff + e] : 0.f;
    sa[(e / N) * HP + e % N] = on ? a[(size_t)d0 * N + e] : 0.f;
  }
  __syncthreads();
  float h[CH][N], an[CH][N], dsk[CH];
  bool live[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int row = threadIdx.x + THREADS * c;
    live[c] = d0 + row < DI;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      h[c][n] = sh[row * HP + n];
      an[c][n] = sa[row * HP + n] * LOG2E;
    }
    dsk[c] = live[c] ? dskip[d0 + row] : 0.f;
  }
  __syncthreads();  // the rows are read before the tiles overwrite them

  const size_t xb = (size_t)b * L * DI + d0;  // x[b, t, d0 + i] = xb + t DI + i
  const size_t nb = (size_t)b * L * N;        // B_t[b, t, n] = nb + t N + n
  const int tiles = (L + TT - 1) / TT;
  // tile -> buffer tile % 2, copied asynchronously, one group per tile;
  // x and dt 16 bytes a copy when both are 16-byte aligned and di is a
  // multiple of 4 (this thread: channels 4 j4 .. 4 j4 + 3 of the steps
  // threadIdx.x / (BLOCK / 4) + 2 q), else 4 (its own channels); the steps
  // past L and the channels past DI are not copied (and not read)
  const unsigned s0 = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const bool wide = aligned16(x, dt) && DI % 4 == 0;
  const int live_ch = min(BLOCK, DI - d0);
  const int j4 = 4 * (threadIdx.x % (BLOCK / 4));
  auto stage = [&](int tile) {
    const int t0 = tile * TT;
    const unsigned xs = s0 + (tile & 1) * TILE * 4;
    if (wide) {
      for (int tt = threadIdx.x / (BLOCK / 4); tt < TT;
           tt += THREADS / (BLOCK / 4)) {
        if (t0 + tt < L && j4 < live_ch) {
          const int e = tt * BLOCK + j4;
          const size_t off = xb + (size_t)(t0 + tt) * DI + j4;
          cp_async16(xs + e * 4, x + off);
          cp_async16(xs + (TT * BLOCK + e) * 4, dt + off);
        }
      }
    } else {
#pragma unroll
      for (int tt = 0; tt < TT; ++tt) {
        if (t0 + tt < L) {
#pragma unroll
          for (int c = 0; c < CH; ++c) {
            if (live[c]) {
              const int e = tt * BLOCK + threadIdx.x + THREADS * c;
              const size_t off = xb + (size_t)(t0 + tt) * DI + threadIdx.x +
                                 THREADS * c;
              cp_async4(xs + e * 4, x + off);
              cp_async4(xs + (TT * BLOCK + e) * 4, dt + off);
            }
          }
        }
      }
    }
    for (int e = threadIdx.x; e < TT * N; e += THREADS) {
      if (t0 + e / N < L) {
        const size_t off = nb + (size_t)t0 * N + e;
        cp_async4(xs + (2 * TT * BLOCK + e) * 4, bm + off);
        cp_async4(xs + (2 * TT * BLOCK + TT * N + e) * 4, cm + off);
      }
    }
    cp_async_commit();
  };
  if (tiles > 0) stage(0);
  for (int tile = 0; tile < tiles; ++tile) {
    const int t0 = tile * TT, nt = min(TT, L - t0);
    if (tile + 1 < tiles) {  // the next tile streams in under this one
      stage(tile + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* xs = smem + (tile & 1) * TILE;
    const float* ds = xs + TT * BLOCK;
    const float* sb = xs + 2 * TT * BLOCK;
    const float* sc = sb + TT * N;
#pragma unroll
    for (int tt = 0; tt < TT; ++tt) {
      if (tt >= nt) break;  // nt is uniform across the block
      float xv[CH], dv[CH], dtx[CH], acc[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        xv[c] = xs[tt * BLOCK + threadIdx.x + THREADS * c];
        dv[c] = ds[tt * BLOCK + threadIdx.x + THREADS * c];
        dtx[c] = dv[c] * xv[c];
        acc[c] = 0.f;
      }
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 bq = lds4(sb + tt * N + 4 * q),
                     cq = lds4(sc + tt * N + 4 * q);
        const float bn[4] = {bq.x, bq.y, bq.z, bq.w};
        const float cn[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int c = 0; c < CH; ++c) {
            float& hn = h[c][4 * q + e];
            hn = fmaf(hn, ex2(dv[c] * an[c][4 * q + e]), dtx[c] * bn[e]);
            acc[c] = fmaf(hn, cn[e], acc[c]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (live[c]) {
          y[xb + (size_t)(t0 + tt) * DI + threadIdx.x + THREADS * c] =
              fmaf(dsk[c], xv[c], acc[c]);
        }
      }
    }
    __syncthreads();  // this buffer is consumed before it is refilled
  }

  // each thread writes its own rows, then the slice goes out coalesced
#pragma unroll
  for (int c = 0; c < CH; ++c) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      sh[(threadIdx.x + THREADS * c) * HP + n] = h[c][n];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nlive; e += THREADS) {
    h_out[hoff + e] = sh[(e / N) * HP + e % N];
  }
}

template <int N>
cudaError_t launch(const float* x, const float* dt, const float* bm,
                   const float* cm, const float* a, const float* dskip,
                   const float* h_in, float* y, float* h_out, int B, int L,
                   int DI, cudaStream_t stream) {
  const dim3 grid((DI + BLOCK - 1) / BLOCK, B);
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
