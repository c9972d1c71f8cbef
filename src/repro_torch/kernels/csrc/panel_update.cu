// K3/K4: supernodal panel update, one kernel body in two addressings.
//
//   acc <- acc - L @ U        (M, N) = (M, N) - (M, K) @ (K, N)
//
// K3 replaces src/repro/kernels/panel_update.py::panel_update_pallas; K4
// replaces panel_update_batched_pallas, the vmap of K3 over a stack of
// same-shape panels.  Both reach the card in two forms of one body:
//   * dense (panel_update_kernel): acc, L and U are contiguous row-major
//     arrays, the result goes to a new array; one panel (K3) or a stack of
//     B same-shape panels (K4, the stack index folded into blockIdx.x);
//   * mapped (panel_update_mapped_kernel), the panel sweep's: ONE launch
//     updates a whole dependency level's ragged set of slices in place in
//     the packed float64 store `flat`.  Slice j's acc is the (M, N)
//     row-major run at flat + acc_off (panel j's rows at and below its
//     diagonal block); its L entry (i, k) is flat[lmap[map_off + i*K + k]],
//     read in place from the ancestor panels' blocks, -1 reading as an
//     exact 0.0 (a structural zero), so L is never assembled; U is the
//     (K, N) row-major run at u + u_off - u_shift (the solved U rows of the
//     level, one buffer).  A launch over one slice is K3's role.  The
//     batched tier (many value sets on one plan) launches it over a system
//     axis: grid (n_tiles, systems), block (t, s) runs tile record t of
//     system s with flat + s * flat_stride as that system's store and
//     u + s * u_stride as its U buffer.  The tile records and lmap are the
//     plan's and shared by every system; offsets stay int32 within a
//     system (flat_stride < 2^31) and only the system offset is 64-bit.
//     A one-system launch is the grid (n_tiles, 1).
//
// Arithmetic, identical in every form and instance: each output element is
// owned by one thread, which reads acc once, runs sum = 0, then one
// round-to-nearest FMA (__fma_rn / __fmaf_rn) per k in ascending k over K
// rounded up to a multiple of 16 (zero terms past K, as the 16-deep steps
// of the first version of this kernel did: a -0 sum becomes +0 there), and
// writes acc - sum (__dsub_rn / __fsub_rn).  So every K4 slice is bitwise
// K3, the mapped update is bitwise the dense one on gathered operands, the
// tile shape never changes a result, and each system of a multi-system
// launch is bitwise the one-system launch on that system alone (the same
// per-tile code on the system's own base pointers).  The float32 instance of the
// mapped form loads float64, rounds each of acc, L and U once with
// __double2float_rn (what `.float()` does), runs the float32 chain and
// stores the widened result.  No TF32: the contract is true fp32 / fp64.
//
// What bounds it on an H100: at the sweep's shapes (bbd-20k: M <= ~30,
// N <= 16, K mostly <= 16, up to ~10^3 for the border panels) a level's
// L, U and acc are well under a megabyte, microseconds of bytes at
// 3.35 TB/s, so the launch and the K chain's dependent loads (lmap, then
// flat) bound it.  The design:
//   * 128 threads a block, at most one output each, the tile TR x TC = 128
//     with TC the power of two >= N in [4, 64] (so TR <= 32), so a slice
//     of 9 x 1 outputs takes one block;
//   * L and U are staged through shared memory one K chunk at a time, all
//     of a chunk's loads unrolled and issued before any is used, so a
//     chunk costs two memory round trips, not two per k;
//   * small tiles (K <= 16) stage 16-deep chunks; large tiles (the border
//     panels) 32-deep chunks with TC <= 32, so a 500-deep chain costs 16
//     round trips, not 32.  At most 16 staged values a thread keep the
//     kernel near 128 registers, 4 blocks an SM: a level of ~1700 tiles
//     takes about 3 waves (64-deep chunks or 128-row tiles need ~240
//     registers, 2 blocks an SM, and double the level's time: PERF.md);
//   * the mapped form reads its tile's record (offsets, shape, m0, n0,
//     TC, BK) from a static per-plan table: one block per tile, no
//     pointers, so a factorization on a fresh store reuses the tables.
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
// a stored element in the compute type: float64 -> float32 rounds once
__device__ __forceinline__ void cvt(double x, double& y) { y = x; }
__device__ __forceinline__ void cvt(double x, float& y) {
  y = __double2float_rn(x);
}

constexpr int THREADS = 128;  // one output element per thread
constexpr int KPAD = 16;      // the chain runs over K rounded up to this
// the two tile kinds, (BK, least TC, largest TC); TR = THREADS / TC, and
// ops.py::panel_tile picks one per slice
constexpr int SMALL_BK = 16, SMALL_TC_MIN = 4, SMALL_TC_MAX = 64;
constexpr int LARGE_BK = 32, LARGE_TC_MIN = 4, LARGE_TC_MAX = 32;
// sL [BK][TR + 1] and sU [BK][TC]: largest at an end of the TC range
constexpr int stage_elems(int bk, int tc) {
  return bk * (THREADS / tc + 1) + bk * tc;
}
constexpr int max2(int a, int b) { return a > b ? a : b; }
constexpr int SMEM = max2(max2(stage_elems(SMALL_BK, SMALL_TC_MIN),
                                stage_elems(SMALL_BK, SMALL_TC_MAX)),
                           max2(stage_elems(LARGE_BK, LARGE_TC_MIN),
                                stage_elems(LARGE_BK, LARGE_TC_MAX)));
// a mapped tile record: acc_off, map_off, u_off, M, N, K, m0, n0, TC, BK
constexpr int TILE_INTS = 10;

// dense addressing: row-major acc (M, N), L (M, K), U (K, N), out (M, N)
template <typename T>
struct Dense {
  const T* acc_p;
  const T* L;
  const T* U;
  T* out;
  int M, N, K;
  __device__ T l(int m, int k) const {
    return L[static_cast<size_t>(m) * K + k];
  }
  __device__ T u(int k, int n) const {
    return U[static_cast<size_t>(k) * N + n];
  }
  __device__ T acc(int m, int n) const {
    return acc_p[static_cast<size_t>(m) * N + n];
  }
  __device__ void store(int m, int n, T v) const {
    out[static_cast<size_t>(m) * N + n] = v;
  }
};

// mapped addressing into the float64 store, computing in T; acc is
// updated in place, so flat is not __restrict__
template <typename T>
struct Mapped {
  const double* flat;
  double* acc_p;
  const int* lmap;
  const double* U;
  int M, N, K;
  __device__ T l(int m, int k) const {
    const int i = lmap[static_cast<size_t>(m) * K + k];
    T v = T(0);
    if (i >= 0) cvt(flat[i], v);
    return v;
  }
  __device__ T u(int k, int n) const {
    T v;
    cvt(U[static_cast<size_t>(k) * N + n], v);
    return v;
  }
  __device__ T acc(int m, int n) const {
    T v;
    cvt(acc_p[static_cast<size_t>(m) * N + n], v);
    return v;
  }
  __device__ void store(int m, int n, T v) const {
    acc_p[static_cast<size_t>(m) * N + n] = static_cast<double>(v);
  }
};

// One TR x TC output tile at (m0, n0) of one slice, TR = THREADS / tc.
template <typename T, int BK, int TC_MIN, int TC_MAX, class Src>
__device__ __forceinline__ void update_tile(const Src& src, int m0, int n0,
                                            int tc, T* smem) {
  constexpr int MAX_TR = THREADS / TC_MIN;
  constexpr int MAX_TC = TC_MAX;
  constexpr int L_LOADS = BK * MAX_TR / THREADS;
  constexpr int U_LOADS = BK * MAX_TC / THREADS;
  static_assert(L_LOADS * THREADS == BK * MAX_TR, "L chunk split");
  static_assert(U_LOADS * THREADS == BK * MAX_TC, "U chunk split");
  const int M = src.M, N = src.N, K = src.K;
  const int tr = THREADS / tc;
  const int tid = threadIdx.x;
  const int r = tid / tc;
  const int c = tid - r * tc;
  const int m = m0 + r;
  const int n = n0 + c;
  const bool own = m < M && n < N;
  T a = T(0);
  if (own) a = src.acc(m, n);  // read once, before the chain
  T* sL = smem;                // sL[k * (tr + 1) + row]
  T* sU = smem + BK * (tr + 1);  // sU[k * tc + col]
  const int kpad = (K + KPAD - 1) / KPAD * KPAD;
  T sum = T(0);
  for (int k0 = 0; k0 < kpad; k0 += BK) {
    T lv[L_LOADS];
    T uv[U_LOADS];
    // every load of the chunk first (consecutive threads walk k, the
    // contiguous axis of L and of lmap), then the shared stores
#pragma unroll
    for (int i = 0; i < L_LOADS; ++i) {
      const int e = i * THREADS + tid;
      const int rr = e / BK;
      const int k = k0 + e % BK;
      lv[i] = (rr < tr && m0 + rr < M && k < K) ? src.l(m0 + rr, k) : T(0);
    }
#pragma unroll
    for (int i = 0; i < U_LOADS; ++i) {
      const int e = i * THREADS + tid;
      const int kk = e / tc;
      const int cc = e - kk * tc;
      const int k = k0 + kk;
      uv[i] = (kk < BK && k < K && n0 + cc < N) ? src.u(k, n0 + cc) : T(0);
    }
#pragma unroll
    for (int i = 0; i < L_LOADS; ++i) {
      const int e = i * THREADS + tid;
      const int rr = e / BK;
      if (rr < tr) sL[(e % BK) * (tr + 1) + rr] = lv[i];
    }
#pragma unroll
    for (int i = 0; i < U_LOADS; ++i) {
      const int e = i * THREADS + tid;
      if (e < BK * tc) sU[e] = uv[i];
    }
    __syncthreads();
    const int kn = min(BK, kpad - k0);  // a multiple of KPAD
    for (int kk = 0; kk < kn; kk += KPAD) {
#pragma unroll
      for (int q = 0; q < KPAD; ++q)
        sum = fma_rn(sL[(kk + q) * (tr + 1) + r], sU[(kk + q) * tc + c], sum);
    }
    __syncthreads();
  }
  if (own) src.store(m, n, sub_rn(a, sum));
}

template <typename T, class Src>
__device__ __forceinline__ void run_tile(const Src& src, int m0, int n0,
                                         int tc, int bk, T* smem) {
  if (bk == LARGE_BK)
    update_tile<T, LARGE_BK, LARGE_TC_MIN, LARGE_TC_MAX>(src, m0, n0, tc,
                                                         smem);
  else
    update_tile<T, SMALL_BK, SMALL_TC_MIN, SMALL_TC_MAX>(src, m0, n0, tc,
                                                         smem);
}

// dense K3 (Batched = false, one slice) and K4 (a stack of B slices);
// tiles_m x tiles_n blocks per slice.  The two instantiations keep
// distinct names, so a profiler trace tells them apart.
template <typename T, bool Batched>
__global__ void __launch_bounds__(THREADS)
panel_update_kernel(const T* __restrict__ acc, const T* __restrict__ L,
                    const T* __restrict__ U, T* __restrict__ out, int M,
                    int N, int K, int tc, int bk, int tiles_n,
                    int tiles_per_slice) {
  __shared__ T smem[SMEM];
  const int b = Batched ? blockIdx.x / tiles_per_slice : 0;
  const int t = blockIdx.x - b * tiles_per_slice;
  const size_t sb = b;
  const Dense<T> src{acc + sb * M * N, L + sb * M * K, U + sb * K * N,
                     out + sb * M * N, M, N, K};
  run_tile<T>(src, (t / tiles_n) * (THREADS / tc), (t % tiles_n) * tc, tc,
              bk, smem);
}

// the sweep's form: one block per (tile record, system), in place in the
// system's run of flat
template <typename T>
__global__ void __launch_bounds__(THREADS)
panel_update_mapped_kernel(double* flat, const double* U,
                           const int* __restrict__ lmap,
                           const int* __restrict__ tiles, int u_shift,
                           long long flat_stride, long long u_stride) {
  __shared__ T smem[SMEM];
  const int* t = tiles + static_cast<size_t>(blockIdx.x) * TILE_INTS;
  flat += static_cast<long long>(blockIdx.y) * flat_stride;
  U += static_cast<long long>(blockIdx.y) * u_stride;
  const Mapped<T> src{flat, flat + t[0], lmap + t[1], U + (t[2] - u_shift),
                      t[3], t[4], t[5]};
  run_tile<T>(src, t[6], t[7], t[8], t[9], smem);
}

// nothing: the device time of a launch of this many blocks (the floor
// under the small shapes' times)
__global__ void __launch_bounds__(THREADS) panel_update_empty_kernel() {}

bool tile_ok(int tc, int bk) {
  if (tc < 1 || (tc & (tc - 1)) != 0) return false;
  if (bk == SMALL_BK) return tc >= SMALL_TC_MIN && tc <= SMALL_TC_MAX;
  if (bk == LARGE_BK) return tc >= LARGE_TC_MIN && tc <= LARGE_TC_MAX;
  return false;
}

template <typename T>
int launch(const void* acc, const void* L, const void* U, void* out, int B,
           int M, int N, int K, int tc, int bk, int batched,
           cudaStream_t st) {
  if (!tile_ok(tc, bk) || (!batched && B != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tr = THREADS / tc;
  const long long tiles_n = (N + tc - 1) / tc;
  const long long per = tiles_n * ((M + tr - 1) / tr);
  if (per * B > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(per * B));
  const T* a = static_cast<const T*>(acc);
  const T* l = static_cast<const T*>(L);
  const T* u = static_cast<const T*>(U);
  T* o = static_cast<T*>(out);
  if (batched)
    panel_update_kernel<T, true><<<grid, THREADS, 0, st>>>(
        a, l, u, o, M, N, K, tc, bk, static_cast<int>(tiles_n),
        static_cast<int>(per));
  else
    panel_update_kernel<T, false><<<grid, THREADS, 0, st>>>(
        a, l, u, o, M, N, K, tc, bk, static_cast<int>(tiles_n),
        static_cast<int>(per));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dense K3/K4: acc/out (B, M, N), L (B, M, K), U (B, K, N), contiguous on
// the current device, all float32 (f64 = 0) or all float64 (f64 = 1);
// M, N, K >= 1; (tc, bk) the tile of ops.py::panel_tile.  batched = 0
// launches the per-panel instantiation (B must be 1), otherwise the
// stacked one over B slices.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int panel_update_launch(const void* acc, const void* L,
                                   const void* U, void* out, int B, int M,
                                   int N, int K, int tc, int bk, int batched,
                                   int f64, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f64)
    return launch<double>(acc, L, U, out, B, M, N, K, tc, bk, batched, st);
  return launch<float>(acc, L, U, out, B, M, N, K, tc, bk, batched, st);
}

// Mapped K3/K4 in place over `systems` stores: system s's float64 store is
// the run of flat_stride (< 2^31) entries at flat + s * flat_stride, its
// float64 U buffer the run at u + s * u_stride; lmap the int32 L map and
// tiles n_tiles int32 records of TILE_INTS, shared by every system;
// 1 <= systems <= 65535 (gridDim.y); f32 = 1 computes in float32 (the
// kernel backend).
extern "C" int panel_update_mapped_launch(void* flat, const void* u,
                                          const void* lmap, const void* tiles,
                                          int n_tiles, int u_shift, int f32,
                                          int systems, long long flat_stride,
                                          long long u_stride, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_tiles < 1 || systems < 1 || systems > 65535 || flat_stride < 0 ||
      flat_stride > 0x7fffffffLL || u_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  double* f = static_cast<double*>(flat);
  const double* uu = static_cast<const double*>(u);
  const int* lm = static_cast<const int*>(lmap);
  const int* t = static_cast<const int*>(tiles);
  const dim3 grid(static_cast<unsigned>(n_tiles),
                  static_cast<unsigned>(systems));
  if (f32)
    panel_update_mapped_kernel<float><<<grid, THREADS, 0, st>>>(
        f, uu, lm, t, u_shift, flat_stride, u_stride);
  else
    panel_update_mapped_kernel<double><<<grid, THREADS, 0, st>>>(
        f, uu, lm, t, u_shift, flat_stride, u_stride);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel over `blocks` blocks of THREADS threads.
extern "C" int panel_update_empty_launch(int blocks, void* stream) {
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  panel_update_empty_kernel<<<blocks, THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
