// K8: one whole Jacobi superstep of the ELL fixpoint (core/gsofa.py,
// backend "ell") in one launch.  For every source s and vertex v:
//
//   prop(u)     = u < src[s] && L[s,u] <= offset + n ? max(offset + u, L[s,u])
//                                                    : INT32_MAX
//   out[s,v]    = min(L[s,v], min over in-neighbours u of v of prop(u))
//   frontier    = prop_t(v) != prop_{t-1}(v)   (prop_{-1} = INT32_MAX)
//   edges[s]   += out_deg[v] over the frontier (int32, wrapping)
//   conv[s]     = it + 1 where row s has a frontier
//   *flag       = it + 1 where any row has one
//
// L is this superstep's labels and out the other buffer of the Jacobi pair:
// for it >= 1 it holds the previous superstep's labels, from which
// prop_{t-1} is read before the new label is stored over it.  The pad id of
// the in-neighbour table is n (any id >= min(src, n) reads as INF and is not
// loaded).
//
// Replaces no Pallas kernel: the reference relaxes ELL with jnp gathers
// (src/repro/core/gsofa.py::relax_ell), and the port did the same with one
// index_select and one minimum per neighbour slot, about 64 device ops a
// superstep, each moving a whole (S, n) int32 tensor.
//
// What bounds it on an H100: the labels' bytes, L read once and out read
// and written once (150 MB at S = 512, n = 24,576: 0.045 ms at 3.35 TB/s),
// and the issue of the gathers (S * n * K predicated loads).  The design:
//   * a block owns a tile of TV vertices and a group of sources; it stages
//     the tile's in-neighbour rows in shared memory once (transposed, padded
//     against bank conflicts) and walks its sources over them, so the table
//     is not read again per source;
//   * a warp takes 32 neighbouring vertices of one source row: L[s,v], out
//     and the stores coalesce, and the gathers of a stencil in nested
//     dissection order fall on a few lines of the same row, which stay in
//     L1 / L2 (a row is 4n bytes);
//   * a neighbour u >= src[s] is never loaded (its prop is INF), nor is the
//     previous label of a vertex v >= src[s] (its prop is INF both times);
//   * a row whose frontier was empty on the previous superstep is skipped
//     whole: its labels are then equal in both buffers and stay so, and its
//     counts do not move (conv[s] < it says so);
//   * per-source edge sums are reduced in the warp, then in shared memory,
//     one atomic per block and source.
// min and max are exact and the integer sums wrap as torch's int32 sums do,
// so the result is bitwise the plain version's (kernels/plain.py) whatever
// the order of the blocks.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int TV = 128;               // vertices per tile
constexpr int SEGS = TV / 32;         // warp-wide segments per tile
constexpr int TS = TV + 1;            // shared row stride (no bank conflicts)
constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_SG = 64;            // sources per block, at most
constexpr int MIN_SG = 4;             // ... and at least (when S allows)
constexpr int WAVES = 32;             // blocks per SM over the whole grid
constexpr int MAX_STAGED_K = 47 * 1024 / (TS * 4);  // table under 48 KB
constexpr unsigned FULL = 0xffffffffu;

template <bool STAGED>
__global__ void __launch_bounds__(THREADS)
ell_superstep_kernel(const int32_t* __restrict__ lab,
                     int32_t* __restrict__ out,
                     const int32_t* __restrict__ in_ell,
                     const int32_t* __restrict__ out_deg,
                     const int32_t* __restrict__ srcs, int32_t* edges,
                     int32_t* conv, int32_t* flag, int S, int n, int K,
                     int offset, int it, int sg) {
  extern __shared__ int32_t table[];  // [K][TS] in-neighbours, if STAGED
  __shared__ unsigned row_sum[MAX_SG];  // edge checks of the block's rows
  __shared__ int row_any[MAX_SG];      // whether a row has a frontier
  __shared__ int row_live[MAX_SG];     // whether a row is relaxed at all
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int v0 = blockIdx.x * TV;
  const int s0 = blockIdx.y * sg;
  const int ns = min(sg, S - s0);
  if (STAGED) {
    // coalesced over the tile's rows of in_ell, transposed into [k][v]
    const size_t base = static_cast<size_t>(v0) * K;
    for (int i = tid; i < TV * K; i += THREADS) {
      const int j = i / K, k = i - j * K;
      table[k * TS + j] = v0 + j < n ? in_ell[base + i] : n;
    }
  }
  for (int i = tid; i < ns; i += THREADS) {
    row_sum[i] = 0u;
    row_any[i] = 0;
    // conv[s] < it: no frontier on superstep it - 1, so none now either;
    // a block that races ahead writes it + 1 only to a row that is live
    row_live[i] = it == 0 || conv[s0 + i] >= it;
  }
  __syncthreads();
  const int lim = offset + n;         // a label above it is uninitialized
  for (int p = warp; p < ns * SEGS; p += WARPS) {
    const int i = p / SEGS;
    if (!row_live[i]) continue;       // warp-uniform
    const int s = s0 + i;
    const int j = (p - i * SEGS) * 32 + lane;
    const int v = v0 + j;
    const int src = __ldg(srcs + s);
    const int top = min(src, n);      // expandable ids: u < top
    const int32_t* row = lab + static_cast<size_t>(s) * n;
    int front = 0;
    unsigned deg = 0u;
    if (v < n) {
      const int32_t l = __ldg(row + v);
      int32_t cand = INT_MAX;
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        const int u = STAGED ? table[k * TS + j]
                             : __ldg(in_ell + static_cast<size_t>(v) * K + k);
        if (u < top) {
          const int32_t lu = __ldg(row + u);
          if (lu <= lim) cand = min(cand, max(offset + u, lu));
        }
      }
      int32_t* o = out + static_cast<size_t>(s) * n + v;
      if (v < top) {
        const int32_t cur = l <= lim ? max(offset + v, l) : INT_MAX;
        int32_t prev = INT_MAX;
        if (it > 0) {
          const int32_t lp = *o;
          prev = lp <= lim ? max(offset + v, lp) : INT_MAX;
        }
        front = cur != prev;
      }
      *o = min(l, cand);
      if (front) deg = static_cast<unsigned>(__ldg(out_deg + v));
    }
    if (__ballot_sync(FULL, front)) {  // warp-uniform
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) deg += __shfl_xor_sync(FULL, deg, d);
      if (lane == 0) {
        atomicAdd(&row_sum[i], deg);
        row_any[i] = 1;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < ns; i += THREADS) {
    if (row_any[i]) {
      if (row_sum[i])
        atomicAdd(reinterpret_cast<unsigned*>(edges) + s0 + i, row_sum[i]);
      conv[s0 + i] = it + 1;
      *flag = it + 1;
    }
  }
}

template <bool STAGED>
int launch(const void* lab, void* out, const void* in_ell,
           const void* out_deg, const void* srcs, void* edges, void* conv,
           void* flag, int S, int n, int K, int offset, int it,
           cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // sources are cut into groups so that the grid holds about WAVES blocks
  // an SM; a group has MIN_SG..MAX_SG sources, so a block's warps have
  // work and its counters fit in shared memory
  const int tiles = (n + TV - 1) / TV;
  const long long want = (static_cast<long long>(WAVES) * sms + tiles - 1)
                         / tiles;
  int sg = static_cast<int>((S + want - 1) / want);
  sg = max(min(MIN_SG, S), min(sg, MAX_SG));
  const int groups = (S + sg - 1) / sg;
  if (groups > 65535) return cudaErrorInvalidValue;
  const size_t smem = STAGED ? sizeof(int32_t) * K * TS : 0;
  ell_superstep_kernel<STAGED><<<dim3(tiles, groups), THREADS, smem, st>>>(
      static_cast<const int32_t*>(lab), static_cast<int32_t*>(out),
      static_cast<const int32_t*>(in_ell),
      static_cast<const int32_t*>(out_deg),
      static_cast<const int32_t*>(srcs), static_cast<int32_t*>(edges),
      static_cast<int32_t*>(conv), static_cast<int32_t*>(flag), S, n, K,
      offset, it, sg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// lab, out (S, n) int32; in_ell (n, K) int32, padded with n; out_deg (n,),
// srcs, edges, conv (S,) and flag (1,) int32; all contiguous on the current
// device, S, n, K >= 1, offset + n <= INT32_MAX.  out holds the previous
// superstep's labels when it >= 1 (anything when it == 0); edges, conv and
// flag are updated in place.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int ell_superstep_launch(const void* lab, void* out,
                                    const void* in_ell, const void* out_deg,
                                    const void* srcs, void* edges, void* conv,
                                    void* flag, int S, int n, int K,
                                    int offset, int it, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return K <= MAX_STAGED_K
             ? launch<true>(lab, out, in_ell, out_deg, srcs, edges, conv,
                            flag, S, n, K, offset, it, st)
             : launch<false>(lab, out, in_ell, out_deg, srcs, edges, conv,
                             flag, S, n, K, offset, it, st);
}
