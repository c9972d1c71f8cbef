// K1: bottleneck-semiring relaxation of one GSoFa superstep.
//
//   out[s, v] = min over u of (adj[u, v] != 0 ? prop[s, u] : INT32_MAX)
//
// Replaces src/repro/kernels/gsofa_relax.py::minmax_relax_pallas.
//
// What bounds it on an H100: the contraction is S*U*V masked mins on the
// integer pipes (no tensor-core form exists for (min, max)), so a dense
// adjacency makes it operation-bound; the bytes moved (prop, the uint8
// adjacency and the output, each once) are small beside that.  The design:
//   * a block owns a BS x BV output tile and keeps it in registers
//     (TS x TV outputs per thread) while the contraction axis streams
//     through shared memory in BU-row steps;
//   * the adjacency tile is staged as a select mask (INT32_MIN for an edge,
//     INT32_MAX for none), so each masked min is min(acc, max(prop, mask)):
//     two integer instructions and no branch;
//   * an adjacency tile without a single edge contributes nothing to a min,
//     so the block skips its inner loop (__syncthreads_or over the staged
//     bytes).  GSoFa adjacencies are sparse, so most tiles are skipped;
//   * ragged edges are bounds-checked while staging (out-of-range u reads as
//     "no edge"), so nothing is padded in device memory.
// min is exact in any order, so the result is bitwise equal to the plain
// version in kernels/plain.py.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int BS = 32;        // sources per block tile
constexpr int BV = 128;       // vertices per block tile
constexpr int BU = 32;        // contraction rows staged per step
constexpr int THREADS = 256;  // 8 warps: warp w owns sources [4w, 4w + 4)
constexpr int TS = 4;         // sources per thread
constexpr int TV = 4;         // vertices per thread, strided by 32 lanes

__global__ void __launch_bounds__(THREADS)
minmax_relax_kernel(const int32_t* __restrict__ prop,
                    const uint8_t* __restrict__ adj,
                    int32_t* __restrict__ out, int S, int U, int V) {
  __shared__ int32_t sprop[BS][BU];
  __shared__ int32_t smask[BU][BV];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int s0 = blockIdx.y * BS;
  const int v0 = blockIdx.x * BV;

  int32_t acc[TS][TV];
#pragma unroll
  for (int i = 0; i < TS; ++i)
#pragma unroll
    for (int j = 0; j < TV; ++j) acc[i][j] = INT_MAX;

  for (int u0 = 0; u0 < U; u0 += BU) {
    int any_edge = 0;
#pragma unroll
    for (int i = 0; i < (BU * BV) / THREADS; ++i) {
      const int idx = i * THREADS + tid;
      const int r = idx / BV;
      const int c = idx % BV;
      const int u = u0 + r;
      const int v = v0 + c;
      const uint8_t a =
          (u < U && v < V) ? adj[static_cast<size_t>(u) * V + v] : 0;
      any_edge |= a;
      smask[r][c] = a ? INT_MIN : INT_MAX;
    }
#pragma unroll
    for (int i = 0; i < (BS * BU) / THREADS; ++i) {
      const int idx = i * THREADS + tid;
      const int r = idx / BU;
      const int c = idx % BU;
      const int s = s0 + r;
      const int u = u0 + c;
      sprop[r][c] =
          (s < S && u < U) ? prop[static_cast<size_t>(s) * U + u] : INT_MAX;
    }
    // barrier for the staged tiles, and a block-wide "any edge" vote
    if (__syncthreads_or(any_edge)) {
#pragma unroll 8
      for (int k = 0; k < BU; ++k) {
        int32_t p[TS];
        int32_t m[TV];
#pragma unroll
        for (int i = 0; i < TS; ++i) p[i] = sprop[warp * TS + i][k];
#pragma unroll
        for (int j = 0; j < TV; ++j) m[j] = smask[k][lane + 32 * j];
#pragma unroll
        for (int i = 0; i < TS; ++i)
#pragma unroll
          for (int j = 0; j < TV; ++j)
            acc[i][j] = min(acc[i][j], max(p[i], m[j]));
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TS; ++i) {
    const int s = s0 + warp * TS + i;
#pragma unroll
    for (int j = 0; j < TV; ++j) {
      const int v = v0 + lane + 32 * j;
      if (s < S && v < V) out[static_cast<size_t>(s) * V + v] = acc[i][j];
    }
  }
}

}  // namespace

// prop (S, U) int32, adj (U, V) uint8, out (S, V) int32, all row-major and
// contiguous on the current device; S, V >= 1.  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int minmax_relax_launch(const void* prop, const void* adj,
                                   void* out, int S, int U, int V,
                                   void* stream) {
  const dim3 grid((V + BV - 1) / BV, (S + BS - 1) / BS);
  minmax_relax_kernel<<<grid, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(prop), static_cast<const uint8_t*>(adj),
      static_cast<int32_t*>(out), S, U, V);
  return static_cast<int>(cudaGetLastError());
}
