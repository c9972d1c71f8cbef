// K1: bottleneck-semiring relaxation of one GSoFa superstep.
//
//   out[s, v] = min over u of (adj[u, v] != 0 ? prop[s, u] : INT32_MAX)
//
// Replaces src/repro/kernels/gsofa_relax.py::minmax_relax_pallas.
//
// What bounds it on an H100: reading the (U, V) uint8 adjacency.  On the
// main path it is dense storage of a sparse graph (bbd-20k: 20096^2 bytes,
// 404 MB, ~5 edges per column), so nearly every 32 x 64 tile holds no edge
// and the masked mins are few; the bytes are the floor (0.12 ms at
// 3.35 TB/s).  The design reads the adjacency exactly once per call:
//   * a block of 16 warps owns 512 sources (grid y covers more), one
//     64-column strip and one band of its rows: U is cut into as many bands
//     as give ~16 blocks per SM, so a strip with edges in most row steps
//     (a border) is shared by several blocks and makes no tail;
//   * strips vary fastest over the grid, so the blocks in flight read the
//     same rows of neighbouring strips (whole 128-byte lines, open DRAM
//     pages);
//   * each 128-row step arrives through an 8-stage cp.async ring, 16 bytes
//     a thread; each thread checks its own 16 bytes and marks its row in a
//     per-tile row mask, and one block vote skips an empty step (one
//     barrier per empty step);
//   * a 32-row tile with an edge is relaxed by every warp for its 32
//     sources; each lane keeps the accumulators of two columns in
//     registers.  A tile with <= 8 rows holding edges loads those rows'
//     prop once per source (one lane each, all loads in flight together),
//     broadcasts them by shuffles and applies the select mask: for an edge
//     mask = INT32_MIN, else INT32_MAX, and min(acc, max(prop, mask)) is two
//     integer ops with no branch.  A tile with more rows stages
//     prop[sources, rows] in shared memory (coalesced, from L2) and each
//     lane walks the set bits of its columns: one min per edge and source;
//   * when the block is done it merges what it lowered into the output
//     with atomicMin; the wrapper fills the output with INT32_MAX first, and
//     entries a block never lowered are not written.
// min is exact in any order, so the result is bitwise equal to the plain
// version in kernels/plain.py, whatever the order of the atomics.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int BV = 64;                // columns per strip
constexpr int ROWS = 128;             // adjacency rows per pipeline step
constexpr int TILE = 32;              // rows per tile (one bit each)
constexpr int NSTAGE = 8;             // ring depth, in steps
constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;   // one 16-byte chunk of a step each
constexpr int WS = 32;                // sources per warp
constexpr int BS = WARPS * WS;        // sources per block
constexpr int WAVES = 16;             // blocks per SM over the whole grid
constexpr int MIN_STEPS = 16;         // row steps per block, at least

constexpr int SPARSE = 8;             // a tile with at most this many
                                      // rows with an edge takes them
                                      // row by row
constexpr unsigned FULL = 0xffffffffu;

struct Smem {
  uint8_t ring[NSTAGE][ROWS][BV];     // 64 KB
  int32_t prop[WARPS][WS][TILE];      // 64 KB: each warp's sources x tile
  uint32_t rows[NSTAGE][ROWS / TILE];  // the rows with an edge, per tile
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0)
               : "memory");
}

// merges a strip's accumulators (columns lane and lane + 32) into out with
// atomicMin where they were lowered, then resets them
__device__ __forceinline__ void flush(int32_t (&acc0)[WS], int32_t (&acc1)[WS],
                                      int32_t* out, int strip,
                                      int s_base, int lane, int S, int V) {
  const int v0 = strip * BV + lane;
#pragma unroll
  for (int i = 0; i < WS; ++i) {
    const int s = s_base + i;
    if (s < S) {
      int32_t* row = out + static_cast<size_t>(s) * V;
      if (acc0[i] != INT_MAX && v0 < V) atomicMin(row + v0, acc0[i]);
      if (acc1[i] != INT_MAX && v0 + 32 < V)
        atomicMin(row + v0 + 32, acc1[i]);
    }
    acc0[i] = acc1[i] = INT_MAX;
  }
}

// A tile with few rows that hold an edge: each such row's prop for the
// warp's 32 sources is loaded once (lane i: source i, all loads in flight
// together) and broadcast by shuffles; a lane lowers a column's sources
// with min(acc, max(prop, mask)), mask = INT_MIN for an edge and INT_MAX
// for none, two integer ops and no branch.
__device__ __forceinline__ void relax_rows(
    int32_t (&acc0)[WS], int32_t (&acc1)[WS], const uint8_t (*rows)[BV],
    uint32_t used, const int32_t* __restrict__ prop, int s_base, int u0,
    int lane, int S, int U) {
  int32_t pv[SPARSE];
  int rr[SPARSE];
  const int s = s_base + lane;
#pragma unroll
  for (int k = 0; k < SPARSE; ++k) {
    rr[k] = used ? __ffs(used) - 1 : -1;
    used &= used - 1;
    pv[k] = rr[k] >= 0 && s < S && u0 + rr[k] < U
                ? __ldg(prop + static_cast<size_t>(s) * U + u0 + rr[k])
                : INT_MAX;
  }
#pragma unroll
  for (int k = 0; k < SPARSE; ++k) {
    if (rr[k] < 0) break;  // warp-uniform
    const int32_t m0 = rows[rr[k]][lane] ? INT_MIN : INT_MAX;
    const int32_t m1 = rows[rr[k]][lane + 32] ? INT_MIN : INT_MAX;
#pragma unroll
    for (int i = 0; i < WS; ++i) {
      const int32_t p = __shfl_sync(FULL, pv[k], i);
      acc0[i] = min(acc0[i], max(p, m0));
      acc1[i] = min(acc1[i], max(p, m1));
    }
  }
}

// A tile with many rows that hold an edge: prop[warp's sources, those rows]
// is staged in shared memory (coalesced), and each lane walks the set bits
// of its two columns, one min per edge and source.
__device__ __forceinline__ void relax_tile(
    int32_t (&acc0)[WS], int32_t (&acc1)[WS], const uint8_t (*rows)[BV],
    uint32_t used, int32_t (*sp)[TILE], const int32_t* __restrict__ prop,
    int s_base, int u0, int lane, int S, int U) {
  uint32_t m0 = 0, m1 = 0;  // edge bits of this lane's two columns
#pragma unroll
  for (int r = 0; r < TILE; ++r) {
    m0 |= static_cast<uint32_t>(rows[r][lane] != 0) << r;
    m1 |= static_cast<uint32_t>(rows[r][lane + 32] != 0) << r;
  }
  const bool need = ((used >> lane) & 1u) && u0 + lane < U;
#pragma unroll
  for (int i = 0; i < WS; ++i) {
    const int s = s_base + i;
    sp[i][lane] = need && s < S
                      ? __ldg(prop + static_cast<size_t>(s) * U + u0 + lane)
                      : INT_MAX;
  }
  __syncwarp();
  while (m0) {
    const int r = __ffs(m0) - 1;
    m0 &= m0 - 1;
#pragma unroll
    for (int i = 0; i < WS; ++i) acc0[i] = min(acc0[i], sp[i][r]);
  }
  while (m1) {
    const int r = __ffs(m1) - 1;
    m1 &= m1 - 1;
#pragma unroll
    for (int i = 0; i < WS; ++i) acc1[i] = min(acc1[i], sp[i][r]);
  }
  __syncwarp();  // sp is refilled by the next tile
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
minmax_relax_kernel(const int32_t* __restrict__ prop,
                    const uint8_t* __restrict__ adj,
                    int32_t* __restrict__ out, int S, int U, int V,
                    int strips, int bands) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // strips vary fastest over the grid, so the blocks in flight read the
  // same rows of neighbouring strips: whole lines and open DRAM pages.  The
  // last strips go first: a bordered matrix's border columns, which hold
  // edges in most row steps, sit there.
  const int strip = strips - 1 - blockIdx.x % strips;
  const int band = blockIdx.x / strips;
  const int steps = (U + ROWS - 1) / ROWS;
  const int lo = static_cast<int>(1LL * steps * band / bands);
  const int hi = static_cast<int>(1LL * steps * (band + 1) / bands);
  const int s_base = blockIdx.y * BS + warp * WS;  // this warp's sources
  const int my_row = tid >> 2;                     // this thread's chunk
  const int v = strip * BV + (tid & 3) * 16;

  int32_t acc0[WS], acc1[WS];  // columns lane and lane + 32 of the strip
#pragma unroll
  for (int i = 0; i < WS; ++i) acc0[i] = acc1[i] = INT_MAX;
  if (tid < NSTAGE * (ROWS / TILE)) (&sm.rows[0][0])[tid] = 0;
  __syncthreads();

  auto fetch = [&](int step) {  // row step `step` into its ring slot
    uint8_t* dst = &sm.ring[(step - lo) % NSTAGE][my_row][(tid & 3) * 16];
    const int u = step * ROWS + my_row;
    if (VEC) {  // V % 16 == 0: a chunk is all in or all out
      const bool ok = u < U && v < V;
      cp_async16(dst, ok ? adj + static_cast<size_t>(u) * V + v : adj, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        dst[e] = (u < U && v + e < V) ? adj[static_cast<size_t>(u) * V + v + e]
                                      : 0;
    }
  };
#pragma unroll
  for (int k = 0; k < NSTAGE - 1; ++k) {
    if (lo + k < hi) fetch(lo + k);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int step = lo; step < hi; ++step) {
    if (step + NSTAGE - 1 < hi) fetch(step + NSTAGE - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group %0;\n" ::"n"(NSTAGE - 1) : "memory");
    const int slot = (step - lo) % NSTAGE;
    const uint4 mine = *reinterpret_cast<const uint4*>(
        &sm.ring[slot][my_row][(tid & 3) * 16]);
    const bool nz = (mine.x | mine.y | mine.z | mine.w) != 0;
    if (nz) atomicOr(&sm.rows[slot][my_row / TILE], 1u << (my_row % TILE));
    if (!__syncthreads_or(nz)) continue;  // an empty step: one barrier
    if (s_base < S) {
      for (int tile = 0; tile < ROWS / TILE; ++tile) {
        const uint32_t used = sm.rows[slot][tile];
        if (!used) continue;
        const uint8_t(*rows)[BV] = &sm.ring[slot][tile * TILE];
        const int u0 = step * ROWS + tile * TILE;
        if (__popc(used) <= SPARSE)
          relax_rows(acc0, acc1, rows, used, prop, s_base, u0, lane, S, U);
        else
          relax_tile(acc0, acc1, rows, used, sm.prop[warp], prop, s_base, u0,
                     lane, S, U);
      }
    }
    __syncthreads();  // the slot and its row masks are refilled next
    if (tid < ROWS / TILE) sm.rows[slot][tid] = 0;
  }
  flush(acc0, acc1, out, strip, s_base, lane, S, V);
}

template <bool VEC>
int launch(const void* prop, const void* adj, void* out, int S, int U, int V,
           cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      minmax_relax_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(Smem)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // U is cut into bands, as many as give WAVES blocks per SM, each at least
  // MIN_STEPS row steps long (one block has one SM)
  const int strips = (V + BV - 1) / BV;
  const int steps = (U + ROWS - 1) / ROWS;
  int bands = (WAVES * sms + strips / 2) / strips;
  bands = max(1, min(bands, steps / MIN_STEPS));
  if (1LL * strips * bands > INT_MAX) return cudaErrorInvalidValue;
  const dim3 grid(strips * bands, (S + BS - 1) / BS);
  minmax_relax_kernel<VEC><<<grid, THREADS, sizeof(Smem), st>>>(
      static_cast<const int32_t*>(prop), static_cast<const uint8_t*>(adj),
      static_cast<int32_t*>(out), S, U, V, strips, bands);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// prop (S, U) int32, adj (U, V) uint8, out (S, V) int32 filled with
// INT32_MAX by the caller, all row-major and contiguous on the current
// device; S, U, V >= 1.  Lowers out in place with atomicMin.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int minmax_relax_launch(const void* prop, const void* adj,
                                   void* out, int S, int U, int V,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = V % 16 == 0 && reinterpret_cast<uintptr_t>(adj) % 16 == 0;
  return vec ? launch<true>(prop, adj, out, S, U, V, st)
             : launch<false>(prop, adj, out, S, U, V, st);
}
