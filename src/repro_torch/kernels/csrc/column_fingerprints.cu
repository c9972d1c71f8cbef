// K2: per-column supernode fingerprints of one converged label chunk.
//
// For every column v, over the rows s with rel[s, v] < v, src[s] > v and
// valid[s] != 0:
//   out[0, v] = count, out[1, v] = sum of m1[s] (mod 2^32),
//   out[2, v] = xor of m2[s].
//
// Replaces src/repro/kernels/supernode_fp.py::supernode_fp_pallas.
//
// What bounds it on an H100: bytes.  Each label is read once and costs a
// compare or two; the (S, V) int32 chunk dominates the traffic.  The design:
//   * one thread per column walks a slice of the source rows, so a warp
//     reads 32 neighbouring labels of one row per step (coalesced);
//   * the source axis is split over blockIdx.y so enough blocks are in
//     flight; each block folds its partial with one atomicAdd / atomicAdd /
//     atomicXor per column into the zeroed output.  All three reductions are
//     exact integer operations that commute, so the result does not depend
//     on the order the blocks finish: it is bitwise equal to the plain
//     version in kernels/plain.py;
//   * the sum runs in uint32, which wraps mod 2^32 exactly as the reference's
//     int32 sum does.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // columns per block
constexpr int SCHUNK = 64;    // source rows per block

__global__ void __launch_bounds__(THREADS)
column_fingerprints_kernel(const int32_t* __restrict__ rel,
                           const int32_t* __restrict__ src,
                           const int32_t* __restrict__ m1,
                           const int32_t* __restrict__ m2,
                           const int32_t* __restrict__ valid,
                           int32_t* __restrict__ out, int S, int V) {
  __shared__ int32_t ssrc[SCHUNK];
  __shared__ uint32_t sm1[SCHUNK];
  __shared__ uint32_t sm2[SCHUNK];

  const int s0 = blockIdx.y * SCHUNK;
  const int ns = min(SCHUNK, S - s0);
  for (int i = threadIdx.x; i < ns; i += THREADS) {
    // a padding row gets src = INT_MIN, which is never > a column id
    ssrc[i] = valid[s0 + i] != 0 ? src[s0 + i] : INT_MIN;
    sm1[i] = static_cast<uint32_t>(m1[s0 + i]);
    sm2[i] = static_cast<uint32_t>(m2[s0 + i]);
  }
  __syncthreads();

  const int v = blockIdx.x * THREADS + threadIdx.x;
  if (v >= V) return;
  uint32_t cnt = 0, hsum = 0, hxor = 0;
  for (int i = 0; i < ns; ++i) {
    const int32_t r = rel[static_cast<size_t>(s0 + i) * V + v];
    if (r < v && ssrc[i] > v) {
      cnt += 1u;
      hsum += sm1[i];
      hxor ^= sm2[i];
    }
  }
  if (cnt) {
    unsigned int* o = reinterpret_cast<unsigned int*>(out);
    atomicAdd(o + v, cnt);
    atomicAdd(o + V + v, hsum);
    atomicXor(o + 2 * static_cast<size_t>(V) + v, hxor);
  }
}

}  // namespace

// rel (S, V) int32; src, m1, m2, valid (S,) int32; out (3, V) int32 and
// ZEROED by the caller; all contiguous on the current device; S, V >= 1.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int column_fingerprints_launch(const void* rel, const void* src,
                                          const void* m1, const void* m2,
                                          const void* valid, void* out,
                                          int S, int V, void* stream) {
  const dim3 grid((V + THREADS - 1) / THREADS, (S + SCHUNK - 1) / SCHUNK);
  column_fingerprints_kernel<<<grid, THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rel), static_cast<const int32_t*>(src),
      static_cast<const int32_t*>(m1), static_cast<const int32_t*>(m2),
      static_cast<const int32_t*>(valid), static_cast<int32_t*>(out), S, V);
  return static_cast<int>(cudaGetLastError());
}
