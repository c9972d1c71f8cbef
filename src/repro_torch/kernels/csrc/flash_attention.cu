// K5: online-softmax (flash) attention for grouped-query heads, reading the
// K/V cache in place.
//
//   out[b, h, s] = softmax_t(scale * q[b, h, s] . k[b, h / G, t]) @ v[b, h / G, t]
//   over keys t < kv_len, and t <= s + (kv_len - S) when causal, and
//   t > s + (kv_len - S) - window when a window is given (causal only: the
//   reference's sliding-window mask, models/attention.py::_causal_mask),
//   for query heads h < live (G = live / Hkv, jnp.repeat order);
//   out[b, h] = 0 for h >= live (the reference's zero-padded heads)
//
// q (B, H, S, D), k and v (B, Hkv, T_alloc, D) with only their first kv_len
// rows read, out (B, H, S, D); every tensor given by its (b, h, row) strides
// with unit stride along D.  float32 or bfloat16 in, the softmax and both
// products accumulated in float32, the output in q's dtype.  Replaces
// src/repro/kernels/flash_attention.py::flash_attention_pallas (whose
// wrapper repeats and pads the K/V heads and pads D to 128 lanes; neither is
// carried over).
//
// Two kernels behind one entry point:
//
// Prefill (S > 1).  At the serve path's prefill (S = T = 512, D = 64) the
// work is ~4.3 GFLOP against ~50 MB, so it is bound by operations.  Both
// products run on the tensor cores as mma.sync.m16n8k8 TF32 with a 3xTF32
// split (x ~ hi + lo, hi = tf32(x), lo = tf32(x - hi); lo*hi + hi*lo +
// hi*hi accumulated in float32), which keeps float32 accuracy: a single
// TF32 product would not.  FlashAttention-2 layout:
//   * a block of 4 warps owns 64 query rows, 16 per warp; Q, times
//     scale * log2(e), is split once into hi/lo A-fragments kept in shared
//     memory in fragment order (one 16-byte load per fragment);
//   * 32-key K and V tiles are double-buffered through shared memory with
//     cp.async (rows past kv_len are zero-filled, never read), so the next
//     tile's copy overlaps this tile's products; at D = 64 a block holds
//     68 KB, so 3 blocks (12 warps) share an SM (64-key tiles allow 2, 16
//     add barriers: tools/kernel_variants.py times both).  Within each 8-wide step
//     over D the fragment positions (t, t + 4) hold the dimensions
//     (2t, 2t + 1), so a lane's two K values are one 8-byte load; K rows are
//     padded to D + 8 floats and V rows to D + 4, which makes every
//     B-fragment load conflict-free;
//   * a split is 4 integer and FP32 ops, in place of two cvt.rna.tf32;
//     the products take about half of the kernel's time, mma.sync TF32
//     running well below the card's wgmma rate (tools/kernel_variants.py
//     times the kernel with the cvt split and with one product in three);
//   * the score tile stays in the accumulator fragments: masks (skipped for
//     tiles every row of the warp sees whole), the row max and sum (a
//     shuffle over the 4 lanes of a row) and exp2 are applied in registers;
//     the probabilities become the A-fragments of P @ V directly, with the
//     keys of each 8-key step permuted (position t <-> key 2t, t + 4 <->
//     2t + 1) so that the accumulator layout is the operand layout, and V
//     read in the same order;
//   * causal tiles past a query tile's last visible key are skipped, and
//     with a window so are the tiles before its first one (a block starts
//     at the tile holding key q0 + off - window + 1); the heaviest query
//     tiles are scheduled first, and heads >= live only write zeros;
//   * at D = 256 the split Q of a block (128 KB) and double-buffered K/V
//     (130 KB) would exceed the 227 KB a block may hold, so Q is kept
//     unsplit (64 KB, 195 KB in all) and split at each use; one block fits
//     an SM.
//   * given an `lse` buffer (the train path), each row's log-sum-exp in
//     the kernel's base-2 scaling, m + log2(l), is written beside the
//     output for the backward (flash_attention_bwd.cu); the output is
//     bitwise the same with and without it.
//
// Decode (S = 1).  One query row per head over a kv_len-deep cache: bound by
// reading K and V once.  Split-KV ("flash decoding"): one block per
// (chunk of 64 keys, KV head, batch row) stages its chunk with 16-byte
// cp.async and computes, for all G query heads of the group at once, a
// partial (max, sum, unnormalised output) on the CUDA cores; a second small
// kernel merges the chunks of each head and writes the zeros of the padded
// heads.  The cache is read once per group, not once per query head.  With
// a window only the last `window` keys are read (the k, v rows are offset).
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* part;  // decode: (B, live, n_chunks, D + 2) partial results
  float* lse;   // prefill, when not null: (B, H, S) log-sum-exp, base 2
  int B, H, Hkv, S, kv_len, live, causal, window;  // window 0: none
  float scale;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_st, v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_ss;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + ROWS) of a (rows, D) matrix with row stride `stride`
// (elements) into shared memory as float32, row stride LD floats; rows at
// or past `nvalid` become zeros and are not read.  float32 goes through
// cp.async (16 bytes a copy; the caller commits and waits); bfloat16 is
// loaded 8 values at a time and converted on the way.
template <int D, int ROWS, int LD, int NT>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long stride, int row0,
                                           int nvalid, int tid) {
  constexpr int CPR = D / 4;  // 16-byte chunks per row
#pragma unroll
  for (int idx = tid; idx < ROWS * CPR; idx += NT) {
    const int r = idx / CPR;
    const int c = (idx % CPR) * 4;
    const bool ok = row0 + r < nvalid;
    const float* g = ok ? src + (row0 + r) * stride + c : src;
    cp_async16(dst + r * LD + c, g, ok);
  }
}
template <int D, int ROWS, int LD, int NT>
__device__ __forceinline__ void stage_rows(float* dst,
                                           const __nv_bfloat16* src,
                                           long long stride, int row0,
                                           int nvalid, int tid) {
  constexpr int CPR = D / 8;
#pragma unroll
  for (int idx = tid; idx < ROWS * CPR; idx += NT) {
    const int r = idx / CPR;
    const int c = (idx % CPR) * 8;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (row0 + r < nvalid) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + c);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(h2[e]);
        f[2 * e] = x.x;
        f[2 * e + 1] = x.y;
      }
    }
    float4* d4 = reinterpret_cast<float4*>(dst + r * LD + c);
    d4[0] = make_float4(f[0], f[1], f[2], f[3]);
    d4[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
}

// ---------------------------------------------------------------------------
// prefill: tensor cores, 3xTF32
// ---------------------------------------------------------------------------

constexpr int PF_THREADS = 128;  // 4 warps x 16 query rows
constexpr int BQ = 64;           // query rows per block
constexpr int BKV = 32;          // keys per tile
constexpr int NKG = BKV / 8;     // 8-key groups per tile

// x ~ hi + lo: hi is x rounded to TF32 (to nearest, ties away), lo the
// exact float32 rest truncated to TF32, |x - hi - lo| <= 2^-21 |x|; integer
// and FP32 ops in place of cvt.rna.tf32.f32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// c (16x8, f32) += a (16x8, tf32, row) * b (8x8, tf32, col)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b at float32 accuracy: the small products first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(c, a_lo, b_hi);
  mma_tf32(c, a_hi, b_lo);
  mma_tf32(c, a_hi, b_hi);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// shared-memory layout of the prefill kernel, in floats; Q is stored split
// (hi|lo) up to D = 128 and unsplit above, where the split would not fit
template <int D>
struct PfSmem {
  static constexpr bool kSplitQ = D <= 128;
  static constexpr int QW = kSplitQ ? 256 : 128;  // floats a warp's k-step
  static constexpr int LDK = D + 8;          // padded K row
  static constexpr int LDV = D + 4;          // padded V row
  static constexpr int kQ = 0;               // [warp][kstep][(hi|lo)][lane][4]
  static constexpr int kK = kQ + BQ * D * QW / 128;  // [buf][BKV][LDK]
  static constexpr int kV = kK + 2 * BKV * LDK;  // [buf][BKV][LDV]
  static constexpr size_t bytes =
      sizeof(float) * static_cast<size_t>(kV + 2 * BKV * LDV);
};

template <typename T, int D>
__global__ void __launch_bounds__(PF_THREADS)
flash_prefill_kernel(const Args a) {
  constexpr int LDK = PfSmem<D>::LDK;
  constexpr int LDV = PfSmem<D>::LDV;
  constexpr bool kSplitQ = PfSmem<D>::kSplitQ;
  constexpr int QW = PfSmem<D>::QW;
  constexpr int KS = D / 8;  // k-steps of Q K^T, and n-tiles of P V
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem + PfSmem<D>::kQ;
  float* sK = smem + PfSmem<D>::kK;
  float* sV = smem + PfSmem<D>::kV;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in the group
  const int b = blockIdx.x / a.H;
  const int h = blockIdx.x % a.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heavy tiles first
  const int S = a.S;
  T* out = static_cast<T*>(a.out) + b * a.o_sb + h * a.o_sh;

  float* lse = a.lse == nullptr
                   ? nullptr
                   : a.lse + (static_cast<long long>(b) * a.H + h) * S;

  if (h >= a.live) {  // a padded head: exact zeros, no work
    for (int idx = tid; idx < BQ * D; idx += PF_THREADS) {
      const int r = q0 + idx / D;
      if (r < S) out[r * a.o_ss + idx % D] = from_f32<T>(0.0f);
    }
    if (lse != nullptr)
      for (int r = q0 + tid; r < min(q0 + BQ, S); r += PF_THREADS)
        lse[r] = 0.0f;
    return;
  }
  const int hk = h / (a.live / a.Hkv);
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const int kv_len = a.kv_len;
  const int off = kv_len - S;  // query s is position s + off
  const int r0 = q0 + warp * 16 + g;
  const int r1 = r0 + 8;

  const int window = a.window;
  int n_tiles = (kv_len + BKV - 1) / BKV;
  if (a.causal) n_tiles = min(n_tiles, (min(q0 + BQ, S) - 1 + off) / BKV + 1);
  // the block's lowest visible key is row q0's first one in its window
  const int it0 = window > 0 ? max(0, q0 + off - window + 1) / BKV : 0;

  stage_rows<D, BKV, LDK, PF_THREADS>(sK, k, a.k_st, it0 * BKV, kv_len, tid);
  stage_rows<D, BKV, LDV, PF_THREADS>(sV, v, a.v_st, it0 * BKV, kv_len, tid);
  cp_async_commit();

  // this warp's 16 query rows, times scale * log2(e) (the softmax runs in
  // base 2), as hi/lo TF32 A-fragments in fragment order (unsplit above
  // D = 128).  Within each 8-wide k-step the fragment positions (t, t + 4)
  // hold the dimensions (2t, 2t + 1), so that a lane's two K values are one
  // 8-byte load.
  const float qs = a.scale * LOG2E;
  float* myq = sQ + warp * (KS * QW);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int c = kk * 8 + 2 * t;
    const float x[4] = {r0 < S ? to_f32(q[r0 * a.q_ss + c]) * qs : 0.0f,
                        r1 < S ? to_f32(q[r1 * a.q_ss + c]) * qs : 0.0f,
                        r0 < S ? to_f32(q[r0 * a.q_ss + c + 1]) * qs : 0.0f,
                        r1 < S ? to_f32(q[r1 * a.q_ss + c + 1]) * qs : 0.0f};
    if constexpr (kSplitQ) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(x[e], hi[e], lo[e]);
      reinterpret_cast<uint4*>(myq + kk * QW)[lane] =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      reinterpret_cast<uint4*>(myq + kk * QW + 128)[lane] =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    } else {
      reinterpret_cast<float4*>(myq + kk * QW)[lane] =
          make_float4(x[0], x[1], x[2], x[3]);
    }
  }

  float o[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m0 = NEG, m1 = NEG, l0 = 0.0f, l1 = 0.0f;  // rows r0 and r1

  for (int it = it0; it < n_tiles; ++it) {
    const int buf = (it - it0) & 1;
    if (it + 1 < n_tiles) {
      stage_rows<D, BKV, LDK, PF_THREADS>(sK + (buf ^ 1) * BKV * LDK, k,
                                          a.k_st, (it + 1) * BKV, kv_len,
                                          tid);
      stage_rows<D, BKV, LDV, PF_THREADS>(sV + (buf ^ 1) * BKV * LDV, v,
                                          a.v_st, (it + 1) * BKV, kv_len,
                                          tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of tile `it` have landed
    __syncthreads();     // ... and everyone's
    const float* tK = sK + buf * BKV * LDK;
    const float* tV = sV + buf * BKV * LDV;
    const int k0 = it * BKV;

    // scores: 16 rows x BKV keys per warp, in NKG accumulator fragments
    float s[NKG][4];
#pragma unroll
    for (int n = 0; n < NKG; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a_hi[4], a_lo[4];
      if constexpr (kSplitQ) {
        const uint4 qh = reinterpret_cast<const uint4*>(myq + kk * QW)[lane];
        const uint4 ql =
            reinterpret_cast<const uint4*>(myq + kk * QW + 128)[lane];
        a_hi[0] = qh.x, a_hi[1] = qh.y, a_hi[2] = qh.z, a_hi[3] = qh.w;
        a_lo[0] = ql.x, a_lo[1] = ql.y, a_lo[2] = ql.z, a_lo[3] = ql.w;
      } else {
        const float4 qx = reinterpret_cast<const float4*>(myq + kk * QW)[lane];
        split_tf32(qx.x, a_hi[0], a_lo[0]);
        split_tf32(qx.y, a_hi[1], a_lo[1]);
        split_tf32(qx.z, a_hi[2], a_lo[2]);
        split_tf32(qx.w, a_hi[3], a_lo[3]);
      }
#pragma unroll
      for (int n = 0; n < NKG; ++n) {
        const float2 kr = *reinterpret_cast<const float2*>(
            tK + (n * 8 + g) * LDK + kk * 8 + 2 * t);
        uint32_t b_hi[2], b_lo[2];
        split_tf32(kr.x, b_hi[0], b_lo[0]);
        split_tf32(kr.y, b_hi[1], b_lo[1]);
        mma_3xtf32(s[n], a_hi, a_lo, b_hi, b_lo);
      }
    }

    // mask, online softmax on the fragments (fragment (n, e) is key
    // k0 + 8n + 2t + e of row r0 for e < 2, of row r1 for e >= 2); a tile
    // that every row of the warp sees whole skips the mask: its last key
    // is visible to the warp's first row and, in a window, its first key
    // to the warp's last row
    uint32_t vis0 = (1u << (2 * NKG)) - 1, vis1 = vis0;
    const int w0 = q0 + warp * 16 + off;  // the warp's first row's position
    if (k0 + BKV > kv_len || (a.causal && k0 + BKV - 1 > w0) ||
        (window > 0 && k0 <= w0 + 15 - window)) {
      vis0 = vis1 = 0;
#pragma unroll
      for (int n = 0; n < NKG; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + n * 8 + 2 * t + e;
          const bool in = key < kv_len;
          const bool ok0 = in && (!a.causal || key <= r0 + off) &&
                           (window <= 0 || key > r0 + off - window);
          const bool ok1 = in && (!a.causal || key <= r1 + off) &&
                           (window <= 0 || key > r1 + off - window);
          vis0 |= static_cast<uint32_t>(ok0) << (2 * n + e);
          vis1 |= static_cast<uint32_t>(ok1) << (2 * n + e);
          if (!ok0) s[n][e] = NEG;
          if (!ok1) s[n][2 + e] = NEG;
        }
      }
    }
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int n = 0; n < NKG; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = exp2f(m0 - mn0);
    const float al1 = exp2f(m1 - mn1);
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int n = 0; n < NKG; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int bit = 2 * n + e;
        s[n][e] = (vis0 >> bit) & 1u ? exp2f(s[n][e] - mn0) : 0.0f;
        s[n][2 + e] = (vis1 >> bit) & 1u ? exp2f(s[n][2 + e] - mn1) : 0.0f;
        ps0 += s[n][e];
        ps1 += s[n][2 + e];
      }
    }
    // per-thread partial sums; the 4 lanes of a row share m, so they are
    // added up once, at the end
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < KS; ++n) {
      o[n][0] *= al0;
      o[n][1] *= al0;
      o[n][2] *= al1;
      o[n][3] *= al1;
    }

    // O += P V: key step j's accumulator fragment is the A-fragment of the
    // keys in the order (2t, 2t + 1) -> positions (t, t + 4)
#pragma unroll
    for (int j = 0; j < NKG; ++j) {
      uint32_t p_hi[4], p_lo[4];
      split_tf32(s[j][0], p_hi[0], p_lo[0]);
      split_tf32(s[j][2], p_hi[1], p_lo[1]);
      split_tf32(s[j][1], p_hi[2], p_lo[2]);
      split_tf32(s[j][3], p_hi[3], p_lo[3]);
      const float* vr = tV + (j * 8 + 2 * t) * LDV + g;
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        uint32_t b_hi[2], b_lo[2];
        split_tf32(vr[n * 8], b_hi[0], b_lo[0]);
        split_tf32(vr[LDV + n * 8], b_hi[1], b_lo[1]);
        mma_3xtf32(o[n], p_hi, p_lo, b_hi, b_lo);
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

  const float d0 = fmaxf(quad_sum(l0), 1e-30f);
  const float d1 = fmaxf(quad_sum(l1), 1e-30f);
  // the log-sum-exp of the scores times scale * log2(e), in base 2: the
  // row max and sum are the same in the 4 lanes of a row
  if (lse != nullptr && t == 0) {
    if (r0 < S) lse[r0] = m0 + log2f(d0);
    if (r1 < S) lse[r1] = m1 + log2f(d1);
  }
#pragma unroll
  for (int n = 0; n < KS; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < S) store2(out + r0 * a.o_ss + c, o[n][0] / d0, o[n][1] / d0);
    if (r1 < S) store2(out + r1 * a.o_ss + c, o[n][2] / d1, o[n][3] / d1);
  }
}

// ---------------------------------------------------------------------------
// decode: split-KV on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int DC_THREADS = 128;
constexpr int CH = 64;       // keys per chunk (one block each)
constexpr int MAX_G = 64;    // query heads per KV head

template <int D>
__host__ __device__ constexpr size_t decode_smem(int G) {
  // sK [CH][D + 4], sV [CH][D], sQ [G][D], sP [G][CH + 1], sM, sL [G]
  return sizeof(float) *
         static_cast<size_t>(CH * (D + 4) + CH * D + G * D + G * (CH + 1) +
                             2 * G);
}

template <typename T, int D>
__global__ void __launch_bounds__(DC_THREADS)
flash_decode_kernel(const Args a, int n_chunks) {
  constexpr int LDK = D + 4;
  extern __shared__ __align__(16) float smem[];
  const int G = a.live / a.Hkv;
  float* sK = smem;
  float* sV = sK + CH * LDK;
  float* sQ = sV + CH * D;
  float* sP = sQ + G * D;
  float* sM = sP + G * (CH + 1);
  float* sL = sM + G;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int chunk = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int c0 = chunk * CH;
  const int kv_len = a.kv_len;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  stage_rows<D, CH, LDK, DC_THREADS>(sK, k, a.k_st, c0, kv_len, tid);
  stage_rows<D, CH, D, DC_THREADS>(sV, v, a.v_st, c0, kv_len, tid);
  cp_async_commit();
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb;
  for (int idx = tid; idx < G * D; idx += DC_THREADS)
    sQ[idx] = to_f32(q[(hk * G + idx / D) * a.q_sh + idx % D]);
  cp_async_wait<0>();
  __syncthreads();

  // scores of the group's G heads against the chunk's keys
  {
    const int j = tid % CH;
    const bool in = c0 + j < kv_len;
    for (int i = tid / CH; i < G; i += DC_THREADS / CH) {
      float acc = 0.0f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(sK + j * LDK + d);
        const float4 qq = *reinterpret_cast<const float4*>(sQ + i * D + d);
        acc = fmaf(qq.x, kk.x, acc);
        acc = fmaf(qq.y, kk.y, acc);
        acc = fmaf(qq.z, kk.z, acc);
        acc = fmaf(qq.w, kk.w, acc);
      }
      sP[i * (CH + 1) + j] = in ? acc * a.scale : NEG;
    }
  }
  __syncthreads();

  // the chunk's softmax, one warp per head
  for (int i = warp; i < G; i += DC_THREADS / 32) {
    float* row = sP + i * (CH + 1);
    const bool in0 = c0 + lane < kv_len;
    const bool in1 = c0 + lane + 32 < kv_len;
    float mx = fmaxf(row[lane], row[lane + 32]);
#pragma unroll
    for (int w = 16; w > 0; w >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
    const float p0 = in0 ? expf(row[lane] - mx) : 0.0f;
    const float p1 = in1 ? expf(row[lane + 32] - mx) : 0.0f;
    float sum = p0 + p1;
#pragma unroll
    for (int w = 16; w > 0; w >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, w);
    row[lane] = p0;
    row[lane + 32] = p1;
    if (lane == 0) {
      sM[i] = mx;
      sL[i] = sum;
    }
  }
  __syncthreads();

  // unnormalised P V of the chunk, and its (max, sum), per head; above
  // D = 128 a thread takes D / 128 dimensions
  constexpr int NG = D < DC_THREADS ? DC_THREADS / D : 1;  // head groups
  constexpr int RB = 4;               // heads per thread and pass
  float* part = a.part + static_cast<size_t>(b) * a.live * n_chunks * (D + 2);
  for (int d = tid % D; d < D; d += DC_THREADS) {
    for (int i0 = tid / D; i0 < G; i0 += NG * RB) {
      float acc[RB] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int j = 0; j < CH; ++j) {
        const float vv = sV[j * D + d];
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const int i = i0 + r * NG;
          if (i < G) acc[r] = fmaf(sP[i * (CH + 1) + j], vv, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const int i = i0 + r * NG;
        if (i < G) {
          float* dst = part + (static_cast<size_t>(hk * G + i) * n_chunks +
                               chunk) * (D + 2);
          dst[d] = acc[r];
          if (d == 0) {
            dst[D] = sM[i];
            dst[D + 1] = sL[i];
          }
        }
      }
    }
  }
}

// merges the chunks of one (b, h): grid (H, B), D threads
template <typename T>
__global__ void flash_decode_merge_kernel(const Args a, int n_chunks, int D) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  T* out = static_cast<T*>(a.out) + b * a.o_sb + h * a.o_sh;
  if (h >= a.live) {
    out[d] = from_f32<T>(0.0f);
    return;
  }
  const float* p =
      a.part + (static_cast<size_t>(b) * a.live + h) * n_chunks * (D + 2);
  float m = NEG;
  for (int c = 0; c < n_chunks; ++c) m = fmaxf(m, p[c * (D + 2) + D]);
  float l = 0.0f, o = 0.0f;
  for (int c = 0; c < n_chunks; ++c) {
    const float w = expf(p[c * (D + 2) + D] - m);
    l = fmaf(p[c * (D + 2) + D + 1], w, l);
    o = fmaf(p[c * (D + 2) + d], w, o);
  }
  out[d] = from_f32<T>(o / fmaxf(l, 1e-30f));
}

template <typename T, int D>
int launch(Args a, cudaStream_t st) {
  if (a.S == 1 && a.lse == nullptr) {
    if (a.window > 0 && a.kv_len > a.window) {  // read the last window keys
      const int lo = a.kv_len - a.window;
      a.k = static_cast<const T*>(a.k) + lo * a.k_st;
      a.v = static_cast<const T*>(a.v) + lo * a.v_st;
      a.kv_len = a.window;
    }
    // above 48 KB a block's shared memory must be asked for, once per kernel
    static const cudaError_t attr = cudaFuncSetAttribute(
        flash_decode_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(decode_smem<D>(MAX_G)));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const int n_chunks = (a.kv_len + CH - 1) / CH;
    const dim3 grid(n_chunks, a.Hkv, a.B);
    flash_decode_kernel<T, D><<<grid, DC_THREADS,
                                decode_smem<D>(a.live / a.Hkv), st>>>(
        a, n_chunks);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_decode_merge_kernel<T><<<dim3(a.H, a.B), D, 0, st>>>(a, n_chunks,
                                                               D);
    return static_cast<int>(cudaGetLastError());
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_prefill_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(PfSmem<D>::bytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(a.B * a.H, (a.S + BQ - 1) / BQ);
  flash_prefill_kernel<T, D><<<grid, PF_THREADS, PfSmem<D>::bytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const Args& a, int D, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(a, st);
    case 64: return launch<T, 64>(a, st);
    case 128: return launch<T, 128>(a, st);
    case 256: return launch<T, 256>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, H, S, D), k/v (B, Hkv, >= kv_len, D), out (B, H, S, D), each by its
// (b, h, row) strides in elements with unit stride along D, every row
// 16-byte aligned; all float32 (bf16 = 0) or all bfloat16 (bf16 = 1);
// D in {16, 64, 128, 256}; Hkv divides live <= H, live / Hkv <= 64;
// kv_len >= S when causal; window > 0 (causal only) limits query s to the
// last `window` keys up to its own position, 0 means none; `part` holds
// B * live * ceil(min(kv_len, window) / 64) * (D + 2) floats when S == 1
// (unused otherwise); `lse`, when not null, receives the float32 (B, H, S)
// log-sum-exp of the prefill kernel's base-2 scores (0 for heads >= live),
// which then runs for S == 1 too, and leaves the output as it is without
// it.  Returns the cudaError_t of the launches (0 on
// success).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, void* part,
    void* lse, int B,
    int H, int Hkv, int S, int kv_len, int live, int D, int causal,
    int window, float scale, int bf16, long long q_sb, long long q_sh,
    long long q_ss,
    long long k_sb, long long k_sh, long long k_st, long long v_sb,
    long long v_sh, long long v_st, long long o_sb, long long o_sh,
    long long o_ss, void* stream) {
  const Args a{q,    k,      v,      out,    static_cast<float*>(part),
               static_cast<float*>(lse),
               B,    H,      Hkv,    S,      kv_len,
               live, causal, window, scale,  q_sb,
               q_sh, q_ss,   k_sb,   k_sh,   k_st,
               v_sb, v_sh,   v_st,   o_sb,   o_sh,
               o_ss};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_d<__nv_bfloat16>(a, D, st);
  return launch_d<float>(a, D, st);
}
