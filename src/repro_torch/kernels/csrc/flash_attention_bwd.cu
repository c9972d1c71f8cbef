// K5 backward: the gradient of online-softmax (flash) attention for
// grouped-query heads, from the forward's log-sum-exp.
//
// The forward (flash_attention.cu) computes, for query heads h < live and
// their KV head h / G (G = live / Hkv, jnp.repeat order),
//
//   O = softmax(scale * Q K^T, masked) V,   lse = log2 sum_t exp2(scale *
//   log2(e) * q . k_t)  (base 2: the forward's own scaling)
//
// and this file its gradient for an upstream dO, FlashAttention-2's
// deterministic split, no atomics:
//
//   delta[s] = sum_d dO[s, d] O[s, d]                       (delta pass)
//   P   = exp2(scale * log2(e) * Q K^T - lse), 0 where masked
//   dV  = sum over the group's heads of P^T dO              (dkdv kernel)
//   dS  = P * (dO V^T - delta)
//   dK  = scale * sum over the group's heads of dS^T Q      (dkdv kernel)
//   dQ  = scale * dS K                                      (dq kernel)
//
// and dQ = 0 exactly for heads h >= live (the reference's zero-padded
// heads, whose K and V are zero pads: no gradient flows).  The masks are
// the forward's: causal queries are the last S of T positions (query s
// sees keys <= s + T - S) and a window keeps the keys > s + T - S - window;
// non-causal queries see all T (S != T for cross-attention).  It replaces
// no TPU kernel on its own: src/repro/kernels/flash_attention.py has no
// backward (the reference trains through plain jnp attention), and the
// port's train step runs K5 in every attention layer, so K5 needs one.
//
// What bounds it.  Seven (S x T x D) products (S and dP are computed in
// both kernels) against the forward's two: at smollm-135m's train shape
// (8 x 9 live heads, S = T = 1024, D = 64, causal) ~24 GFLOP of the five
// the gradient needs against ~40 MB, so it is bound by operations.  The
// design is the forward's:
//   * every product runs on the tensor cores as mma.sync.m16n8k8 TF32
//     with the 3xTF32 split (x ~ hi + lo, lo*hi + hi*lo + hi*hi
//     accumulated in float32), which keeps float32 accuracy;
//   * a warp owns 16 rows of the block's fixed operand: 16 keys in dkdv
//     (S^T = K Q^T and dP^T = V dO^T have the keys as rows), 16 queries
//     in dq.  The fixed operands (K and V, or Q and dO) sit in shared
//     memory in A-fragment order, one 16-byte load a fragment;
//   * the score tiles stay in the accumulator fragments: P^T and dS^T =
//     P^T * (dP^T - delta) (dS in dq) are formed there and become the
//     A-fragments of dV = P^T dO and dK = dS^T Q (dQ = dS K) directly, the
//     rows of each 8-wide k-step permuted (position t <-> row 2t, t + 4 <->
//     2t + 1) so that the accumulator layout is the operand layout;
//   * the streamed tiles (Q, dO, lse and delta in dkdv; K and V in dq) are
//     double-buffered through shared memory with cp.async, so the next
//     tile's copy overlaps this tile's products; rows are padded to D + 4
//     floats, which keeps both fragment patterns that read them (row g,
//     column t; row 2t, column g) free of bank conflicts.  Each warp splits
//     what it reads: splitting a step's tile once into hi and lo planes in
//     shared memory doubled the loads and measured slower;
//   * masks are applied only to the tiles that need them, and causal or
//     windowed tiles no row sees are skipped; the heaviest tiles go first;
//   * where a kernel's grid is short of two waves, each block walks one
//     chunk of its steps and writes float32 partial sums, which a small
//     pass adds in a fixed order (flash_attention_bwd_chunks says how
//     many chunks): dq's key walk for a short query set (whisper's
//     cross-attention: 64 queries over 1500 keys, 48 blocks), dkdv's walk
//     over a group's heads and query tiles where there are few KV heads
//     (internvl: 8 KV heads of 6 query heads each, 192 blocks);
//   * the long sums (dK and dV over every query of a group, dQ over every
//     key) are added in float32, JG k-steps at a time, not inside the
//     tensor cores (add4);
//   * at D = 256 a warp's dK and dV (16 x 256 each) would not fit its
//     registers: two warps share each 16 keys, each computing S^T and dP^T
//     for half of the step's queries and accumulating half of the
//     dimensions; they trade their P^T and dS^T fragments through shared
//     memory.
// float32 or bfloat16 in and out, everything in between float32.
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
// a split walk's chunks hold at least this many steps (tiles)
constexpr int CHUNK_MIN_STEPS = 2;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, S), base 2
  float* delta;      // (B, live, S) scratch
  float* part_q;     // (q_chunks, B, H, S, D) partial dQ, q_chunks > 1
  float* part_kv;    // (2, kv_chunks, B, Hkv, T, D) partial dK, dV
  void* dq;
  void* dk;
  void* dv;
  int B, H, Hkv, S, T, live, causal, window;  // window 0: none
  int q_chunks, kv_chunks;
  float scale;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_st, v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_ss, do_sb, do_sh, do_ss;
  long long dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_st, dv_sb, dv_sh, dv_st;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&lo);
  raw.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 4 : 0)
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

// Rows [row0, row0 + 16 NG) of a (rows, D) matrix as the A-fragments of
// mma.m16n8k8 in natural k order: entry [grp][kk][lane] is the float4
// (A[g][t], A[g + 8][t], A[g][t + 4], A[g + 8][t + 4]) of rows 16 grp ..,
// dimensions 8 kk .. (g = lane / 4, t = lane % 4); rows at or past
// `nvalid` are zeros.
template <int D, int NG, int NT, typename T>
__device__ __forceinline__ void stage_frags(float4* dst, const T* src,
                                            long long stride, int row0,
                                            int nvalid, int tid) {
  constexpr int KS = D / 8;
  for (int idx = tid; idx < NG * KS * 32; idx += NT) {
    const int lane = idx & 31;
    const int kk = (idx >> 5) % KS;
    const int grp = (idx >> 5) / KS;
    const int r0 = row0 + grp * 16 + (lane >> 2);
    const int r1 = r0 + 8;
    const int c = kk * 8 + (lane & 3);
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 < nvalid) {
      x[0] = to_f32(src[r0 * stride + c]);
      x[2] = to_f32(src[r0 * stride + c + 4]);
    }
    if (r1 < nvalid) {
      x[1] = to_f32(src[r1 * stride + c]);
      x[3] = to_f32(src[r1 * stride + c + 4]);
    }
    dst[idx] = make_float4(x[0], x[1], x[2], x[3]);
  }
}

// x ~ hi + lo: hi is x rounded to TF32 (to nearest, ties away), lo the
// exact float32 rest truncated to TF32, |x - hi - lo| <= 2^-21 |x|; integer
// and FP32 ops in place of cvt.rna.tf32.f32 (the forward's split)
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

// c += d in float32 (round to nearest).  The long sums (dK, dV over every
// query of a group, dQ over every key) add the products of JG k-steps,
// summed on the tensor cores from zero, to their accumulator this way:
// the tensor cores' own accumulation is not round to nearest, and
// hundreds of k-steps into one accumulator drifted to 3-4e-5 of the
// gradient's largest at the train shapes, in proportion to their count.
__device__ __forceinline__ void add4(float (&c)[4], const float (&d)[4]) {
  c[0] += d[0];
  c[1] += d[1];
  c[2] += d[2];
  c[3] += d[3];
}

// an A-fragment of the fixed operand, split
__device__ __forceinline__ void split_frag(float4 x, uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split_tf32(x.x, hi[0], lo[0]);
  split_tf32(x.y, hi[1], lo[1]);
  split_tf32(x.z, hi[2], lo[2]);
  split_tf32(x.w, hi[3], lo[3]);
}

// an accumulator fragment (row g: columns 2t, 2t + 1; row g + 8: the
// same) as the A-fragment of the next product, k positions (t, t + 4) =
// columns (2t, 2t + 1), split
__device__ __forceinline__ void split_acc(const float (&c)[4],
                                          uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
  split_tf32(c[0], hi[0], lo[0]);
  split_tf32(c[2], hi[1], lo[1]);
  split_tf32(c[1], hi[2], lo[2]);
  split_tf32(c[3], hi[3], lo[3]);
}

// the B-fragment (B[t][g], B[t + 4][g]) from two floats, split
__device__ __forceinline__ void split_b(float x0, float x1, uint32_t (&hi)[2],
                                        uint32_t (&lo)[2]) {
  split_tf32(x0, hi[0], lo[0]);
  split_tf32(x1, hi[1], lo[1]);
}

// whether query row r (position r + off when causal) of S sees key t of nk
__device__ __forceinline__ bool visible(int r, int t, int S, int nk, int off,
                                        int causal, int window) {
  if (r >= S || t >= nk) return false;
  if (!causal) return true;
  return t <= r + off && (window <= 0 || t > r + off - window);
}

// ---------------------------------------------------------------------------
// delta = rowsum(dO * O): one warp a row, rows of the live heads
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(
    const BwdArgs a, int D) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (256 / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const long long rows = static_cast<long long>(a.B) * a.live * a.S;
  if (row >= rows) return;
  const int s = static_cast<int>(row % a.S);
  const int h = static_cast<int>((row / a.S) % a.live);
  const int b = static_cast<int>(row / (static_cast<long long>(a.S) * a.live));
  const T* o = static_cast<const T*>(a.o) + b * a.o_sb + h * a.o_sh +
               s * a.o_ss;
  const T* d = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh +
               s * a.do_ss;
  float acc = 0.0f;
  for (int c = lane; c < D; c += 32) acc = fmaf(to_f32(o[c]), to_f32(d[c]), acc);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) a.delta[row] = acc;
}

// ---------------------------------------------------------------------------
// dK, dV: one block per (key tile, KV head, batch row)
// ---------------------------------------------------------------------------

// WK warps of 16 keys (BK = 16 WK keys a block), NDS warps sharing each 16
// keys (each computing S^T and dP^T for BQ / NDS of the step's queries and
// accumulating D / NDS dimensions of dK and dV), BQ queries a step; sized
// so that a block stays within 227 KB and, up to D = 128, two share an SM
template <int D>
struct KvCfg;
template <>
struct KvCfg<16> {
  static constexpr int WK = 4, NDS = 1, BQ = 64;
};
template <>
struct KvCfg<64> {
  static constexpr int WK = 4, NDS = 1, BQ = 32;
};
template <>
struct KvCfg<128> {
  static constexpr int WK = 4, NDS = 1, BQ = 16;
};
template <>
struct KvCfg<256> {
  static constexpr int WK = 4, NDS = 2, BQ = 16;
};

// shared memory of the dkdv kernel, in floats
template <int D>
struct KvSmem {
  using C = KvCfg<D>;
  static constexpr int BK = 16 * C::WK;
  static constexpr int NT = 32 * C::WK * C::NDS;
  static constexpr int LD = D + 4;                // padded Q, dO row
  static constexpr int kK = 0;                    // fragments [WK][D/8][32]
  static constexpr int kV = kK + BK * D;          // the same
  static constexpr int kQ = kV + BK * D;          // [buf][BQ][LD]
  static constexpr int kdO = kQ + 2 * C::BQ * LD;  // [buf][BQ][LD]
  static constexpr int kL = kdO + 2 * C::BQ * LD;  // lse [buf][BQ]
  static constexpr int kDel = kL + 2 * C::BQ;      // delta [buf][BQ]
  // NDS > 1: P^T and dS^T fragments [WK][BQ / 8][32] each, exchanged
  // between the warps that share 16 keys
  static constexpr int kX = kDel + 2 * C::BQ;
  static constexpr int kXsize = C::NDS > 1 ? 2 * BK * C::BQ : 0;
  static constexpr size_t bytes = sizeof(float) * (kX + kXsize);
};

template <typename T, int D>
__global__ void __launch_bounds__(KvSmem<D>::NT)
flash_bwd_dkdv_kernel(const BwdArgs a) {
  using C = KvCfg<D>;
  using M = KvSmem<D>;
  constexpr int BK = M::BK, BQ = C::BQ, NT = M::NT, LD = M::LD;
  constexpr int KS = D / 8;         // k-steps of S^T and dP^T
  constexpr int NQ = BQ / 8;        // k-steps of dV and dK
  constexpr int NQW = NQ / C::NDS;  // query n-tiles of S^T, dP^T a warp has
  constexpr int DA = D / C::NDS;    // dimensions of dK, dV a warp holds
  constexpr int ND = DA / 8;        // their n-tiles
  constexpr int JG = NQ < 4 ? NQ : 4;  // k-steps summed before add4
  static_assert(M::bytes <= 232448, "shared memory");
  extern __shared__ __align__(16) float smem[];
  float4* fK = reinterpret_cast<float4*>(smem + M::kK);
  float4* fV = reinterpret_cast<float4*>(smem + M::kV);
  float* sQ = smem + M::kQ;
  float* sdO = smem + M::kdO;
  float* sL = smem + M::kL;
  float* sDel = smem + M::kDel;
  float4* xP = reinterpret_cast<float4*>(smem + M::kX);
  float4* xdS = xP + C::WK * NQ * 32;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kg = warp % C::WK;          // the warp's 16 keys
  const int part = warp / C::WK;        // its share of queries and of D
  const int da = part * DA;             // its first dimension of dK, dV
  const int qa = part * NQW * 8;        // its first query of S^T, dP^T
  const int per = a.Hkv * a.B * a.kv_chunks;
  const int k0 = (blockIdx.x / per) * BK;  // heavy (causal: low) tiles first
  const int chunk = (blockIdx.x % per) % a.kv_chunks;
  const int hk = (blockIdx.x % per) / a.kv_chunks % a.Hkv;
  const int b = (blockIdx.x % per) / a.kv_chunks / a.Hkv;
  const int S = a.S, nk = a.T;
  const int G = a.live / a.Hkv;
  const int off = nk - S;  // causal: query s is position s + off

  // the queries that see a key of this tile, in query tiles
  int qlo = 0, qhi = S;
  if (a.causal) {
    qlo = max(0, k0 - off);
    if (a.window > 0) qhi = min(S, k0 + BK - 1 - off + a.window);
  }
  const int qt0 = qlo / BQ;
  const int nqt = qhi > qlo ? (qhi - 1) / BQ + 1 - qt0 : 0;
  // (head of the group, query tile) in order, this block's chunk of them
  const int per_c = (G * nqt + a.kv_chunks - 1) / a.kv_chunks;
  const int i0 = chunk * per_c;
  const int i1 = min(G * nqt, i0 + per_c);

  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb;
  const T* dob = static_cast<const T*>(a.dout) + b * a.do_sb;
  auto stage = [&](int i, int buf) {
    const int h = hk * G + i / nqt;
    const int q0 = (qt0 + i % nqt) * BQ;
    stage_rows<D, BQ, LD, NT>(sQ + buf * BQ * LD, qb + h * a.q_sh, a.q_ss, q0,
                              S, tid);
    stage_rows<D, BQ, LD, NT>(sdO + buf * BQ * LD, dob + h * a.do_sh,
                              a.do_ss, q0, S, tid);
    const float* lse = a.lse + (static_cast<long long>(b) * a.H + h) * S;
    const float* del = a.delta + (static_cast<long long>(b) * a.live + h) * S;
    for (int r = tid; r < BQ; r += NT) {
      const bool ok = q0 + r < S;
      cp_async4(sL + buf * BQ + r, ok ? lse + q0 + r : lse, ok);
      cp_async4(sDel + buf * BQ + r, ok ? del + q0 + r : del, ok);
    }
  };
  if (i0 < i1) stage(i0, 0);
  cp_async_commit();
  stage_frags<D, C::WK, NT>(
      fK, static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh, a.k_st, k0,
      nk, tid);
  stage_frags<D, C::WK, NT>(
      fV, static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh, a.v_st, k0,
      nk, tid);

  float dK[ND][4], dV[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dK[n][e] = dV[n][e] = 0.0f;
  const float c2 = a.scale * LOG2E;
  const int kw = k0 + kg * 16;  // the warp's first key
  const float4* myK = fK + kg * KS * 32 + lane;
  const float4* myV = fV + kg * KS * 32 + lane;

  for (int i = i0; i < i1; ++i) {
    const int buf = (i - i0) & 1;
    if (i + 1 < i1) stage(i + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of step i have landed
    __syncthreads();     // ... and everyone's
    const float* tQ = sQ + buf * BQ * LD;
    const float* tdO = sdO + buf * BQ * LD;
    const float* tL = sL + buf * BQ;
    const float* tDel = sDel + buf * BQ;
    const int q0 = (qt0 + i % nqt) * BQ;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x BQ / NDS queries a warp
    float s[NQW][4], dp[NQW][4];
#pragma unroll
    for (int n = 0; n < NQW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll 2
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t k_hi[4], k_lo[4], v_hi[4], v_lo[4];
      split_frag(myK[kk * 32], k_hi, k_lo);
      split_frag(myV[kk * 32], v_hi, v_lo);
#pragma unroll
      for (int n = 0; n < NQW; ++n) {
        const int at = (qa + n * 8 + g) * LD + kk * 8 + t;
        uint32_t b_hi[2], b_lo[2];
        split_b(tQ[at], tQ[at + 4], b_hi, b_lo);
        mma_3xtf32(s[n], k_hi, k_lo, b_hi, b_lo);
        split_b(tdO[at], tdO[at + 4], b_hi, b_lo);
        mma_3xtf32(dp[n], v_hi, v_lo, b_hi, b_lo);
      }
    }

    // P^T and dS^T in place: fragment (n, e) is key kw + g (+ 8 for
    // e >= 2) and query q0 + qa + 8n + 2t + (e & 1); a tile that every
    // pair of the block sees skips the mask
    const bool whole =
        kw + 16 <= nk && q0 + BQ <= S &&
        (!a.causal || (kw + 15 <= q0 + off &&
                       (a.window <= 0 || kw > q0 + BQ - 1 + off - a.window)));
#pragma unroll
    for (int n = 0; n < NQW; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = qa + n * 8 + 2 * t + (e & 1);
        const bool ok =
            whole || visible(q0 + ql, kw + g + (e >> 1) * 8, S, nk, off,
                             a.causal, a.window);
        const float p = ok ? exp2f(s[n][e] * c2 - tL[ql]) : 0.0f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - tDel[ql]);
      }
    }

    // the warps sharing 16 keys trade their P^T, dS^T fragments
    if constexpr (C::NDS > 1) {
#pragma unroll
      for (int n = 0; n < NQW; ++n) {
        const int at = (kg * NQ + part * NQW + n) * 32 + lane;
        xP[at] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
        xdS[at] = make_float4(dp[n][0], dp[n][1], dp[n][2], dp[n][3]);
      }
      __syncthreads();
    }

    // dV += P^T dO, dK += dS^T Q over this warp's DA dimensions, JG
    // k-steps (8 queries each) at a time
#pragma unroll
    for (int j0 = 0; j0 < NQ; j0 += JG) {
      uint32_t p_hi[JG][4], p_lo[JG][4], d_hi[JG][4], d_lo[JG][4];
#pragma unroll
      for (int jj = 0; jj < JG; ++jj) {
        if constexpr (C::NDS > 1) {
          const float4 x = xP[(kg * NQ + j0 + jj) * 32 + lane];
          const float4 y = xdS[(kg * NQ + j0 + jj) * 32 + lane];
          const float pj[4] = {x.x, x.y, x.z, x.w};
          const float dj[4] = {y.x, y.y, y.z, y.w};
          split_acc(pj, p_hi[jj], p_lo[jj]);
          split_acc(dj, d_hi[jj], d_lo[jj]);
        } else {
          split_acc(s[j0 + jj], p_hi[jj], p_lo[jj]);
          split_acc(dp[j0 + jj], d_hi[jj], d_lo[jj]);
        }
      }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        float tv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float tk[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int jj = 0; jj < JG; ++jj) {
          const int at = ((j0 + jj) * 8 + 2 * t) * LD + da + n * 8 + g;
          uint32_t b_hi[2], b_lo[2];
          split_b(tdO[at], tdO[at + LD], b_hi, b_lo);
          mma_3xtf32(tv, p_hi[jj], p_lo[jj], b_hi, b_lo);
          split_b(tQ[at], tQ[at + LD], b_hi, b_lo);
          mma_3xtf32(tk, d_hi[jj], d_lo[jj], b_hi, b_lo);
        }
        add4(dV[n], tv);
        add4(dK[n], tk);
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

  const int key0 = kw + g, key1 = key0 + 8;
  if (a.kv_chunks > 1) {  // this chunk's partial sums, float32, unscaled
    const long long dv_off = static_cast<long long>(a.kv_chunks) * a.B *
                             a.Hkv * nk * D;  // dV's partials follow dK's
    float* pk = a.part_kv + ((static_cast<long long>(chunk) * a.B + b) *
                                 a.Hkv + hk) * static_cast<long long>(nk) * D;
#pragma unroll
    for (int n8 = 0; n8 < ND; ++n8) {
      const int c = da + n8 * 8 + 2 * t;
      if (key0 < nk) {
        store2(pk + static_cast<long long>(key0) * D + c, dK[n8][0],
               dK[n8][1]);
        store2(pk + dv_off + static_cast<long long>(key0) * D + c, dV[n8][0],
               dV[n8][1]);
      }
      if (key1 < nk) {
        store2(pk + static_cast<long long>(key1) * D + c, dK[n8][2],
               dK[n8][3]);
        store2(pk + dv_off + static_cast<long long>(key1) * D + c, dV[n8][2],
               dV[n8][3]);
      }
    }
    return;
  }
  T* dk = static_cast<T*>(a.dk) + b * a.dk_sb + hk * a.dk_sh;
  T* dv = static_cast<T*>(a.dv) + b * a.dv_sb + hk * a.dv_sh;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = da + n * 8 + 2 * t;
    if (key0 < nk) {
      store2(dk + key0 * a.dk_st + c, dK[n][0] * a.scale,
             dK[n][1] * a.scale);
      store2(dv + key0 * a.dv_st + c, dV[n][0], dV[n][1]);
    }
    if (key1 < nk) {
      store2(dk + key1 * a.dk_st + c, dK[n][2] * a.scale,
             dK[n][3] * a.scale);
      store2(dv + key1 * a.dv_st + c, dV[n][2], dV[n][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per (query tile, batch row x head, chunk of its key tiles)
// ---------------------------------------------------------------------------

// WQ warps of 16 queries (BQ = 16 WQ), BK keys a step
template <int D>
struct QCfg;
template <>
struct QCfg<16> {
  static constexpr int WQ = 4, BK = 64;
};
template <>
struct QCfg<64> {
  static constexpr int WQ = 4, BK = 32;
};
template <>
struct QCfg<128> {
  static constexpr int WQ = 4, BK = 16;
};
template <>
struct QCfg<256> {
  static constexpr int WQ = 4, BK = 16;
};

// shared memory of the dq kernel, in floats
template <int D>
struct QSmem {
  using C = QCfg<D>;
  static constexpr int BQ = 16 * C::WQ;
  static constexpr int NT = 32 * C::WQ;
  static constexpr int LD = D + 4;                // padded K, V row
  static constexpr int kQ = 0;                    // fragments [WQ][D/8][32]
  static constexpr int kdO = kQ + BQ * D;         // the same
  static constexpr int kK = kdO + BQ * D;         // [buf][BK][LD]
  static constexpr int kV = kK + 2 * C::BK * LD;  // [buf][BK][LD]
  static constexpr size_t bytes = sizeof(float) * (kV + 2 * C::BK * LD);
};

template <typename T, int D>
__global__ void __launch_bounds__(QSmem<D>::NT)
flash_bwd_dq_kernel(const BwdArgs a) {
  using C = QCfg<D>;
  using M = QSmem<D>;
  constexpr int BK = C::BK, BQ = M::BQ, NT = M::NT, LD = M::LD;
  constexpr int KS = D / 8;   // k-steps of S and dP; n-tiles of dQ
  constexpr int NK = BK / 8;  // key n-tiles of S and dP: k-steps of dQ
  constexpr int JG = NK < 4 ? NK : 4;  // k-steps summed before add4
  static_assert(M::bytes <= 232448, "shared memory");
  extern __shared__ __align__(16) float smem[];
  float4* fQ = reinterpret_cast<float4*>(smem + M::kQ);
  float4* fdO = reinterpret_cast<float4*>(smem + M::kdO);
  float* sK = smem + M::kK;
  float* sV = smem + M::kV;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int per = a.B * a.H * a.q_chunks;
  const int n_qt = (a.S + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / per) *
                 BQ;  // heavy (causal: late) tiles first
  const int chunk = (blockIdx.x % per) % a.q_chunks;
  const int bh = (blockIdx.x % per) / a.q_chunks;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int S = a.S, nk = a.T;
  const int off = nk - S;
  const int qw = q0 + warp * 16;  // the warp's first query
  const int r0 = qw + g, r1 = r0 + 8;

  float dQ[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dQ[n][e] = 0.0f;

  if (h < a.live) {
    const int hk = h / (a.live / a.Hkv);
    const T* k = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
    const T* v = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
    // the key tiles this tile's queries see, and this block's chunk of them
    int klo = 0, khi = nk;
    if (a.causal) {
      khi = min(nk, min(q0 + BQ, S) + off);
      if (a.window > 0) klo = max(0, q0 + off - a.window + 1);
    }
    const int kt_lo = klo / BK;
    const int kt_hi = khi > klo ? (khi + BK - 1) / BK : kt_lo;
    const int per_c = (kt_hi - kt_lo + a.q_chunks - 1) / a.q_chunks;
    const int it0 = kt_lo + chunk * per_c;
    const int it1 = min(kt_hi, it0 + per_c);

    if (it0 < it1) {
      stage_rows<D, BK, LD, NT>(sK, k, a.k_st, it0 * BK, nk, tid);
      stage_rows<D, BK, LD, NT>(sV, v, a.v_st, it0 * BK, nk, tid);
    }
    cp_async_commit();
    stage_frags<D, C::WQ, NT>(
        fQ, static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh, a.q_ss, q0,
        S, tid);
    stage_frags<D, C::WQ, NT>(
        fdO, static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh,
        a.do_ss, q0, S, tid);
    const float* lse = a.lse + (static_cast<long long>(b) * a.H + h) * S;
    const float* del = a.delta + (static_cast<long long>(b) * a.live + h) * S;
    const float l0 = r0 < S ? lse[r0] : 0.0f, l1 = r1 < S ? lse[r1] : 0.0f;
    const float e0 = r0 < S ? del[r0] : 0.0f, e1 = r1 < S ? del[r1] : 0.0f;
    const float c2 = a.scale * LOG2E;
    const float4* myQ = fQ + warp * KS * 32 + lane;
    const float4* mydO = fdO + warp * KS * 32 + lane;

    for (int it = it0; it < it1; ++it) {
      const int buf = (it - it0) & 1;
      if (it + 1 < it1) {
        stage_rows<D, BK, LD, NT>(sK + (buf ^ 1) * BK * LD, k, a.k_st,
                                  (it + 1) * BK, nk, tid);
        stage_rows<D, BK, LD, NT>(sV + (buf ^ 1) * BK * LD, v, a.v_st,
                                  (it + 1) * BK, nk, tid);
      }
      cp_async_commit();
      cp_async_wait<1>();  // this thread's copies of tile `it` have landed
      __syncthreads();     // ... and everyone's
      const float* tK = sK + buf * BK * LD;
      const float* tV = sV + buf * BK * LD;
      const int k0 = it * BK;

      // S = Q K^T and dP = dO V^T: 16 queries x BK keys a warp
      float s[NK][4], dp[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll 2
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t q_hi[4], q_lo[4], o_hi[4], o_lo[4];
        split_frag(myQ[kk * 32], q_hi, q_lo);
        split_frag(mydO[kk * 32], o_hi, o_lo);
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          const int at = (n * 8 + g) * LD + kk * 8 + t;
          uint32_t b_hi[2], b_lo[2];
          split_b(tK[at], tK[at + 4], b_hi, b_lo);
          mma_3xtf32(s[n], q_hi, q_lo, b_hi, b_lo);
          split_b(tV[at], tV[at + 4], b_hi, b_lo);
          mma_3xtf32(dp[n], o_hi, o_lo, b_hi, b_lo);
        }
      }

      // dS in place: fragment (n, e) is query r0 (r1 for e >= 2) and key
      // k0 + 8n + 2t + (e & 1); a tile that every pair of the warp sees
      // skips the mask
      const bool whole =
          k0 + BK <= nk && qw + 16 <= S &&
          (!a.causal || (k0 + BK - 1 <= qw + off &&
                         (a.window <= 0 || k0 > qw + 15 + off - a.window)));
#pragma unroll
      for (int n = 0; n < NK; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? r0 : r1;
          const bool ok = whole || visible(row, k0 + n * 8 + 2 * t + (e & 1),
                                           S, nk, off, a.causal, a.window);
          const float p = ok ? exp2f(s[n][e] * c2 - (e < 2 ? l0 : l1))
                             : 0.0f;
          dp[n][e] = p * (dp[n][e] - (e < 2 ? e0 : e1));
        }
      }

      // dQ += dS K, JG k-steps (8 keys each) at a time
#pragma unroll
      for (int j0 = 0; j0 < NK; j0 += JG) {
        uint32_t d_hi[JG][4], d_lo[JG][4];
#pragma unroll
        for (int jj = 0; jj < JG; ++jj)
          split_acc(dp[j0 + jj], d_hi[jj], d_lo[jj]);
#pragma unroll
        for (int n = 0; n < KS; ++n) {
          float tq[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int jj = 0; jj < JG; ++jj) {
            const int at = ((j0 + jj) * 8 + 2 * t) * LD + n * 8 + g;
            uint32_t b_hi[2], b_lo[2];
            split_b(tK[at], tK[at + LD], b_hi, b_lo);
            mma_3xtf32(tq, d_hi[jj], d_lo[jj], b_hi, b_lo);
          }
          add4(dQ[n], tq);
        }
      }
      __syncthreads();  // every warp is done with `buf` before it is refilled
    }
  }

  if (a.q_chunks > 1) {  // this chunk's partial sum, float32, unscaled
    float* dst = a.part_q + ((static_cast<long long>(chunk) * a.B + b) * a.H +
                           h) * static_cast<long long>(S) * D;
#pragma unroll
    for (int n = 0; n < KS; ++n) {
      const int c = n * 8 + 2 * t;
      if (r0 < S) store2(dst + static_cast<long long>(r0) * D + c, dQ[n][0],
                         dQ[n][1]);
      if (r1 < S) store2(dst + static_cast<long long>(r1) * D + c, dQ[n][2],
                         dQ[n][3]);
    }
    return;
  }
  T* dq = static_cast<T*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
#pragma unroll
  for (int n = 0; n < KS; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < S)
      store2(dq + r0 * a.dq_ss + c, dQ[n][0] * a.scale, dQ[n][1] * a.scale);
    if (r1 < S)
      store2(dq + r1 * a.dq_ss + c, dQ[n][2] * a.scale, dQ[n][3] * a.scale);
  }
}

// the sum of `chunks` float32 partials `n4` float4s apart, in chunk order
__device__ __forceinline__ float4 sum_chunks(const float* part, int chunks,
                                             long long n4, long long i) {
  const float4* p = reinterpret_cast<const float4*>(part);
  float4 acc = p[i];
  for (int c = 1; c < chunks; ++c) {
    const float4 x = p[c * n4 + i];
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  return acc;
}

__device__ __forceinline__ float4 mul4(float4 x, float m) {
  return make_float4(x.x * m, x.y * m, x.z * m, x.w * m);
}

// dQ = scale * the dq chunks' partial sums: one thread per 4 elements
template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_dq_sum_kernel(
    const BwdArgs a, int D) {
  const long long n4 = static_cast<long long>(a.B) * a.H * a.S * D / 4;
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n4) return;
  const float4 acc = sum_chunks(a.part_q, a.q_chunks, n4, i);
  const int d = static_cast<int>((i * 4) % D);
  const long long row = i * 4 / D;  // (b, h, s)
  const int s = static_cast<int>(row % a.S);
  const int h = static_cast<int>((row / a.S) % a.H);
  const int b = static_cast<int>(row / (static_cast<long long>(a.S) * a.H));
  store4(static_cast<T*>(a.dq) + b * a.dq_sb + h * a.dq_sh + s * a.dq_ss + d,
         mul4(acc, a.scale));
}

// dK = scale * and dV = the dkdv chunks' partial sums: one thread per 4
// elements of each
template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_kv_sum_kernel(
    const BwdArgs a, int D) {
  const long long n4 = static_cast<long long>(a.B) * a.Hkv * a.T * D / 4;
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n4) return;
  const float4 k = sum_chunks(a.part_kv, a.kv_chunks, n4, i);
  const float4 v =
      sum_chunks(a.part_kv + 4 * a.kv_chunks * n4, a.kv_chunks, n4, i);
  const int d = static_cast<int>((i * 4) % D);
  const long long row = i * 4 / D;  // (b, hk, t)
  const int t = static_cast<int>(row % a.T);
  const int hk = static_cast<int>((row / a.T) % a.Hkv);
  const int b = static_cast<int>(row / (static_cast<long long>(a.T) * a.Hkv));
  store4(static_cast<T*>(a.dk) + b * a.dk_sb + hk * a.dk_sh + t * a.dk_st + d,
         mul4(k, a.scale));
  store4(static_cast<T*>(a.dv) + b * a.dv_sb + hk * a.dv_sh + t * a.dv_st + d,
         v);
}

// above 48 KB a block's shared memory must be asked for, once per kernel
template <typename T, int D>
cudaError_t prepare() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(KvSmem<D>::bytes));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(QSmem<D>::bytes));
  }();
  return err;
}

// how many chunks a kernel of `blocks` blocks (each walking at most
// `steps` steps) splits its walk into: 1 when its grid fills two waves of
// the card, else enough chunks to do so, of at least CHUNK_MIN_STEPS steps
int split(long long blocks, int per_sm, int steps) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const long long want = 2LL * sms * (per_sm > 0 ? per_sm : 1);
  if (blocks <= 0 || blocks >= want) return 1;
  const long long most =
      steps / CHUNK_MIN_STEPS > 1 ? steps / CHUNK_MIN_STEPS : 1;
  const long long c = (want + blocks - 1) / blocks < most
                          ? (want + blocks - 1) / blocks
                          : most;
  const int per = static_cast<int>((steps + c - 1) / c);
  return (steps + per - 1) / per;
}

// the chunks of the dq kernel (kv = 0) or the dkdv kernel (kv = 1) at
// this shape; a negative cudaError_t on failure
template <typename T, int D>
int chunks(int B, int Hkv, int live, int S, int T_len, int kv) {
  cudaError_t err = prepare<T, D>();
  int per_sm = 0;
  if (err == cudaSuccess)
    err = kv ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &per_sm, flash_bwd_dkdv_kernel<T, D>, KvSmem<D>::NT,
                   KvSmem<D>::bytes)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &per_sm, flash_bwd_dq_kernel<T, D>, QSmem<D>::NT,
                   QSmem<D>::bytes);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int n_qt = (S + QSmem<D>::BQ - 1) / QSmem<D>::BQ;
  const int n_kt = (T_len + QCfg<D>::BK - 1) / QCfg<D>::BK;
  if (!kv) return split(static_cast<long long>(n_qt) * B * live, per_sm, n_kt);
  const int kv_tiles = (T_len + KvSmem<D>::BK - 1) / KvSmem<D>::BK;
  const int kv_steps = (live / Hkv) * ((S + KvCfg<D>::BQ - 1) / KvCfg<D>::BQ);
  return split(static_cast<long long>(kv_tiles) * Hkv * B, per_sm, kv_steps);
}

template <typename T, int D>
int launch(const BwdArgs& a, cudaStream_t st) {
  cudaError_t err = prepare<T, D>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(a.B) * a.live * a.S;
  if (rows > 0) {
    const long long blocks = (rows + 7) / 8;
    flash_bwd_delta_kernel<T><<<static_cast<unsigned>(blocks), 256, 0, st>>>(
        a, D);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long kv_blocks =
      static_cast<long long>((a.T + KvSmem<D>::BK - 1) / KvSmem<D>::BK) *
      a.Hkv * a.B * a.kv_chunks;
  flash_bwd_dkdv_kernel<T, D>
      <<<static_cast<unsigned>(kv_blocks), KvSmem<D>::NT, KvSmem<D>::bytes,
         st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.kv_chunks > 1) {
    const long long n4 = static_cast<long long>(a.B) * a.Hkv * a.T * D / 4;
    flash_bwd_kv_sum_kernel<T>
        <<<static_cast<unsigned>((n4 + 255) / 256), 256, 0, st>>>(a, D);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long q_blocks =
      static_cast<long long>((a.S + QSmem<D>::BQ - 1) / QSmem<D>::BQ) * a.B *
      a.H * a.q_chunks;
  flash_bwd_dq_kernel<T, D>
      <<<static_cast<unsigned>(q_blocks), QSmem<D>::NT, QSmem<D>::bytes, st>>>(
          a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.q_chunks == 1) return static_cast<int>(err);
  const long long n4 = static_cast<long long>(a.B) * a.H * a.S * D / 4;
  flash_bwd_dq_sum_kernel<T>
      <<<static_cast<unsigned>((n4 + 255) / 256), 256, 0, st>>>(a, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const BwdArgs& a, int D, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(a, st);
    case 64: return launch<T, 64>(a, st);
    case 128: return launch<T, 128>(a, st);
    case 256: return launch<T, 256>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int chunks_d(int B, int Hkv, int live, int S, int T_len, int D, int kv) {
  switch (D) {
    case 16: return chunks<T, 16>(B, Hkv, live, S, T_len, kv);
    case 64: return chunks<T, 64>(B, Hkv, live, S, T_len, kv);
    case 128: return chunks<T, 128>(B, Hkv, live, S, T_len, kv);
    case 256: return chunks<T, 256>(B, Hkv, live, S, T_len, kv);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The number of chunks the dq kernel (kv = 0) or the dkdv kernel (kv = 1)
// splits its walk into at this shape on the current device (1: no split,
// and no scratch needed); a negative cudaError_t on failure.
extern "C" int flash_attention_bwd_chunks(int B, int Hkv, int live, int S,
                                          int T, int D, int bf16, int kv) {
  if (bf16) return chunks_d<__nv_bfloat16>(B, Hkv, live, S, T, D, kv);
  return chunks_d<float>(B, Hkv, live, S, T, D, kv);
}

// q, o, dout, dq (B, H, S, D); k, v, dk, dv (B, Hkv, T, D); each by its
// (b, h, row) strides in elements with unit stride along D and every row
// 16-byte aligned; all float32 (bf16 = 0) or all bfloat16 (bf16 = 1); lse
// float32 (B, H, S) contiguous, the forward's base-2 log-sum-exp; delta
// float32 scratch of B * live * S; `q_chunks` and `kv_chunks` what
// flash_attention_bwd_chunks gives for this shape and, where one is above
// 1, `part_q` float32 scratch of q_chunks * B * H * S * D and `part_kv` of
// 2 * kv_chunks * B * Hkv * T * D (16-byte aligned);
// D in {16, 64, 128, 256}; Hkv divides live <= H; T >= S when causal;
// window > 0 (causal only) as the forward's.  Every element of dq, dk and
// dv is written.  Returns the cudaError_t of the launches (0 on success).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* part_q,
    void* part_kv, void* dq, void* dk, void* dv, int B, int H, int Hkv, int S,
    int T, int live, int D, int causal, int window, int q_chunks,
    int kv_chunks, float scale, int bf16, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_st, long long v_sb, long long v_sh, long long v_st,
    long long o_sb, long long o_sh, long long o_ss, long long do_sb,
    long long do_sh, long long do_ss, long long dq_sb, long long dq_sh,
    long long dq_ss, long long dk_sb, long long dk_sh, long long dk_st,
    long long dv_sb, long long dv_sh, long long dv_st, void* stream) {
  if (q_chunks < 1 || kv_chunks < 1 || (q_chunks > 1 && part_q == nullptr) ||
      (kv_chunks > 1 && part_kv == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.part_q = static_cast<float*>(part_q);
  a.part_kv = static_cast<float*>(part_kv);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.S = S;
  a.T = T;
  a.live = live;
  a.causal = causal;
  a.window = window;
  a.q_chunks = q_chunks;
  a.kv_chunks = kv_chunks;
  a.scale = scale;
  a.q_sb = q_sb, a.q_sh = q_sh, a.q_ss = q_ss;
  a.k_sb = k_sb, a.k_sh = k_sh, a.k_st = k_st;
  a.v_sb = v_sb, a.v_sh = v_sh, a.v_st = v_st;
  a.o_sb = o_sb, a.o_sh = o_sh, a.o_ss = o_ss;
  a.do_sb = do_sb, a.do_sh = do_sh, a.do_ss = do_ss;
  a.dq_sb = dq_sb, a.dq_sh = dq_sh, a.dq_ss = dq_ss;
  a.dk_sb = dk_sb, a.dk_sh = dk_sh, a.dk_st = dk_st;
  a.dv_sb = dv_sb, a.dv_sh = dv_sh, a.dv_st = dv_st;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_d<__nv_bfloat16>(a, D, st);
  return launch_d<float>(a, D, st);
}
