// K5 backward as it was before its redesign for the tensor cores: every
// product float32 FMAs on the CUDA cores, P and dS through shared memory,
// synchronous staging.  Kept for tools/kernel_variants.py (group k5bwd);
// its entry points take the committed kernel's arguments (the chunks and
// their scratch unused: no walk is split here).
//
// The gradient of online-softmax (flash) attention for
// grouped-query heads, from the forward's log-sum-exp.
//
// The forward (flash_attention.cu) computes, for query heads h < live and
// their KV head h / G (G = live / Hkv, jnp.repeat order),
//
//   O = softmax(scale * Q K^T, masked) V,   lse = log2 sum_t exp2(scale *
//   log2(e) * q . k_t)  (base 2: the forward's own scaling)
//
// and this file its gradient for an upstream dO, FlashAttention-2's
// deterministic split into three launches, no atomics:
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
// What bounds it.  Five (S x T x D) products against the forward's two: at
// smollm-135m's train shape (8 x 9 live heads, S = T = 1024, D = 64,
// causal) ~24 GFLOP against ~40 MB, so it is bound by operations.  This is
// a first, simple kernel that is right: every product is float32 FMAs on
// the CUDA cores (no TF32 anywhere), register-tiled from shared memory.
//   * dkdv: one block of 256 threads per (key tile of BK keys, KV head,
//     batch row) keeps the tile's K and V transposed in shared memory and
//     loops over the group's live query heads and the query tiles of BQ
//     rows that see the tile, in a fixed order; per query tile it stages
//     Q and dO (natural and transposed), recomputes S and dP (each thread a
//     small register tile of (query, key) pairs), forms P and dS into
//     shared memory, and accumulates dV and dK in registers (each thread a
//     register tile of (key, dimension)).  The sums over the group's heads
//     and over the query tiles are a loop in one block: deterministic.
//   * dq: one block per (query tile, batch row x head) loops over the key
//     tiles it sees, recomputes S^T and dP^T, and accumulates dQ.
//   * tiles shrink with D so that a block stays under 227 KB (223 KB for the
//     dkdv block at D = 256); a thread's columns of a register tile 8 wide
//     are two 4-wide chunks D / 2 apart, which keeps its float4 reads of
//     shared memory free of bank conflicts.
// float32 or bfloat16 in and out, everything in between float32.
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;  // threads a block, every kernel
constexpr float LOG2E = 1.4426950408889634f;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, S), base 2
  float* delta;      // (B, live, S) scratch
  void* dq;
  void* dk;
  void* dv;
  int B, H, Hkv, S, T, live, causal, window;  // window 0: none
  float scale;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_st, v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_ss, do_sb, do_sh, do_ss;
  long long dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_st, dv_sb, dv_sh, dv_st;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
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

// Rows [row0, row0 + ROWS) of a (rows, D) matrix with row stride `stride`
// (elements, unit stride along D) into shared memory as float32: `nat`
// (ROWS x D, row stride LDN) and/or `tr` (D x ROWS, row stride LDT), either
// may be null.  Rows at or past `nvalid` become zeros and are not read.
// Neighbouring threads take neighbouring rows, so the transposed stores
// are conflict-free.
template <int D, int ROWS, int LDN, int LDT, typename T>
__device__ __forceinline__ void load_tile(const T* src, long long stride,
                                          int row0, int nvalid, float* nat,
                                          float* tr, int tid) {
  for (int idx = tid; idx < ROWS * (D / 4); idx += NT) {
    const int r = idx % ROWS;
    const int c = (idx / ROWS) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + r < nvalid)
      x = load4(src + static_cast<long long>(row0 + r) * stride + c);
    if (nat != nullptr) store4(nat + r * LDN + c, x);
    if (tr != nullptr) {
      tr[c * LDT + r] = x.x;
      tr[(c + 1) * LDT + r] = x.y;
      tr[(c + 2) * LDT + r] = x.z;
      tr[(c + 3) * LDT + r] = x.w;
    }
  }
}

// N floats from shared memory: 4-wide chunks SPLIT floats apart (N = 8),
// or N consecutive ones
template <int N, int SPLIT>
__device__ __forceinline__ void ldv(float (&x)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int c = 0; c < N / 4; ++c) {
      const float4 t = *reinterpret_cast<const float4*>(p + c * SPLIT);
      x[4 * c] = t.x;
      x[4 * c + 1] = t.y;
      x[4 * c + 2] = t.z;
      x[4 * c + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x;
    x[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = p[i];
  }
}

// acc[i][j] += sum_k A[k * lda + i'] * B[k * ldb + j'] over k < K: both
// operands k-major in shared memory, offset to this thread's tile; i', j'
// are i, j mapped through ldv's chunks (ASPLIT, BSPLIT)
template <int K, int TM, int TN, int ASPLIT, int BSPLIT>
__device__ __forceinline__ void mm(float (&acc)[TM][TN], const float* A,
                                   int lda, const float* B, int ldb) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float x[TM], y[TN];
    ldv<TM, ASPLIT>(x, A + k * lda);
    ldv<TN, BSPLIT>(y, B + k * ldb);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// The columns of a thread's register tile TD wide of a result D wide:
// thread group td takes TD consecutive columns, or for TD = 8 two 4-wide
// chunks D / 2 apart
template <int D, int TD>
struct Cols {
  static constexpr int kGroups = D / TD;  // thread groups along D
  static constexpr int kSplit = TD == 8 ? D / 2 : 4;
  __device__ static int base(int td) { return TD == 8 ? td * 4 : td * TD; }
};

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// a thread's TD values of one row, times `mul`, at its columns (chunks of
// 4 `split` apart, or TD consecutive ones)
template <int TD, typename T>
__device__ __forceinline__ void store_row(T* dst, const float* x, int c0,
                                          int split, float mul) {
  if constexpr (TD % 4 == 0) {
#pragma unroll
    for (int c = 0; c < TD / 4; ++c)
      store4(dst + c0 + c * split,
             make_float4(x[4 * c] * mul, x[4 * c + 1] * mul,
                         x[4 * c + 2] * mul, x[4 * c + 3] * mul));
  } else {
#pragma unroll
    for (int j = 0; j < TD; ++j) put(dst + c0 + j, x[j] * mul);
  }
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
__global__ void __launch_bounds__(NT) flash_bwd_delta_kernel(const BwdArgs a,
                                                             int D) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (NT / 32) + threadIdx.x / 32;
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

// BK keys a block, BQ queries a step; the S / dP phase gives a thread TSQ
// queries x TSK keys, the dK / dV accumulators TAK keys x TAD dimensions
template <int D>
struct KvCfg;
template <>
struct KvCfg<16> {
  static constexpr int BK = 64, BQ = 64, TSQ = 4, TSK = 4, TAK = 4, TAD = 1;
};
template <>
struct KvCfg<64> {
  static constexpr int BK = 64, BQ = 32, TSQ = 2, TSK = 4, TAK = 4, TAD = 4;
};
template <>
struct KvCfg<128> {
  static constexpr int BK = 64, BQ = 32, TSQ = 2, TSK = 4, TAK = 4, TAD = 8;
};
template <>
struct KvCfg<256> {
  static constexpr int BK = 32, BQ = 32, TSQ = 2, TSK = 2, TAK = 4, TAD = 8;
};

template <int D>
struct KvSmem {
  using C = KvCfg<D>;
  static constexpr int LDKT = C::BK + 4;  // Kt, Vt: [D][LDKT]
  static constexpr int LDQT = C::BQ + 4;  // Qt, dOt: [D][LDQT]
  static constexpr int LDN = D + 4;       // Qn, dOn: [BQ][LDN]
  static constexpr int LDP = C::BK + 4;   // P, dS: [BQ][LDP]
  static constexpr int kKt = 0;
  static constexpr int kVt = kKt + D * LDKT;
  static constexpr int kQt = kVt + D * LDKT;
  static constexpr int kdOt = kQt + D * LDQT;
  static constexpr int kQn = kdOt + D * LDQT;
  static constexpr int kdOn = kQn + C::BQ * LDN;
  static constexpr int kP = kdOn + C::BQ * LDN;
  static constexpr int kdS = kP + C::BQ * LDP;
  static constexpr int kL = kdS + C::BQ * LDP;
  static constexpr int kDel = kL + C::BQ;
  static constexpr size_t bytes = sizeof(float) * (kDel + C::BQ);
};

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_kernel(const BwdArgs a) {
  using C = KvCfg<D>;
  using M = KvSmem<D>;
  constexpr int BK = C::BK, BQ = C::BQ, TSQ = C::TSQ, TSK = C::TSK;
  constexpr int TAK = C::TAK, TAD = C::TAD;
  using AC = Cols<D, TAD>;
  static_assert((BQ / TSQ) * (BK / TSK) == NT, "S tile");
  static_assert((BK / TAK) * AC::kGroups == NT, "accumulator tile");
  static_assert(M::bytes <= 232448, "shared memory");
  extern __shared__ __align__(16) float smem[];
  float* sKt = smem + M::kKt;
  float* sVt = smem + M::kVt;
  float* sQt = smem + M::kQt;
  float* sdOt = smem + M::kdOt;
  float* sQn = smem + M::kQn;
  float* sdOn = smem + M::kdOn;
  float* sP = smem + M::kP;
  float* sdS = smem + M::kdS;
  float* sL = smem + M::kL;
  float* sDel = smem + M::kDel;

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int S = a.S, nk = a.T;
  const int G = a.live / a.Hkv;
  const int off = nk - S;  // causal: query s is position s + off
  load_tile<D, BK, 0, M::LDKT>(
      static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh, a.k_st, k0, nk,
      nullptr, sKt, tid);
  load_tile<D, BK, 0, M::LDKT>(
      static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh, a.v_st, k0, nk,
      nullptr, sVt, tid);

  // the queries that see a key of this tile
  int qlo = 0, qhi = S;
  if (a.causal) {
    qlo = max(0, k0 - off);
    if (a.window > 0) qhi = min(S, k0 + BK - 1 - off + a.window);
  }
  const int tq = tid / (BK / TSK), tk = tid % (BK / TSK);
  const int ak = tid / AC::kGroups, ad = tid % AC::kGroups;
  const int ac0 = AC::base(ad);
  float dK[TAK][TAD], dV[TAK][TAD];
#pragma unroll
  for (int i = 0; i < TAK; ++i)
#pragma unroll
    for (int j = 0; j < TAD; ++j) dK[i][j] = dV[i][j] = 0.0f;
  const float c2 = a.scale * LOG2E;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
    const T* dout = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
    const float* lse = a.lse + (static_cast<long long>(b) * a.H + h) * S;
    const float* del = a.delta + (static_cast<long long>(b) * a.live + h) * S;
    for (int q0 = (qlo / BQ) * BQ; q0 < qhi; q0 += BQ) {
      __syncthreads();  // the previous step is done with every buffer
      load_tile<D, BQ, M::LDN, M::LDQT>(q, a.q_ss, q0, S, sQn, sQt, tid);
      load_tile<D, BQ, M::LDN, M::LDQT>(dout, a.do_ss, q0, S, sdOn, sdOt,
                                        tid);
      for (int i = tid; i < BQ; i += NT) {
        sL[i] = q0 + i < S ? lse[q0 + i] : 0.0f;
        sDel[i] = q0 + i < S ? del[q0 + i] : 0.0f;
      }
      __syncthreads();

      float s[TSQ][TSK], dp[TSQ][TSK];
#pragma unroll
      for (int i = 0; i < TSQ; ++i)
#pragma unroll
        for (int j = 0; j < TSK; ++j) s[i][j] = dp[i][j] = 0.0f;
      mm<D, TSQ, TSK, 4, 4>(s, sQt + tq * TSQ, M::LDQT, sKt + tk * TSK,
                            M::LDKT);
      mm<D, TSQ, TSK, 4, 4>(dp, sdOt + tq * TSQ, M::LDQT, sVt + tk * TSK,
                            M::LDKT);
#pragma unroll
      for (int i = 0; i < TSQ; ++i) {
        const int rl = tq * TSQ + i;
#pragma unroll
        for (int j = 0; j < TSK; ++j) {
          const int kl = tk * TSK + j;
          const float p = visible(q0 + rl, k0 + kl, S, nk, off, a.causal, a.window)
                              ? exp2f(s[i][j] * c2 - sL[rl])
                              : 0.0f;
          sP[rl * M::LDP + kl] = p;
          sdS[rl * M::LDP + kl] = p * (dp[i][j] - sDel[rl]);
        }
      }
      __syncthreads();
      mm<BQ, TAK, TAD, 4, AC::kSplit>(dV, sP + ak * TAK, M::LDP, sdOn + ac0,
                                      M::LDN);
      mm<BQ, TAK, TAD, 4, AC::kSplit>(dK, sdS + ak * TAK, M::LDP, sQn + ac0,
                                      M::LDN);
    }
  }

  T* dk = static_cast<T*>(a.dk) + b * a.dk_sb + hk * a.dk_sh;
  T* dv = static_cast<T*>(a.dv) + b * a.dv_sb + hk * a.dv_sh;
#pragma unroll
  for (int i = 0; i < TAK; ++i) {
    const int key = k0 + ak * TAK + i;
    if (key < nk) {
      store_row<TAD>(dk + key * a.dk_st, dK[i], ac0, AC::kSplit, a.scale);
      store_row<TAD>(dv + key * a.dv_st, dV[i], ac0, AC::kSplit, 1.0f);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per (query tile, batch row x head)
// ---------------------------------------------------------------------------

// BQ queries a block, BK keys a step; the S^T / dP^T phase gives a thread
// TSK keys x TSQ queries, the dQ accumulator TAQ queries x TAD dimensions
template <int D>
struct QCfg;
template <>
struct QCfg<16> {
  static constexpr int BQ = 64, BK = 64, TSK = 4, TSQ = 4, TAQ = 4, TAD = 1;
};
template <>
struct QCfg<64> {
  static constexpr int BQ = 64, BK = 32, TSK = 2, TSQ = 4, TAQ = 4, TAD = 4;
};
template <>
struct QCfg<128> {
  static constexpr int BQ = 64, BK = 32, TSK = 2, TSQ = 4, TAQ = 4, TAD = 8;
};
template <>
struct QCfg<256> {
  static constexpr int BQ = 32, BK = 32, TSK = 2, TSQ = 2, TAQ = 4, TAD = 8;
};

template <int D>
struct QSmem {
  using C = QCfg<D>;
  static constexpr int LDQT = C::BQ + 4;  // Qt, dOt: [D][LDQT]
  static constexpr int LDKT = C::BK + 4;  // Kt, Vt: [D][LDKT]
  static constexpr int LDN = D + 4;       // Kn: [BK][LDN]
  static constexpr int LDS = C::BQ + 4;   // dS^T: [BK][LDS]
  static constexpr int kQt = 0;
  static constexpr int kdOt = kQt + D * LDQT;
  static constexpr int kKt = kdOt + D * LDQT;
  static constexpr int kVt = kKt + D * LDKT;
  static constexpr int kKn = kVt + D * LDKT;
  static constexpr int kdS = kKn + C::BK * LDN;
  static constexpr int kL = kdS + C::BK * LDS;
  static constexpr int kDel = kL + C::BQ;
  static constexpr size_t bytes = sizeof(float) * (kDel + C::BQ);
};

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(const BwdArgs a) {
  using C = QCfg<D>;
  using M = QSmem<D>;
  constexpr int BK = C::BK, BQ = C::BQ, TSQ = C::TSQ, TSK = C::TSK;
  constexpr int TAQ = C::TAQ, TAD = C::TAD;
  using AC = Cols<D, TAD>;
  static_assert((BK / TSK) * (BQ / TSQ) == NT, "S tile");
  static_assert((BQ / TAQ) * AC::kGroups == NT, "accumulator tile");
  static_assert(M::bytes <= 232448, "shared memory");
  extern __shared__ __align__(16) float smem[];
  float* sQt = smem + M::kQt;
  float* sdOt = smem + M::kdOt;
  float* sKt = smem + M::kKt;
  float* sVt = smem + M::kVt;
  float* sKn = smem + M::kKn;
  float* sdS = smem + M::kdS;
  float* sL = smem + M::kL;
  float* sDel = smem + M::kDel;

  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heavy tiles first
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y % a.H;
  const int S = a.S, nk = a.T;
  const int off = nk - S;
  const int aq = tid / AC::kGroups, ad = tid % AC::kGroups;
  const int ac0 = AC::base(ad);
  T* dq = static_cast<T*>(a.dq) + b * a.dq_sb + h * a.dq_sh;

  float dQ[TAQ][TAD];
#pragma unroll
  for (int i = 0; i < TAQ; ++i)
#pragma unroll
    for (int j = 0; j < TAD; ++j) dQ[i][j] = 0.0f;

  if (h < a.live) {
    const int hk = h / (a.live / a.Hkv);
    const T* k = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
    const T* v = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
    const float* lse = a.lse + (static_cast<long long>(b) * a.H + h) * S;
    const float* del = a.delta + (static_cast<long long>(b) * a.live + h) * S;
    load_tile<D, BQ, 0, M::LDQT>(
        static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh, a.q_ss, q0, S,
        nullptr, sQt, tid);
    load_tile<D, BQ, 0, M::LDQT>(
        static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh, a.do_ss,
        q0, S, nullptr, sdOt, tid);
    for (int i = tid; i < BQ; i += NT) {
      sL[i] = q0 + i < S ? lse[q0 + i] : 0.0f;
      sDel[i] = q0 + i < S ? del[q0 + i] : 0.0f;
    }
    // the keys this tile's queries see
    int klo = 0, khi = nk;
    if (a.causal) {
      khi = min(nk, q0 + BQ + off);
      if (a.window > 0) klo = max(0, q0 + off - a.window + 1);
    }
    const int tk = tid / (BQ / TSQ), tq = tid % (BQ / TSQ);
    const float c2 = a.scale * LOG2E;
    for (int k0 = (klo / BK) * BK; k0 < khi; k0 += BK) {
      __syncthreads();  // the previous step is done with K, V and dS
      load_tile<D, BK, M::LDN, M::LDKT>(k, a.k_st, k0, nk, sKn, sKt, tid);
      load_tile<D, BK, 0, M::LDKT>(v, a.v_st, k0, nk, nullptr, sVt, tid);
      __syncthreads();
      float s[TSK][TSQ], dp[TSK][TSQ];
#pragma unroll
      for (int i = 0; i < TSK; ++i)
#pragma unroll
        for (int j = 0; j < TSQ; ++j) s[i][j] = dp[i][j] = 0.0f;
      mm<D, TSK, TSQ, 4, 4>(s, sKt + tk * TSK, M::LDKT, sQt + tq * TSQ,
                            M::LDQT);
      mm<D, TSK, TSQ, 4, 4>(dp, sVt + tk * TSK, M::LDKT, sdOt + tq * TSQ,
                            M::LDQT);
#pragma unroll
      for (int i = 0; i < TSK; ++i) {
        const int kl = tk * TSK + i;
#pragma unroll
        for (int j = 0; j < TSQ; ++j) {
          const int rl = tq * TSQ + j;
          const float p = visible(q0 + rl, k0 + kl, S, nk, off, a.causal, a.window)
                              ? exp2f(s[i][j] * c2 - sL[rl])
                              : 0.0f;
          sdS[kl * M::LDS + rl] = p * (dp[i][j] - sDel[rl]);
        }
      }
      __syncthreads();
      mm<BK, TAQ, TAD, 4, AC::kSplit>(dQ, sdS + aq * TAQ, M::LDS, sKn + ac0,
                                      M::LDN);
    }
  }
#pragma unroll
  for (int i = 0; i < TAQ; ++i) {
    const int r = q0 + aq * TAQ + i;
    if (r < S)
      store_row<TAD>(dq + r * a.dq_ss, dQ[i], ac0, AC::kSplit, a.scale);
  }
}

template <typename T, int D>
int launch(const BwdArgs& a, cudaStream_t st) {
  const long long rows = static_cast<long long>(a.B) * a.live * a.S;
  if (rows > 0) {
    const long long blocks = (rows + NT / 32 - 1) / (NT / 32);
    flash_bwd_delta_kernel<T><<<static_cast<unsigned>(blocks), NT, 0, st>>>(
        a, D);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // above 48 KB a block's shared memory must be asked for, once per kernel
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(KvSmem<D>::bytes));
  if (attr_kv != cudaSuccess) return static_cast<int>(attr_kv);
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(QSmem<D>::bytes));
  if (attr_q != cudaSuccess) return static_cast<int>(attr_q);
  const dim3 grid_kv((a.T + KvCfg<D>::BK - 1) / KvCfg<D>::BK, a.Hkv, a.B);
  flash_bwd_dkdv_kernel<T, D><<<grid_kv, NT, KvSmem<D>::bytes, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q((a.S + QCfg<D>::BQ - 1) / QCfg<D>::BQ, a.B * a.H);
  flash_bwd_dq_kernel<T, D><<<grid_q, NT, QSmem<D>::bytes, st>>>(a);
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

}  // namespace

// q, o, dout, dq (B, H, S, D); k, v, dk, dv (B, Hkv, T, D); each by its
// (b, h, row) strides in elements with unit stride along D and every row
// 16-byte aligned; all float32 (bf16 = 0) or all bfloat16 (bf16 = 1); lse
// float32 (B, H, S) contiguous, the forward's base-2 log-sum-exp; delta
// float32 scratch of B * live * S; D in {16, 64, 128, 256}; Hkv divides
// live <= H; T >= S when causal; window > 0 (causal only) as the forward's.
// Every element of dq, dk and dv is written.  Returns the cudaError_t of
// the launches (0 on success).
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
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
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

// one chunk a block in both kernels: this version never splits its walks
extern "C" int flash_attention_bwd_chunks(int B, int Hkv, int live, int S,
                                          int T, int D, int bf16, int kv) {
  return 1;
}
