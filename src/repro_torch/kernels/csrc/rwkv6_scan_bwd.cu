// K7's backward: the gradient of the rwkv6 recurrence (rwkv6_scan.cu)
//
//   o_t[j]    = sum_i r_t[i] (S_{t-1}[i][j] + u[i] k_t[i] v_t[j])
//   S_t[i][j] = w_t[i] S_{t-1}[i][j] + k_t[i] v_t[j]
//
// for the upstream do (B, L, H, K) of o and ds (B, H, K, K) of the final
// state.  With G_t the gradient of S_t (G = ds after the last step):
//
//   dr_t[i] = sum_j S_{t-1}[i][j] do_t[j] + u_i k_t[i] (v_t . do_t)
//   dk_t[i] = sum_j G_t[i][j] v_t[j]      + u_i r_t[i] (v_t . do_t)
//   dv_t[j] = sum_i G_t[i][j] k_t[i]      + do_t[j] sum_i r_t[i] u_i k_t[i]
//   dw_t[i] = sum_j G_t[i][j] S_{t-1}[i][j]
//   du[i]   = sum over B and L of r_t[i] k_t[i] (v_t . do_t)
//   G_{t-1} = diag(w_t) G_t + r_t^T do_t
//
// and dstate is the gradient of the state in.  All float32.  Replaces no
// TPU kernel: the JAX package trains through jax.value_and_grad of the
// lax.scan recurrence (src/repro/models/rwkv6.py::_recurrence) and has no
// Pallas backward; this is the train path's gradient of K7
// (rwkv6_scan_pallas).
//
// The chunked form.  Steps go in chunks of C.  Inside a chunk, with local
// steps t, s in [0, C), S_c the state before the chunk, G_e the gradient of
// the state after its last step, and P(a, b)[i] = prod_{a <= tau < b}
// w_tau[i] (P(a, a) = 1; row i of a matrix scaled by it):
//
//   S_{t-1} = P(0, t) S_c + sum_{s<t} kap_t[s] v_s,  kap_t[s] = P(s+1, t) k_s
//   G_t     = P(t+1, C) G_e + sum_{s>t} P(t+1, s) r_s^T do_s
//
// so, with Y = S_c DO^T, X = G_e V^T, M = V DO^T (M[s][t] = v_s . do_t),
// Kt[t] = P(t+1, C) k_t, Rt[t] = P(0, t) r_t and A[t][s] = sum_i r_s[i]
// kap_s[t][i] (A[t][t] = sum_i u_i k_t[i] r_t[i]):
//
//   dr_t = P(0, t) Y[., t] + sum_{s<t} kap_t[s] M[s][t]     (+ the bonus)
//   dv   = Kt G_e + A DO                     (the bonus on A's diagonal)
//   W_t[s] = G_t v_s:  W_{C-1}[s] = X[., s],
//                      W_{t-1}[s] = w_t W_t[s] + r_t M[s][t]
//   Q_t = rowsum(G_t * S_c):  Q_{C-1} = rowsum(G_e * S_c),
//                      Q_{t-1} = w_t Q_t + r_t Y[., t]
//   dk_t = W_t[t] (+ the bonus),
//   dw_t = P(0, t) Q_t + sum_{s<t} kap_t[s] W_t[s]
//   G before the chunk = P(0, C) G_e + Rt^T DO,
//   S after the chunk  = P(0, C) S_c + Kt^T V.
//
// Every decay product is formed by multiplication: nothing divides by w or
// takes its log (w reaches 0 in float32).  The work a step is O(K^2 / C)
// of products (Y, X, M, Kt G_e, A DO and the two state updates) and O(C K)
// on the CUDA cores (the W, Q recurrences, dr's and dw's sums, A), against
// O(K^2) FMAs a step of the step-by-step walk.
//
// What bounds it on an H100: at rwkv6-7b's train shape (B = 8, L = 512,
// H = 64, K = 64) it must read r, k, v, w, do and write dr, dk, dv, dw
// (~604 MB, 0.18 ms at 3.35 TB/s); the forward sweep re-reads k, v, w and
// the saved states are written and read (268 MB each way at C = 16); the
// products are 3.5e10 flops as 3 TF32 products (0.07 ms).  What holds it
// back is latency: one block an SM (255 registers a thread, 200 KB of
// shared memory), each chunk a dozen short phases between barriers.  The
// design:
//   * one block of 8 warps a head: a forward sweep runs the state across
//     the chunks (S <- P(0, C) S + Kt^T V) and saves the state before each
//     chunk into a scratch buffer (B H ceil(L / C) K^2 floats), staged in
//     shared memory and written by one bulk store of the tensor memory
//     accelerator (no warp waits on it); the walk back takes the chunks in
//     reverse, the state's gradient G in the warps' registers;
//   * every K^2 product runs on the tensor cores as mma.sync.m16n8k8 TF32
//     with the 3xTF32 split (x ~ hi + lo, lo*hi + hi*lo + hi*hi), which
//     keeps float32 accuracy; each product is summed from zero over at
//     most K and added to its float32 destination once, so the long
//     recurrences (S and G across chunks) are float32 sums;
//   * the per-key recurrences are split over THREADS / K threads a key
//     (the W chains by s), the parts of dr and dw added with halving
//     shuffles after the walk; the chunk's decay products
//     kap_s[t] = P(t+1, s) k_t are a C x C table in shared memory, 0 for
//     t >= s, so the walk's sums need no branch, read by the per-key sums
//     and by the threads that form A (one (t, s) pair each, its walk over
//     the keys rotated so that a warp's reads fall in more banks);
//   * r, k, v, w, do of a chunk and the saved state are copied into shared
//     memory with cp.async, the next chunk (the previous one, walking
//     back) streaming in under the current one; a ragged last chunk is
//     padded with steps that change nothing (r, k, v, do 0, w 1);
//   * every sum is in a fixed order and there are no atomics: du is a
//     partial per (b, h), summed over B by a second kernel, so two calls
//     on the same inputs agree bitwise.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int C = 16;                        // steps a chunk
constexpr int THREADS = 256;
constexpr int NFB = 2;                       // the forward sweep's buffers
constexpr int NW = THREADS / 32;             // warps
constexpr int NPAIRD = C * (C + 1) / 2;      // (t, s) with t <= s

// the pair (t, s), t <= s, in the decay table and in A
__host__ __device__ constexpr int pair_d(int t, int s) {
  return s * (s + 1) / 2 + t;
}

// The dynamic shared memory of a block, offsets in floats.
// Rows read as an mma A-fragment (row g, column t of a lane) are padded
// to 4 more than a multiple of 32 floats, those read transposed (row t,
// column g) to 8 more: both patterns then fall in 32 different banks.
template <int K>
struct Cfg {
  static constexpr int RS = K + 4;      // rows of r, k, v, w, do, S_c, G
  static constexpr int BS = K + 4;      // rows of Kt as the A-fragment
  static constexpr int TS = K + 8;      // rows of kap, Kt, Rt, P(0, t)
  static constexpr int YS = C + 4;      // rows of Y and X (key-major)
  static constexpr int MS = C + 1;      // rows of M
  static constexpr int SEQ = C * RS;    // one sequence of a chunk
  static constexpr int IN = 0;          // r, k, v, w, do: [buf][q][t][RS]
  static constexpr int SC = IN + 2 * 5 * SEQ;     // saved state [buf][i][RS]
  static constexpr int GS = SC + 2 * K * RS;      // G_e [i][RS]
  static constexpr int KAP = GS + K * RS;         // kap [s][t][TS]
  static constexpr int DIAG = KAP + C * C * TS;   // u k_t [t][TS]
  static constexpr int KTIL = DIAG + C * TS;      // Kt [t][TS] or [t][BS]
  static constexpr int RTIL = KTIL + C * TS;      // Rt [t][TS]
  static constexpr int PRE = RTIL + C * TS;       // P(0, t) [t][TS], t <= C
  static constexpr int Y = PRE + (C + 1) * TS;    // [i][YS]
  static constexpr int X = Y + K * YS;
  static constexpr int M = X + K * YS;            // [s][MS]
  static constexpr int AH = M + C * MS;           // A [NPAIRD]
  static constexpr int QP = AH + NPAIRD;          // rowsum partials [4][K]
  static constexpr int U = QP + 4 * K;
  static constexpr int TOTAL = U + K;
  static_assert(3 * NFB * SEQ <= GS - IN, "the forward sweep's buffers");
};

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

// bytes of shared memory to device memory on the tensor memory
// accelerator, as one bulk group of this thread: both 16-byte aligned,
// bytes a multiple of 16
__device__ __forceinline__ void bulk_store(float* dst, unsigned src,
                                           unsigned bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst),
      "r"(src), "r"(bytes)
      : "memory");
}

// wait until this thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// wait until this thread's bulk stores are complete and visible
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// this thread's shared-memory writes, visible to the bulk copies after
// the next barrier
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most PENDING of this thread's copy groups are in flight
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// x ~ hi + lo: hi is x rounded to TF32 (to nearest, ties away), lo the
// exact float32 rest truncated to TF32, |x - hi - lo| <= 2^-21 |x|
// (flash_attention_bwd.cu's split)
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

// Sums v[0 .. W) over the lanes that differ in the bits M, M / 2, .., 1
// of the lane index, each exchange halving the values a lane holds (the
// lanes with bit M set keep the upper half): v[0 .. W / 2^levels) end as
// the sums of values idx .. (idx accumulates the kept halves' offsets).
// The widths are template arguments, so the loops unroll and v stays in
// registers.
template <int W, int M>
__device__ __forceinline__ void halve(float* v, int lane, int& idx) {
  if constexpr (M > 0) {
    constexpr int H = W / 2;
    const bool upper = lane & M;
#pragma unroll
    for (int e = 0; e < H; ++e) {
      const float keep = upper ? v[e + H] : v[e];
      const float send = upper ? v[e] : v[e + H];
      v[e] = keep + __shfl_xor_sync(0xffffffffu, send, M);
    }
    if (upper) idx += H;
    halve<H, M / 2>(v, lane, idx);
  }
}

// acc[n] (the 16 x 8 tile at rows m0, columns n0 + 8 n) = sum over k <
// 8 KS of a(row, k) b(k, column), from zero, 3xTF32: one A-fragment a
// k-step serves the NN tiles.  Lane (g, t4) = (lane / 4, lane % 4) holds
// acc[n][0..3] at (m0 + g, n0 + 8n + 2 t4 + {0, 1}) and (m0 + g + 8, the
// same).  The hi * hi products and the two small ones are summed apart
// (two chains of mma.sync, not one of three) and added at the end.
template <int KS, int NN, class FA, class FB>
__device__ __forceinline__ void tile_mma(float (&acc)[NN][4], int m0, int n0,
                                         int lane, FA a, FB b) {
  const int g = lane >> 2, t4 = lane & 3;
  float lo[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = lo[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int k0 = ks * 8;
    uint32_t ah[4], al[4];
    split_tf32(a(m0 + g, k0 + t4), ah[0], al[0]);
    split_tf32(a(m0 + g + 8, k0 + t4), ah[1], al[1]);
    split_tf32(a(m0 + g, k0 + t4 + 4), ah[2], al[2]);
    split_tf32(a(m0 + g + 8, k0 + t4 + 4), ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      uint32_t bh[2], bl[2];
      split_tf32(b(k0 + t4, n0 + 8 * n + g), bh[0], bl[0]);
      split_tf32(b(k0 + t4 + 4, n0 + 8 * n + g), bh[1], bl[1]);
      mma_tf32(lo[n], al, bh);
      mma_tf32(lo[n], ah, bl);
      mma_tf32(acc[n], ah, bh);
    }
  }
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = lo[n][e] + acc[n][e];
}

template <int K>
__global__ void __launch_bounds__(THREADS, 256 / THREADS) rwkv6_scan_bwd_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* __restrict__ s_in,
    const float* __restrict__ dout, const float* __restrict__ ds,
    float* __restrict__ dr, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ dw, float* __restrict__ dstate,
    float* __restrict__ chk, float* __restrict__ du_part, int L, int H,
    int wide) {
  using S = Cfg<K>;
  constexpr int RS = S::RS, BS = S::BS, TS = S::TS, YS = S::YS, MS = S::MS;
  constexpr int KT = THREADS / K;          // threads a key
  constexpr int CK = C / KT;               // steps (or W chains) a thread
  constexpr int MT = K / 16, NT = K / 8;   // the state's 16 x 8 tiles
  constexpr int TPW = (MT * NT + NW - 1) / NW;  // tiles a warp, a row strip
  constexpr int QPN = NT / TPW;            // warps sharing a row of tiles
  constexpr int DVT = (NT + NW - 1) / NW;  // dv's 8-column tiles a warp
  static_assert(THREADS % K == 0 && C % KT == 0 && KT <= 32 &&
                    NT % TPW == 0 && QPN <= 4 && K % 16 == 0 &&
                    C % 8 == 0 && MT * NT <= NW * TPW,
                "K = 16 or 64");
  extern __shared__ __align__(16) float smem[];
  enum { QR, QK, QV, QW, QDO };  // the sequences' slots

  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int key = tid / KT, q = tid - key * KT;  // a key's q-th thread
  const size_t step = (size_t)H * K;             // stride of t
  const size_t base = ((size_t)b * L * H + h) * K;   // r[b, 0, h, 0]
  const int nc = (L + C - 1) / C;
  float* const my_chk = chk + (size_t)bh * nc * K * K;
  const size_t srow = (size_t)bh * K * K;

  auto in = [&](int slot, int buf, int t, int col) -> float& {
    return smem[S::IN + (buf * 5 + slot) * S::SEQ + t * RS + col];
  };
  float* const sc0 = smem + S::SC;
  float* const gs = smem + S::GS;
  float* const kap = smem + S::KAP;
  float* const diag = smem + S::DIAG;
  float* const ktil = smem + S::KTIL;
  float* const rtil = smem + S::RTIL;
  float* const pre = smem + S::PRE;
  float* const ys = smem + S::Y;
  float* const xs = smem + S::X;
  float* const ms = smem + S::M;
  float* const ah = smem + S::AH;
  float* const qp = smem + S::QP;
  float* const us = smem + S::U;
  for (int e = tid; e < K; e += THREADS) us[e] = u[(size_t)h * K + e];
  // kap_s[t] is written for t < s only: the rest stays 0
  for (int e = tid; e < C * C * TS; e += THREADS) kap[e] = 0.f;

  // copy chunk c's steps of k, v, w (and r, do and this block's rows of
  // its saved state with all) into buffer buf, asynchronously, as one
  // copy group (steps past L are not copied)
  const unsigned s0 = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  auto stage = [&](int c, int buf, bool all) {
    const int t0 = c * C, n = min(C, L - t0);
    const unsigned in0 = s0 + 4 * (S::IN + buf * 5 * S::SEQ);
    if (wide) {
      constexpr int Q4 = K / 4;
      for (int e = tid; e < C * Q4; e += THREADS) {
        const int tt = e / Q4, col = 4 * (e % Q4);
        if (tt >= n) continue;
        const size_t off = base + (size_t)(t0 + tt) * step + col;
        const unsigned dst = in0 + 4 * (tt * RS + col);
        cp_async16(dst + 4 * QK * S::SEQ, k + off);
        cp_async16(dst + 4 * QV * S::SEQ, v + off);
        cp_async16(dst + 4 * QW * S::SEQ, w + off);
        if (all) {
          cp_async16(dst + 4 * QR * S::SEQ, r + off);
          cp_async16(dst + 4 * QDO * S::SEQ, dout + off);
        }
      }
    } else {
      for (int e = tid; e < C * K; e += THREADS) {
        const int tt = e / K, col = e % K;
        if (tt >= n) continue;
        const size_t off = base + (size_t)(t0 + tt) * step + col;
        const unsigned dst = in0 + 4 * (tt * RS + col);
        cp_async4(dst + 4 * QK * S::SEQ, k + off);
        cp_async4(dst + 4 * QV * S::SEQ, v + off);
        cp_async4(dst + 4 * QW * S::SEQ, w + off);
        if (all) {
          cp_async4(dst + 4 * QR * S::SEQ, r + off);
          cp_async4(dst + 4 * QDO * S::SEQ, dout + off);
        }
      }
    }
    if (all) {  // the saved state's rows, always 16-byte aligned
      const float* src = my_chk + (size_t)c * K * K;
      for (int e = tid; e < K * K / 4; e += THREADS) {
        const int i = e / (K / 4), col = 4 * (e % (K / 4));
        cp_async16(s0 + 4 * (S::SC + buf * K * RS + i * RS + col),
                   src + i * K + col);
      }
    }
    cp_async_commit();
  };
  // this key's steps of a sequence, from shared memory into registers
  // (loaded together, ahead of the chains that use them)
  auto key_seq = [&](float (&dst)[C], int slot, int buf) {
#pragma unroll
    for (int t = 0; t < C; ++t) dst[t] = in(slot, buf, t, key);
  };

  // this warp's tiles of the block's rows of the state (S walking
  // forward, G walking back): TPW tiles of one row strip, tile j at rows
  // m0, columns n0 + 8 j
  const int tile0 = warp * TPW;
  const bool owns = tile0 < MT * NT;
  const int m0 = (tile0 / NT) * 16, n0 = (tile0 % NT) * 8;
  float st[TPW][4];
  auto load_state = [&](const float* src) {  // a view: 4-byte aligned
    if (!owns) return;
#pragma unroll
    for (int j = 0; j < TPW; ++j) {
      const int col = n0 + 8 * j + 2 * t4;
      st[j][0] = src[(m0 + g) * K + col];
      st[j][1] = src[(m0 + g) * K + col + 1];
      st[j][2] = src[(m0 + g + 8) * K + col];
      st[j][3] = src[(m0 + g + 8) * K + col + 1];
    }
  };
  auto store_state = [&](float* dst) {  // a new tensor: aligned
    if (!owns) return;
#pragma unroll
    for (int j = 0; j < TPW; ++j) {
      const int col = n0 + 8 * j + 2 * t4;
      *reinterpret_cast<float2*>(dst + (m0 + g) * K + col) =
          make_float2(st[j][0], st[j][1]);
      *reinterpret_cast<float2*>(dst + (m0 + g + 8) * K + col) =
          make_float2(st[j][2], st[j][3]);
    }
  };
  // st <- P(0, C) st + a^T b over the chunk's steps: a (t, row) from
  // Kt or Rt in the transposed layout, b (t, column) from v or do
  auto update_state = [&](const float* a_t, const float* b_rows) {
    if (!owns) return;
    float acc[TPW][4];
    tile_mma<C / 8, TPW>(
        acc, m0, n0, lane,
        [&](int row, int t) { return a_t[t * TS + row]; },
        [&](int t, int col) { return b_rows[t * RS + col]; });
    const float p0 = pre[C * TS + m0 + g], p1 = pre[C * TS + m0 + g + 8];
#pragma unroll
    for (int j = 0; j < TPW; ++j) {
      st[j][0] = fmaf(p0, st[j][0], acc[j][0]);
      st[j][1] = fmaf(p0, st[j][1], acc[j][1]);
      st[j][2] = fmaf(p1, st[j][2], acc[j][2]);
      st[j][3] = fmaf(p1, st[j][3], acc[j][3]);
    }
  };

  // sweep 1: forward from the state in, saving the state before each
  // chunk.  It reads k, v and w only, into NFB buffers of its own (in the
  // walk's buffers and saved-state buffers)
  auto fseq = [&](int fb, int q3) {  // k, v, w: q3 = 0, 1, 2
    return smem + S::IN + (fb * 3 + q3) * S::SEQ;
  };
  auto stage_f = [&](int c) {  // chunk c (< nc - 1) or an empty group
    if (c < nc - 1) {
      const int t0 = c * C, fb = c % NFB;
      const unsigned in0 = static_cast<unsigned>(
          __cvta_generic_to_shared(fseq(fb, 0)));
      if (wide) {
        constexpr int Q4 = K / 4;
        for (int e = tid; e < C * Q4; e += THREADS) {
          const int tt = e / Q4, col = 4 * (e % Q4);
          const size_t off = base + (size_t)(t0 + tt) * step + col;
          const unsigned dst = in0 + 4 * (tt * RS + col);
          cp_async16(dst, k + off);
          cp_async16(dst + 4 * S::SEQ, v + off);
          cp_async16(dst + 8 * S::SEQ, w + off);
        }
      } else {
        for (int e = tid; e < C * K; e += THREADS) {
          const int tt = e / K, col = e % K;
          const size_t off = base + (size_t)(t0 + tt) * step + col;
          const unsigned dst = in0 + 4 * (tt * RS + col);
          cp_async4(dst, k + off);
          cp_async4(dst + 4 * S::SEQ, v + off);
          cp_async4(dst + 8 * S::SEQ, w + off);
        }
      }
    }
    cp_async_commit();
  };
  load_state(s_in + srow);
#pragma unroll
  for (int c = 0; c < NFB - 1; ++c) stage_f(c);
  for (int c = 0; c < nc; ++c) {
    // the state before chunk c to its scratch: staged in shared memory
    // (G_e's space, free in this sweep) in the scratch's layout, then one
    // bulk store on the tensor memory accelerator, so no warp waits on it
    store_state(gs);
    fence_async_shared();
    __syncthreads();
    if (tid == 0)
      bulk_store(my_chk + (size_t)c * K * K,
                 static_cast<unsigned>(__cvta_generic_to_shared(gs)),
                 K * K * sizeof(float));
    if (c + 1 == nc) break;  // the last chunk's steps are not needed
    stage_f(c + NFB - 1);    // NFB - 1 chunks stream in under this one
    cp_async_wait<NFB - 1>();
    __syncthreads();
    const int fb = c % NFB;
    {  // Kt[t] = P(t+1, C) k_t (transposed layout) and P(0, C)
      float wr[C], kr[C];
#pragma unroll
      for (int t = 0; t < C; ++t) {
        kr[t] = fseq(fb, 0)[t * RS + key];
        wr[t] = fseq(fb, 2)[t * RS + key];
      }
      float suf = 1.f;
#pragma unroll
      for (int t = C - 1; t >= 0; --t) {
        if (t % KT == q) ktil[t * TS + key] = suf * kr[t];
        suf *= wr[t];
      }
      if (q == 0) pre[C * TS + key] = suf;
    }
    __syncthreads();
    update_state(ktil, fseq(fb, 1));
    if (tid == 0) bulk_wait_read();  // the staged state is read
    __syncthreads();  // this buffer, Kt and the stage are consumed
  }
  cp_async_wait<0>();
  if (tid == 0) {  // the saved states are written before they are read
    bulk_wait();
    asm volatile("fence.proxy.async;\n" ::: "memory");
  }
  __syncthreads();

  // sweep 2: back in time, chunk by chunk, G in st
  load_state(ds + srow);
  float du_acc = 0.f;
  if (nc > 0) stage(nc - 1, (nc - 1) & 1, true);
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * C, n = min(C, L - t0), buf = c & 1;
    if (c > 0) {  // the previous chunk streams in under this one
      stage(c - 1, buf ^ 1, true);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // a ragged chunk's missing steps change nothing: r, k, v, do 0, w 1
    for (int e = tid; e < (C - n) * K; e += THREADS) {
      const int tt = n + e / K, col = e % K;
      in(QR, buf, tt, col) = 0.f;
      in(QK, buf, tt, col) = 0.f;
      in(QV, buf, tt, col) = 0.f;
      in(QDO, buf, tt, col) = 0.f;
      in(QW, buf, tt, col) = 1.f;
    }
    if (owns) {  // G_e to shared memory, an operand of X and Kt G_e
#pragma unroll
      for (int j = 0; j < TPW; ++j) {
        const int col = n0 + 8 * j + 2 * t4;
        gs[(m0 + g) * RS + col] = st[j][0];
        gs[(m0 + g) * RS + col + 1] = st[j][1];
        gs[(m0 + g + 8) * RS + col] = st[j][2];
        gs[(m0 + g + 8) * RS + col + 1] = st[j][3];
      }
    }
    __syncthreads();
    const float* const sc = sc0 + buf * K * RS;

    // phase 1: the decay tables, Y, X, M, and rowsum(G_e * S_c)
    {
      float wr[C], kr[C], rr[C];
      key_seq(wr, QW, buf);
      key_seq(kr, QK, buf);
      key_seq(rr, QR, buf);
      // P(0, t) and P(t+1, C): the chains run over every step, each
      // thread keeps its steps' values (in registers) and stores those
      float p = 1.f, suf = 1.f, pv[CK], sv_[CK];
#pragma unroll
      for (int t = 0; t < C; ++t) {
        if (t % KT == q) pv[t / KT] = p;
        p *= wr[t];
      }
#pragma unroll
      for (int t = C - 1; t >= 0; --t) {
        if (t % KT == q) sv_[t / KT] = suf;
        suf *= wr[t];
      }
#pragma unroll
      for (int mm = 0; mm < CK; ++mm) {
        const int t = q + KT * mm;
        float rt = rr[KT * mm], kt = kr[KT * mm];
#pragma unroll
        for (int j = 1; j < KT; ++j) {
          if (q == j) {
            rt = rr[KT * mm + j];
            kt = kr[KT * mm + j];
          }
        }
        pre[t * TS + key] = pv[mm];
        rtil[t * TS + key] = pv[mm] * rt;      // Rt
        ktil[t * BS + key] = sv_[mm] * kt;     // Kt, the A-fragment layout
      }
      if (q == 0) pre[C * TS + key] = p;
      // kap_s[t] = P(t+1, s) k_t for this thread's t, every s > t, and
      // u k_t on the diagonal (the bonus term of A)
#pragma unroll
      for (int mm = 0; mm < CK; ++mm) {
        const int t = q + KT * mm;
        float kv = kr[KT * mm];
#pragma unroll
        for (int j = 1; j < KT; ++j)
          if (q == j) kv = kr[KT * mm + j];
        diag[t * TS + key] = us[key] * kv;
#pragma unroll
        for (int s = 1; s < C; ++s) {
          if (s > t) {
            kap[(s * C + t) * TS + key] = kv;
            kv *= wr[s];
          }
        }
      }
    }
    // Y = S_c DO^T and X = G_e V^T: a warp one 16-key row strip of one;
    // the first C / 8 jobs also an 8-column tile of M = V DO^T (M[s][t] =
    // v_s . do_t)
    for (int job = warp; job < 2 * MT; job += NW) {
      float acc[C / 8][4];
      const bool is_y = job < MT;
      const int mrow = (is_y ? job : job - MT) * 16;
      const float* lhs = is_y ? sc : gs;
      const int slot = is_y ? QDO : QV;
      tile_mma<K / 8, C / 8>(
          acc, mrow, 0, lane,
          [&](int i, int j) { return lhs[i * RS + j]; },
          [&](int j, int t) { return in(slot, buf, t, j); });
      float* out = is_y ? ys : xs;
#pragma unroll
      for (int nn = 0; nn < C / 8; ++nn) {
        const int col = 8 * nn + 2 * t4;
        out[(mrow + g) * YS + col] = acc[nn][0];
        out[(mrow + g) * YS + col + 1] = acc[nn][1];
        out[(mrow + g + 8) * YS + col] = acc[nn][2];
        out[(mrow + g + 8) * YS + col + 1] = acc[nn][3];
      }
      if (job < C / 8) {
        float mt[1][4];
        tile_mma<K / 8, 1>(
            mt, 0, 8 * job, lane,
            [&](int sv, int j) { return in(QV, buf, sv, j); },
            [&](int j, int t) { return in(QDO, buf, t, j); });
        const int col = 8 * job + 2 * t4;
        ms[g * MS + col] = mt[0][0];
        ms[g * MS + col + 1] = mt[0][1];
        if (g + 8 < C) {
          ms[(g + 8) * MS + col] = mt[0][2];
          ms[(g + 8) * MS + col + 1] = mt[0][3];
        }
      }
    }
    if (owns) {  // this warp's part of rowsum(G_e * S_c), rows g and g + 8
      float q0 = 0.f, q1 = 0.f;
#pragma unroll
      for (int j = 0; j < TPW; ++j) {
        const int col = n0 + 8 * j + 2 * t4;
        q0 = fmaf(st[j][0], sc[(m0 + g) * RS + col], q0);
        q0 = fmaf(st[j][1], sc[(m0 + g) * RS + col + 1], q0);
        q1 = fmaf(st[j][2], sc[(m0 + g + 8) * RS + col], q1);
        q1 = fmaf(st[j][3], sc[(m0 + g + 8) * RS + col + 1], q1);
      }
      q0 += __shfl_xor_sync(0xffffffffu, q0, 1);
      q0 += __shfl_xor_sync(0xffffffffu, q0, 2);
      q1 += __shfl_xor_sync(0xffffffffu, q1, 1);
      q1 += __shfl_xor_sync(0xffffffffu, q1, 2);
      if (t4 == 0) {
        const int qpart = (tile0 % NT) / TPW;
        qp[qpart * K + m0 + g] = q0;
        qp[qpart * K + m0 + g + 8] = q1;
      }
    }
    __syncthreads();

    // phase 2: the per-key recurrences (dr, dk, dw, du), A, and the
    // products Kt G_e (dv's first term) and G's step across the chunk
    {
      const float uk = us[key];
      float wr[C], rr[C];
      key_seq(wr, QW, buf);
      key_seq(rr, QR, buf);
      // W_t[s] for this thread's chains s = q + KT mm, and Q_t, back from
      // t = C - 1.  dr_t's and dw_t's parts over this thread's s (and
      // P(0, t) Y[., t], P(0, t) Q_t in the key's first thread) go to
      // pdr[t], pdw[t], added over the key's threads after the walk.
      // The table is 0 past the sums' ranges, so the loop has no branch
      float wv[CK], pdr[C], pdw[C], dkv[CK];
#pragma unroll
      for (int mm = 0; mm < CK; ++mm) wv[mm] = xs[key * YS + q + KT * mm];
      float qv = qp[key];
#pragma unroll
      for (int p = 1; p < QPN; ++p) qv += qp[p * K + key];
#pragma unroll
      for (int t = C - 1; t >= 0; --t) {
        const float mtt = ms[t * MS + t], yt = ys[key * YS + t];
        const float pt = pre[t * TS + key];
        if (t % KT == q) dkv[t / KT] = fmaf(uk * rr[t], mtt, wv[t / KT]);
        // the key's first thread adds P(0, t) Q_t (dr's own terms come
        // after the walk)
        float adr = 0.f, adw = q == 0 ? pt * qv : 0.f;
        const float* krow = kap + t * C * TS + key;  // 0 past s = t - 1
#pragma unroll
        for (int mm = 0; mm < CK; ++mm) {
          const int sp = q + KT * mm;
          const float kp = krow[sp * TS], m = ms[sp * MS + t];
          adr = fmaf(kp, m, adr);
          adw = fmaf(kp, wv[mm], adw);
          // W_{t-1}[s]; a chain with s >= t is not read again
          wv[mm] = fmaf(wr[t], wv[mm], rr[t] * m);
        }
        pdr[t] = adr;
        pdw[t] = adw;
        qv = fmaf(wr[t], qv, rr[t] * yt);
      }
#pragma unroll
      for (int mm = 0; mm < CK; ++mm)
        if (q + KT * mm < n)
          dk[base + (size_t)(t0 + q + KT * mm) * step + key] = dkv[mm];
      // the key's KT threads add their parts: each ends with CK steps'
      int t_first = 0, t_same = 0;
      halve<C, KT / 2>(pdr, lane, t_first);
      halve<C, KT / 2>(pdw, lane, t_same);
      // dr_t's own terms, P(0, t) Y[., t] + u k_t (v_t . do_t), and du's
#pragma unroll
      for (int e = 0; e < CK; ++e) {
        const int t = t_first + e;
        const float mtt = ms[t * MS + t], kt = in(QK, buf, t, key);
        du_acc = fmaf(in(QR, buf, t, key) * kt, mtt, du_acc);
        if (t < n) {
          const size_t off = base + (size_t)(t0 + t) * step + key;
          dr[off] = pdr[e] + fmaf(pre[t * TS + key], ys[key * YS + t],
                                  uk * kt * mtt);
          dw[off] = pdw[e];
        }
      }
    }
    // A[t][s] = sum_i kap_s[t][i] r_s[i] (t < s), sum_i u_i k_t[i] r_t[i]
    // (t = s): a thread one pair, its 16-byte walk over the keys rotated
    // by the pair so that a warp's reads of the table fall in more banks
    for (int p = tid; p < NPAIRD; p += THREADS) {
      int sv = 0;
      while (pair_d(0, sv + 1) <= p) ++sv;
      const int tv = p - pair_d(0, sv);
      const float4* row = reinterpret_cast<const float4*>(
          tv < sv ? kap + (sv * C + tv) * TS : diag + tv * TS);
      const float4* rs = reinterpret_cast<const float4*>(&in(QR, buf, sv, 0));
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int j = 0; j < K / 4; ++j) {
        const int jj = (j + p) & (K / 4 - 1);
        const float4 x4 = row[jj], y4 = rs[jj];
        a0 = fmaf(x4.x, y4.x, a0);
        a1 = fmaf(x4.y, y4.y, a1);
        a2 = fmaf(x4.z, y4.z, a2);
        a3 = fmaf(x4.w, y4.w, a3);
      }
      ah[p] = (a0 + a1) + (a2 + a3);
    }
    // dv = Kt G_e + A DO: a warp's 8-column tiles (Kt G_e here)
    float dva[DVT][1][4];
#pragma unroll
    for (int jt = 0; jt < DVT; ++jt)
      if (warp + jt * NW < NT)
        tile_mma<K / 8, 1>(
            dva[jt], 0, (warp + jt * NW) * 8, lane,
            [&](int t, int i) { return ktil[t * BS + i]; },
            [&](int i, int j) { return gs[i * RS + j]; });
    // G before the chunk = P(0, C) G_e + Rt^T DO
    update_state(rtil, &in(QDO, buf, 0, 0));
    __syncthreads();

    // phase 3: dv's A DO and the bonus, written
#pragma unroll
    for (int jt = 0; jt < DVT; ++jt) {
      const int tile = warp + jt * NW;
      if (tile >= NT) continue;
      float acc[1][4];
      tile_mma<C / 8, 1>(
          acc, 0, tile * 8, lane,
          [&](int t, int s) { return t <= s ? ah[pair_d(t, s)] : 0.f; },
          [&](int s, int j) { return in(QDO, buf, s, j); });
      const int col = tile * 8 + 2 * t4;  // a new tensor: aligned
      if (g < n)
        *reinterpret_cast<float2*>(dv + base + (size_t)(t0 + g) * step +
                                   col) =
            make_float2(dva[jt][0][0] + acc[0][0], dva[jt][0][1] + acc[0][1]);
      if (g + 8 < n)
        *reinterpret_cast<float2*>(dv + base +
                                   (size_t)(t0 + g + 8) * step + col) =
            make_float2(dva[jt][0][2] + acc[0][2], dva[jt][0][3] + acc[0][3]);
    }
    __syncthreads();  // this buffer and the tables are consumed
  }
  store_state(dstate + srow);
#pragma unroll
  for (int o = 1; o < KT; o <<= 1)
    du_acc += __shfl_xor_sync(0xffffffffu, du_acc, o);
  if (q == 0) du_part[(size_t)bh * K + key] = du_acc;
}

// du[h][i] = sum over b, in order, of du_part[b][h][i]
__global__ void rwkv6_du_sum_kernel(const float* __restrict__ du_part,
                                    float* __restrict__ du, int B, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc += du_part[(size_t)b * n + e];
  du[e] = acc;
}

template <int K>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* s_in,
                   const float* dout, const float* ds, float* dr, float* dk,
                   float* dv, float* dw, float* du, float* dstate,
                   float* chk, float* du_part, int B, int L, int H,
                   cudaStream_t stream) {
  const size_t smem = Cfg<K>::TOTAL * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_scan_bwd_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  // 16-byte copies when every sequence is 16-byte aligned (K is a
  // multiple of 4, so then every row is)
  const int wide = ((reinterpret_cast<uintptr_t>(r) |
                     reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v) |
                     reinterpret_cast<uintptr_t>(w) |
                     reinterpret_cast<uintptr_t>(dout)) & 15) == 0;
  rwkv6_scan_bwd_kernel<K><<<B * H, THREADS, smem, stream>>>(
      r, k, v, w, u, s_in, dout, ds, dr, dk, dv, dw, dstate, chk, du_part,
      L, H, wide);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = H * K;
  rwkv6_du_sum_kernel<<<(n + 255) / 256, 256, 0, stream>>>(du_part, du, B,
                                                           n);
  return cudaGetLastError();
}

}  // namespace

// The states the kernel saves for L steps, each of a sequence and head
// (the state before each chunk of C steps): the wrapper allocates B H K^2
// floats of scratch for each.
extern "C" int rwkv6_scan_bwd_saved(int L) { return (L + C - 1) / C; }

// Returns the launches' cudaError_t; cudaErrorInvalidValue for a head size
// K that is not instantiated (16: the reduced test configurations, 64:
// rwkv6-7b).  chk holds rwkv6_scan_bwd_saved(L) B H K^2 floats, du_part
// B H K.
extern "C" int rwkv6_scan_bwd_launch(
    const float* r, const float* k, const float* v, const float* w,
    const float* u, const float* s_in, const float* dout, const float* ds,
    float* dr, float* dk, float* dv, float* dw, float* du, float* dstate,
    float* chk, float* du_part, int B, int L, int H, int K,
    cudaStream_t stream) {
  switch (K) {
    case 16:
      return launch<16>(r, k, v, w, u, s_in, dout, ds, dr, dk, dv, dw, du,
                        dstate, chk, du_part, B, L, H, stream);
    case 64:
      return launch<64>(r, k, v, w, u, s_in, dout, ds, dr, dk, dv, dw, du,
                        dstate, chk, du_part, B, L, H, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
