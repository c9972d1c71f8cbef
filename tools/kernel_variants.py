#!/usr/bin/env python3
"""Time edited copies of the port's CUDA kernels beside the committed ones,
in one process on one card.

    python3 tools/kernel_variants.py            # every experiment
    python3 tools/kernel_variants.py k5         # K5's only (or k1, k34, k5bwd,
                                                # k6, k7, k6bwd, k7bwd, k8,
                                                # or several)
    python3 tools/kernel_variants.py k5bwd --train   # and the train steps

Each variant is the committed source in ``src/repro_torch/kernels/csrc/``
with the text replacements of its entry in ``EXPERIMENTS`` applied, or a
whole earlier source kept under ``tools/variant_sources/`` (an entry that
names a file).  A variant is a measurement, not a fix: some compute wrong
results on purpose (to find what a part of a kernel costs), and the script
reports whether each one still matches the plain version.  The variants
are compiled with the port's ``nvcc`` flags into ``build/variants/``
(gitignored), swapped in for the committed library, and timed on the
device alone (calls queued behind a spin kernel, as ``chip_smoke.py``'s
``device_ms``): K1 on the bbd-20k adjacency (the kernel path's shape) and
on a random 1 % 4096^2 one, K5 at the standing prefill shape
(8, 16, 512, 512, 64) and at smollm-135m's grouped prefill, K3/K4 (k34)
mapped over each of bbd-20k's four largest levels in float64 and float32
and dense at K4 float64's (243, 8, 1, 1) and K3 float64's (8, 1, 1), K6
and K7 at ``chip_smoke.py``'s prefill shapes (zero state) and decode
shapes (a state), held to its ``SCAN_TOL`` on the output and the final
state, K5's backward (k5bwd) at ``chip_smoke.py``'s ``K5_BWD_SHAPES`` in
float32, held to its ``K5_BWD_TOL`` of each gradient's largest against
the plain backward and to a bitwise repeat, K6's and K7's backwards
(k6bwd, k7bwd) at the prefill shapes from a zero and a non-zero state,
held to ``SCAN_TOL`` of each gradient's largest and to a bitwise repeat,
K8 (k8) at one superstep of four chunks of a 24,576-row HPCG pattern in
nested-dissection order (S = 512; the committed variant's line adds the
plain version's ms and the byte bound), held bitwise to the plain version
(the timed launches repeat the superstep over their own output, so later
ones see another frontier).
With ``--train`` (k5bwd),
the smollm-135m and whisper-tiny train steps of ``chip_smoke.py``'s train
phases then run with the committed backward and its CUDA-core
predecessor (``simt``) in turns: committed, simt, simt, committed, 4
steps each, host ms a step ending in a synchronize.  A K3/K4 variant that
changes the tile kinds names its rule in ``RULES``; the tile records are
rebuilt with it.  Prints one JSON line per
variant (or its build log, when it does not build), then the card's name
and power limit.
"""
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "variants"
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"

# (kernel, name) -> [(old text, new text), ...]
EXPERIMENTS = {
    ("k1", "committed"): [],
    # the stream alone: no tile is relaxed (wrong results)
    ("k1", "no_relax"): [("if (!__syncthreads_or(nz)) continue;",
                          "if (!__syncthreads_or(nz) || V > 0) continue;")],
    ("k1", "waves_4"): [("constexpr int WAVES = 16;",
                         "constexpr int WAVES = 4;")],
    ("k1", "waves_32"): [("constexpr int WAVES = 16;",
                          "constexpr int WAVES = 32;")],
    ("k1", "strips_in_order"): [
        ("const int strip = strips - 1 - blockIdx.x % strips;",
         "const int strip = blockIdx.x % strips;")],
    # plain stores in place of atomicMin (wrong results where two blocks
    # share a strip): what the merge costs
    ("k1", "stores_not_atomics"): [
        ("atomicMin(row + v0, acc0[i])", "row[v0] = acc0[i]"),
        ("atomicMin(row + v0 + 32, acc1[i])", "row[v0 + 32] = acc1[i]")],
    ("k5", "committed"): [],
    # one TF32 product in place of three (wrong results): what the two
    # correction products cost
    ("k5", "one_product"): [("""  mma_tf32(c, a_lo, b_hi);
  mma_tf32(c, a_hi, b_lo);
  mma_tf32(c, a_hi, b_hi);""", "  mma_tf32(c, a_hi, b_hi);")],
    # no split (hi = x, lo = 0; wrong results): what the splits cost
    ("k5", "no_split"): [(
        """  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;""",
        """  hi = __float_as_uint(x);
  lo = 0u;""")],
    # K/V tiles of 64 or 16 keys in place of 32: registers and shared
    # memory per block against barriers per key
    ("k5", "keys_64_per_tile"): [(
        "constexpr int BKV = 32;          // keys per tile",
        "constexpr int BKV = 64;          // keys per tile")],
    ("k5", "keys_16_per_tile"): [(
        "constexpr int BKV = 32;          // keys per tile",
        "constexpr int BKV = 16;          // keys per tile")],
    # 128 query rows (8 warps) per block sharing each K/V tile
    ("k5", "rows_128_per_block"): [
        ("constexpr int PF_THREADS = 128;  // 4 warps x 16 query rows",
         "constexpr int PF_THREADS = 256;  // 4 warps x 16 query rows"),
        ("constexpr int BQ = 64;           // query rows per block",
         "constexpr int BQ = 128;          // query rows per block")],
    # the split with the conversion instruction, rounding both parts
    ("k5", "cvt_split"): [(
        """  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;""",
        """  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));""")],
    ("k5bwd", "committed"): [],
    # the kernel before its redesign: float32 FMAs on the CUDA cores, P and
    # dS through shared memory, synchronous staging, no split dQ walk
    ("k5bwd", "simt"): "flash_attention_bwd_simt.cu",
    # no walk is split (whisper's cross shape: 48 dq blocks; internvl: 192
    # dk/dv blocks), or only dq's
    ("k5bwd", "no_split"): [(
        "  if (blocks <= 0 || blocks >= want) return 1;", "  return 1;")],
    ("k5bwd", "no_kv_split"): [(
        "  return split(static_cast<long long>(kv_tiles) * Hkv * B, per_sm, "
        "kv_steps);", "  return 1;")],
    # one TF32 product in place of three (wrong results): what the two
    # correction products cost
    ("k5bwd", "one_product"): [("""  mma_tf32(c, a_lo, b_hi);
  mma_tf32(c, a_hi, b_lo);
  mma_tf32(c, a_hi, b_hi);""", "  mma_tf32(c, a_hi, b_hi);")],
    # no split (hi = x, lo = 0; wrong results): what the splits cost
    ("k5bwd", "no_tf32_split"): [(
        """  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;""",
        """  hi = __float_as_uint(x);
  lo = 0u;""")],
    # hi truncated to TF32 (not rounded) and lo left for the tensor cores
    # to truncate: two ops a split in place of four, one bit less exact
    ("k5bwd", "truncated_split"): [(
        """  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;""",
        """  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));""")],
    # only the dk/dv kernel, or only the dq kernel (wrong results): what
    # each takes
    ("k5bwd", "no_dq"): [("  flash_bwd_dq_kernel<T, D>\n      <<<",
                          "  if (a.B < 0) flash_bwd_dq_kernel<T, D>\n      <<<")],
    ("k5bwd", "no_dkdv"): [(
        "  flash_bwd_dkdv_kernel<T, D>\n      <<<",
        "  if (a.B < 0) flash_bwd_dkdv_kernel<T, D>\n      <<<")],
    # the long sums added in float32 after every k-step, not every 4
    ("k5bwd", "add_every_kstep"): [
        ("constexpr int JG = NQ < 4 ? NQ : 4;", "constexpr int JG = 1;"),
        ("constexpr int JG = NK < 4 ? NK : 4;", "constexpr int JG = 1;")],
    # D = 64: 64 queries a dk/dv step in place of 32, or 64 keys a dq step
    # in place of 32
    ("k5bwd", "d64_dkdv_bq_64"): [(
        """struct KvCfg<64> {
  static constexpr int WK = 4, NDS = 1, BQ = 32;""",
        """struct KvCfg<64> {
  static constexpr int WK = 4, NDS = 1, BQ = 64;""")],
    ("k5bwd", "d64_dq_bk_64"): [(
        """struct QCfg<64> {
  static constexpr int WQ = 4, BK = 32;""",
        """struct QCfg<64> {
  static constexpr int WQ = 4, BK = 64;""")],
    # D = 64: 8 warps of 16 queries a dq block, 128 queries (two blocks an
    # SM, 16 warps)
    ("k5bwd", "d64_dq_8_warps"): [(
        """struct QCfg<64> {
  static constexpr int WQ = 4, BK = 32;""",
        """struct QCfg<64> {
  static constexpr int WQ = 8, BK = 32;""")],
    # D = 64: dk/dv held to 170 registers a thread, three blocks an SM
    ("k5bwd", "d64_dkdv_3_blocks"): [(
        """template <typename T, int D>
__global__ void __launch_bounds__(KvSmem<D>::NT)""",
        """template <typename T, int D>
__global__ void __launch_bounds__(KvSmem<D>::NT, D == 64 ? 3 : 1)""")],
    # D = 64: two warps to each 16 keys (each half of the step's scores and
    # half of dK, dV, trading P^T and dS^T as at D = 256) in place of one
    ("k5bwd", "d64_two_warps_a_key_tile"): [(
        """struct KvCfg<64> {
  static constexpr int WK = 4, NDS = 1, BQ = 32;""",
        """struct KvCfg<64> {
  static constexpr int WK = 4, NDS = 2, BQ = 32;""")],
    # D = 128: 32 queries a dk/dv step and 32 keys a dq step in place of
    # 16 (one block an SM in place of two), or two warps to each 16 keys
    ("k5bwd", "d128_tiles_32"): [
        ("""struct KvCfg<128> {
  static constexpr int WK = 4, NDS = 1, BQ = 16;""",
         """struct KvCfg<128> {
  static constexpr int WK = 4, NDS = 1, BQ = 32;"""),
        ("""struct QCfg<128> {
  static constexpr int WQ = 4, BK = 16;""",
         """struct QCfg<128> {
  static constexpr int WQ = 4, BK = 32;""")],
    ("k5bwd", "d128_two_warps_a_key_tile"): [(
        """struct KvCfg<128> {
  static constexpr int WK = 4, NDS = 1, BQ = 16;""",
        """struct KvCfg<128> {
  static constexpr int WK = 4, NDS = 2, BQ = 16;""")],
    ("k34", "committed"): [],
    # up to 128 rows for the small tiles (TC >= 1): 16 staged L loads a
    # thread, not 4
    ("k34", "small_rows_128"): [(
        "constexpr int SMALL_BK = 16, SMALL_TC_MIN = 4,",
        "constexpr int SMALL_BK = 16, SMALL_TC_MIN = 1,")],
    # 64-deep chunks for the large tiles: 16 + 16 staged loads, not 8 + 8
    ("k34", "large_bk_64"): [(
        "constexpr int LARGE_BK = 32,", "constexpr int LARGE_BK = 64,")],
    # both: the tiles of this kernel's first version on the card
    ("k34", "small_rows_128_large_bk_64"): [
        ("constexpr int SMALL_BK = 16, SMALL_TC_MIN = 4,",
         "constexpr int SMALL_BK = 16, SMALL_TC_MIN = 1,"),
        ("constexpr int LARGE_BK = 32,", "constexpr int LARGE_BK = 64,")],
    # the mapped kernel held to 4 or 8 resident blocks per SM
    ("k34", "bounds_4"): [(
        "__global__ void __launch_bounds__(THREADS)\n"
        "panel_update_mapped_kernel",
        "__global__ void __launch_bounds__(THREADS, 4)\n"
        "panel_update_mapped_kernel")],
    ("k34", "bounds_8"): [(
        "__global__ void __launch_bounds__(THREADS)\n"
        "panel_update_mapped_kernel",
        "__global__ void __launch_bounds__(THREADS, 8)\n"
        "panel_update_mapped_kernel")],
    ("k6", "committed"): [],
    # the kernel before its redesign: one thread per channel, x and dt
    # loaded 16 steps ahead into registers, the accurate expf, scalar B_t /
    # C_t reads, each thread's state row and A row read and written
    # straight from device memory
    ("k6", "first_version"): "mamba_scan_state_per_thread.cu",
    # one channel a thread: every B_t / C_t float read from shared memory
    # serves one element, not two
    ("k6", "one_channel_per_thread"): [
        ("constexpr int CH = 2; ", "constexpr int CH = 1; ")],
    # no exponential (wrong results): what the EX2s cost
    ("k6", "no_exp"): [(
        'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "y = x;")],
    # the accurate expf of the unscaled argument in place of one EX2
    ("k6", "accurate_expf"): [
        ("an[c][n] = sa[row * HP + n] * LOG2E;",
         "an[c][n] = sa[row * HP + n];"),
        ('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
         "y = expf(x);")],
    # B_t and C_t read as 4 scalars (volatile: no merged load)
    ("k6", "scalar_shared_reads"): [(
        "  return *reinterpret_cast<const float4*>(p);",
        "  const volatile float* q = p;\n"
        "  return make_float4(q[0], q[1], q[2], q[3]);")],
    # each thread's state rows and A rows straight from device memory
    ("k6", "state_per_thread"): [
        ("""  for (int e = threadIdx.x; e < BLOCK * N; e += THREADS) {
    const bool on = e < nlive;
    sh[(e / N) * HP + e % N] = on ? h_in[hoff + e] : 0.f;
    sa[(e / N) * HP + e % N] = on ? a[(size_t)d0 * N + e] : 0.f;
  }
  __syncthreads();
""", ""),
        ("""      h[c][n] = sh[row * HP + n];
      an[c][n] = sa[row * HP + n] * LOG2E;""",
         """      h[c][n] = live[c] ? h_in[hoff + row * N + n] : 0.f;
      an[c][n] = live[c] ? a[(size_t)(d0 + row) * N + n] * LOG2E : 0.f;"""),
        ("""      sh[(threadIdx.x + THREADS * c) * HP + n] = h[c][n];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nlive; e += THREADS) {
    h_out[hoff + e] = sh[(e / N) * HP + e % N];
  }""", """      if (live[c]) {
        h_out[hoff + (threadIdx.x + THREADS * c) * N + n] = h[c][n];
      }
    }
  }""")],
    # y not stored, or x, dt, B_t, C_t not copied (wrong results): what
    # the stores and the copies cost
    ("k6", "no_y_stores"): [("        if (live[c]) {\n          y[xb",
                             "        if (acc[c] == 1.2345f) {\n          y[xb")],
    ("k6", "no_copies"): [("        if (t0 + tt < L && j4 < live_ch) {",
                           "        if (t0 + tt < 0 && j4 < live_ch) {")],
    # x and dt copied 4 bytes at a time, not 16
    ("k6", "copies_4_bytes"): [(
        "const bool wide = aligned16(x, dt) && DI % 4 == 0;",
        "const bool wide = false;")],
    # each tile copied only when it is needed, not under the one before
    ("k6", "no_prefetch"): [(
        """    if (tile + 1 < tiles) {  // the next tile streams in under this one
      stage(tile + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }""", """    if (tile > 0) stage(tile);
    cp_async_wait<0>();""")],
    ("k7", "committed"): [],
    # the kernel before its redesign: one thread per value column, the
    # bonus term inside every (i, j), scalar shared reads
    ("k7", "first_version"): "rwkv6_scan_column_per_thread.cu",
    # keys split in 4 groups, one column per thread (256 threads a head),
    # r, k, w as float4: every (i, j) pair still takes 3 shared floats
    ("k7", "one_column_per_thread"): "rwkv6_scan_one_column_per_thread.cu",
    # 8 key groups x 8 columns a thread in place of 4 x 4 (K = 64 only:
    # the K = 16 instance would have 2 keys a thread)
    ("k7", "groups_8_columns_8"): [
        ("constexpr int G = 4;", "constexpr int G = 8;"),
        ("constexpr int J = 4;", "constexpr int J = 8;"),
        ("""    case 16:
      return launch<16>(r, k, v, w, u, s_in, o, s_out, B, L, H, stream);
""", "")],
    # one step at a time, not two in flight
    ("k7", "no_unroll"): [(
        "#pragma unroll 2\n"
        "    for (int tt = 0; tt < n; ++tt) {  // n is uniform across the block",
        "    for (int tt = 0; tt < n; ++tt) {  // n is uniform across the block")],
    # r, k, v, w copied 4 bytes at a time, not 16
    ("k7", "copies_4_bytes"): [(
        "const bool wide = aligned16(r, k, v, w);",
        "const bool wide = false;")],
    # r, k and w read as 4 scalars (volatile: no merged load)
    ("k7", "scalar_shared_reads"): [(
        "  return *reinterpret_cast<const float4*>(p);",
        "  const volatile float* q = p;\n"
        "  return make_float4(q[0], q[1], q[2], q[3]);")],
    # the key groups' rows not padded: the groups' float4 reads share banks
    ("k7", "unpadded_rows"): [(
        "constexpr int GROW = KG + 4;", "constexpr int GROW = KG;")],
    # the exchanges, the bonus sums or the copies left out (wrong
    # results): what each costs
    ("k7", "no_exchanges"): [(
        "acc[c] = keep + __shfl_xor_sync(MASK, send, m);",
        "acc[c] = keep + send;")],
    ("k7", "no_bonus_sums"): [(
        "    for (int tt = tid / G; tt < TT; tt += THREADS / G) {",
        "    for (int tt = tid / G; tt < 0; tt += THREADS / G) {")],
    ("k7", "no_copies"): [(
        "      if (t0 + tt < L) {\n        const size_t off = base",
        "      if (t0 + tt < 0) {\n        const size_t off = base")],
    # each tile copied only when it is needed, not under the one before
    ("k7", "no_prefetch"): [(
        """    if (tile + 1 < tiles) {  // the next tile streams in under this one
      stage(tile + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }""", """    if (tile > 0) stage(tile);
    cp_async_wait<0>();""")],
}
# K7's and K6's backwards: each against its predecessor (whole sources:
# K7's step-by-step walk on the CUDA cores, K6's one channel a thread),
# the design's choices, and what a part costs (wrong results)
EXPERIMENTS.update({
    ("k7bwd", "committed"): [],
    ("k7bwd", "step_walk"): "rwkv6_scan_bwd_step_walk.cu",
    # chunks of 8 steps (twice the saved states, a quarter of the decay
    # table); chunks of 32 do not fit: the table alone is 295 KB.  K = 64
    # only (K = 16 would have 16 threads a key for 8 steps)
    ("k7bwd", "chunk_8"): [
        ("constexpr int C = 16; ", "constexpr int C = 8; "),
        ("""    case 16:
      return launch<16>(r, k, v, w, u, s_in, dout, ds, dr, dk, dv, dw, du,
                        dstate, chk, du_part, B, L, H, stream);
""", "")],
    # 4 warps a block in place of 8; the forward sweep's copies 3 chunks
    # ahead in place of 1
    ("k7bwd", "threads_128"): [("constexpr int THREADS = 256;",
                                "constexpr int THREADS = 128;")],
    ("k7bwd", "forward_4_buffers"): [("constexpr int NFB = 2; ",
                                      "constexpr int NFB = 4; ")],
    ("k7bwd", "no_forward_sweep"): [
        ("    update_state(ktil, fseq(fb, 1));\n", "")],
    ("k7bwd", "no_pairs"): [
        ("for (int p = tid; p < NPAIRD; p += THREADS) {",
         "for (int p = tid; p < 0; p += THREADS) {")],
    ("k7bwd", "no_per_key_walk"): [
        ("""      for (int t = C - 1; t >= 0; --t) {
        const float mtt""", """      for (int t = C - 1; t >= C; --t) {
        const float mtt""")],
    ("k7bwd", "no_products"): [
        ("for (int job = warp; job < 2 * MT; job += NW) {",
         "for (int job = warp; job < 0; job += NW) {")],
    ("k7bwd", "no_tables"): [
        ("for (int s = 1; s < C; ++s) {\n          if (s > t) {",
         "for (int s = C; s < C; ++s) {\n          if (s > t) {")],
    ("k7bwd", "no_g_update"): [
        ("    update_state(rtil, &in(QDO, buf, 0, 0));\n", "")],
    ("k7bwd", "no_dv"): [
        ("      if (warp + jt * NW < NT)\n", "      if (warp + jt * NW < 0)\n"),
        ("      if (tile >= NT) continue;", "      if (tile >= 0) continue;")],
    ("k6bwd", "committed"): [],
    ("k6bwd", "one_channel"): "mamba_scan_bwd_one_channel.cu",
    ("k6bwd", "tile_4"): [("constexpr int TT = 8; ", "constexpr int TT = 4; ")],
    ("k6bwd", "tile_16"): [("constexpr int TT = 8; ",
                            "constexpr int TT = 16; ")],
    # 64 channels a block (2 warps, twice the blocks), and the registers
    # of 3 blocks an SM in place of 2 (the saved state's early read then
    # spills)
    ("k6bwd", "channels_64_a_block"): [(
        "constexpr int CPB = 128; ", "constexpr int CPB = 64; ")],
    ("k6bwd", "three_blocks_an_sm"): [(
        "__launch_bounds__(Cfg<N>::THREADS, 2)",
        "__launch_bounds__(Cfg<N>::THREADS, 3)")],
    # the saved state read at the tile's start, not during the walk before
    ("k6bwd", "saved_state_read_late"): [
        ("      if (tt == TT - 3 && cc > 0) load_saved(cc - 1);\n", ""),
        ("    __syncthreads();\n    // the tile's states h_{t-1}, recomputed",
         "    __syncthreads();\n    if (cc < nc - 1) load_saved(cc);\n"
         "    // the tile's states h_{t-1}, recomputed")],
    # the walk's exponential left out (a_t = 1): what keeping a_t from the
    # recompute could save at most
    ("k6bwd", "no_walk_exp"): [(
        "const float an = ex2(dtv[c] * al[c][j]);", "const float an = 1.f;")],
    ("k6bwd", "no_first_sweep"): [(
        "for (int tt = 0; tt < TT; ++tt) advance(tt, false);  // a whole tile",
        "")],
    ("k6bwd", "no_recompute"): [("if (tt < nt) advance(tt, true);",
                                 "if (tt < 0) advance(tt, true);")],
    ("k6bwd", "no_saved_state_stores"): [(
        "    for (int q = 0; q < NQ; ++q)\n#pragma unroll\n"
        "      for (int c = 0; c < 2; ++c)\n        my_chk[",
        "    for (int q = 0; q < 0; ++q)\n#pragma unroll\n"
        "      for (int c = 0; c < 2; ++c)\n        my_chk[")],
    ("k6bwd", "no_warp_sums"): [("halve<W0, 16, NS>(col, lane, idx);", "")],
    ("k6bwd", "no_dx_ddt"): [(
        "          if (live[c]) {\n            const size_t off",
        "          if (live[c] && L < 0) {\n            const size_t off")],
})
EXPERIMENTS.update({
    ("k8", "committed"): [],
    # every row relaxed on every superstep: what skipping the rows that
    # had no frontier on the previous one saves
    ("k8", "no_row_skip"): [(
        "row_live[i] = it == 0 || conv[s0 + i] >= it;", "row_live[i] = 1;")],
    # the in-neighbour table read from device memory (L1) for every source
    ("k8", "table_not_staged"): [(
        "  return K <= MAX_STAGED_K\n", "  return K <= 0\n")],
    # tiles of 64 or 256 vertices: table reloads against warps per block
    ("k8", "tile_64"): [("constexpr int TV = 128; ", "constexpr int TV = 64; ")],
    ("k8", "tile_256"): [
        ("constexpr int TV = 128; ", "constexpr int TV = 256; ")],
    # fewer or more blocks over the grid (source groups of other sizes)
    ("k8", "waves_8"): [("constexpr int WAVES = 32;", "constexpr int WAVES = 8;")],
    ("k8", "waves_128"): [
        ("constexpr int WAVES = 32;", "constexpr int WAVES = 128;")],
    ("k8", "warps_8"): [("constexpr int WARPS = 16;", "constexpr int WARPS = 8;")],
    ("k8", "warps_32"): [
        ("constexpr int WARPS = 16;", "constexpr int WARPS = 32;")],
})
SOURCE = {"k1": "minmax_relax", "k5": "flash_attention",
          "k5bwd": "flash_attention_bwd",
          "k34": "panel_update", "k6": "mamba_scan", "k7": "rwkv6_scan",
          "k6bwd": "mamba_scan_bwd", "k7bwd": "rwkv6_scan_bwd",
          "k8": "ell_superstep"}
VARIANT_SOURCES = ROOT / "tools" / "variant_sources"
# K3/K4 variants' tile kinds, ((small TC range, BK), (large TC range, BK)),
# where they differ from ops.panel_tile's
RULES = {
    ("k34", "small_rows_128"): (((1, 64), 16), ((4, 32), 32)),
    ("k34", "large_bk_64"): (((4, 64), 16), ((4, 32), 64)),
    ("k34", "small_rows_128_large_bk_64"): (((1, 64), 16), ((4, 32), 64)),
}


def build(todo):
    """Compile every variant in parallel; {key: library path} of those
    that built (a failed build prints its log and is left out)."""
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for key in todo:
        kern, name = key
        spec = EXPERIMENTS[key]
        if isinstance(spec, str):
            text, spec = (VARIANT_SOURCES / spec).read_text(), []
        else:
            text = (CSRC / f"{SOURCE[kern]}.cu").read_text()
        for old, new in spec:
            if old not in text:
                raise SystemExit(f"{key}: the source no longer has {old!r}")
            text = text.replace(old, new)
        cu = OUT / f"{kern}_{name}.cu"
        cu.write_text(text)
        procs[key] = (cu.with_suffix(".so"), subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
             str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:     # reported, and the other variants still run
            print(json.dumps({"kernel": key[0], "variant": key[1],
                              "build_failed": log[-2000:]}), flush=True)
            continue
        so.with_suffix(".log").write_text(log)    # the -Xptxas -v report
        libs[key] = so
    return libs


def swap_in(kern, so):
    """Every launcher of the kernel's source from library ``so``."""
    from repro_torch.kernels import _build

    lib = ctypes.CDLL(str(so))
    for name, (source, symbol, argtypes) in _build.SIGNATURES.items():
        if source == SOURCE[kern]:
            fn = getattr(lib, symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _build._FUNCS[name] = fn


def use_rule(ops, rule):
    """Point ``ops._tile_shapes`` at a variant's tile kinds (None: the
    committed ones)."""
    import numpy as np

    if not hasattr(ops, "_committed_tile_shapes"):
        ops._committed_tile_shapes = ops._tile_shapes
    if rule is None:
        ops._tile_shapes = ops._committed_tile_shapes
        return
    ((s_lo, s_hi), s_bk), ((l_lo, l_hi), l_bk) = rule

    def shapes(n, k):
        large = k > 16
        tc = np.ones_like(n)
        while (tc < n).any():
            tc = np.where(tc < n, 2 * tc, tc)
        return (np.clip(tc, np.where(large, l_lo, s_lo),
                        np.where(large, l_hi, s_hi)),
                np.where(large, l_bk, s_bk))

    ops._tile_shapes = shapes


def device_ms(torch, fn, n=20, reps=3):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def k1_cases(torch, np, rng):
    from repro_torch import sparse
    from repro_torch.core.gsofa import prepare_graph
    from repro_torch.kernels import plain

    a = sparse.bordered_block_diagonal(20_000, block=16, border=64, seed=3)
    cases = {"bbd": prepare_graph(a, dense_block=128,
                                  device="cuda").adj_dense,
             "random_4096": torch.as_tensor(
                 (rng.random((4096, 4096)) < 0.01).astype(np.uint8),
                 device="cuda")}
    out = {}
    for tag, adj in cases.items():
        u = adj.shape[0]
        prop = torch.as_tensor(rng.integers(0, u, size=(512, u)).astype(
            np.int32), device="cuda")
        out[tag] = ((prop, adj), plain.minmax_relax_plain(prop, adj))
    return out


# K8's chunks of the ell cell's pattern: (first source, superstep)
K8_CHUNKS = (("first", 0, 1), ("middle", 12_288, 3), ("last", 24_064, 3),
             ("last_late", 24_064, 12))


def k8_cases(torch, np):
    """K8 at the ell cell's shape: a 24,576-row HPCG 27-point pattern in
    nested-dissection order (``portbench/generators/hpcg27.py``, seed 1),
    512 sources a chunk, each case one superstep of one chunk, its state
    reached by running the committed kernel up to it.  A case is (state,
    the plain version's result of that superstep)."""
    sys.path.insert(0, str(ROOT))
    from portbench.generators import hpcg27
    from repro_torch.core import gsofa
    from repro_torch.kernels import ops, plain
    from repro_torch.sparse.csr import CSRMatrix

    n, indptr, indices = hpcg27.generate(1, nx=32, ny=32, nz=24)
    graph = gsofa.prepare_graph(CSRMatrix(n=n, indptr=indptr,
                                          indices=indices), device="cuda")
    out = {}
    for tag, first, step in K8_CHUNKS:
        srcs = torch.arange(first, first + 512, dtype=torch.int32,
                            device="cuda")
        labels = gsofa.init_labels(graph, srcs)
        state = [labels, torch.empty_like(labels),
                 torch.zeros(512, dtype=torch.int32, device="cuda"),
                 torch.zeros(512, dtype=torch.int32, device="cuda"),
                 torch.zeros(1, dtype=torch.int32, device="cuda")]
        for it in range(step):
            ops.ell_superstep(*state[:2], graph.in_ell, graph.out_deg, srcs,
                              *state[2:], offset=0, it=it)
            state[:2] = state[1::-1]
        want = [t.clone() for t in state]
        plain.ell_superstep_plain(*want[:2], graph.in_ell, graph.out_deg,
                                  srcs, *want[2:], offset=0, it=step)
        out[tag] = ((graph, srcs, state, step), want)
    return out


def k8_run(torch, ops, plain, args, want):
    """(launch, matches_plain, plain_launch, (bytes, ops)) of one K8
    case: the launch works on a copy of the case's state."""
    from repro_torch.kernels import work

    graph, srcs, state, step = args
    mine = [t.clone() for t in state]
    theirs = [t.clone() for t in state]

    def launch():
        ops.ell_superstep(*mine[:2], graph.in_ell, graph.out_deg, srcs,
                          *mine[2:], offset=0, it=step)

    def plain_launch():
        plain.ell_superstep_plain(*theirs[:2], graph.in_ell, graph.out_deg,
                                  srcs, *theirs[2:], offset=0, it=step)

    launch()
    right = all(torch.equal(x, y) for x, y in zip(mine[1:], want[1:]))
    for t, s in zip(mine, state):
        t.copy_(s)
    return launch, right, plain_launch, work.ell_superstep_work(
        512, graph.n, graph.in_ell.shape[1])


def k5_cases(torch, np, rng):
    from repro_torch.kernels import plain

    out = {}
    for tag, (b, h, live, hkv, s, d) in {
            "standing_prefill": (8, 16, 16, 16, 512, 64),
            "smollm_prefill": (8, 16, 9, 3, 512, 64)}.items():
        q, k, v = (torch.as_tensor(rng.standard_normal(sh).astype(
            np.float32), device="cuda")
            for sh in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d)))
        kw = {"causal": True, "live_heads": live}
        out[tag] = ((q, k, v, kw), plain.flash_attention_plain(q, k, v,
                                                                **kw))
    return out


def k34_cases(torch, np, rng):
    """{tag: (fn(), check())}: the mapped update over each of bbd-20k's four
    largest levels (float64 and float32, tile records rebuilt at each call
    of ``prepare``) on a store of its factors with random U rows, and dense
    K4 / K3 float64 at the sweep's commonest shapes; ``check`` says whether
    the kernel matched its plain version (dense: K4 bitwise K3 per slice;
    mapped: within 1e-14 / 2e-6 x K x max|L| x max|U|)."""
    import repro_torch
    from repro_torch import sparse
    from repro_torch.kernels import ops, plain
    from repro_torch.sparse.numeric import generic_values_csr

    a = sparse.bordered_block_diagonal(20_000, block=16, border=64, seed=3)
    plan = repro_torch.analyze(a, repro_torch.LUOptions(concurrency=512))
    flat = plan.factorize(generic_values_csr(a)).store.flat
    upd = plan._device_state(torch.device("cuda"))[2]
    bounds = [int(x) for x in upd.level_tiles]
    t_all = upd.tiles.cpu().numpy()
    levels = []
    for li, (lo, hi) in enumerate(zip(bounds, bounds[1:])):
        t = t_all[lo:hi]
        levels.append((int(((t[:, 6] == 0) & (t[:, 7] == 0)).sum()), li,
                       t[(t[:, 6] == 0) & (t[:, 7] == 0), :6]))
    cases = {}
    for _, li, recs in sorted(levels, reverse=True)[:4]:
        u = torch.as_tensor(rng.standard_normal(
            int((recs[:, 4] * recs[:, 5]).sum())), device="cuda")
        for f32 in (False, True):
            def make(recs=recs, u=u, f32=f32):
                tiles = torch.as_tensor(ops.mapped_tiles(recs), device="cuda")
                work = flat.clone()

                def check():
                    got, want = flat.clone(), flat.clone()
                    ops.panel_update_mapped(got, u, upd.lmap, tiles, f32=f32)
                    plain.panel_update_mapped_plain(want, u, upd.lmap, tiles,
                                                    f32=f32)
                    tol = ((2e-6 if f32 else 1e-14) * int(recs[:, 5].max())
                           * float(flat.abs().max()) * float(u.abs().max()))
                    return float((got - want).abs().max()) <= tol

                return (lambda: ops.panel_update_mapped(
                    work, u, upd.lmap, tiles, f32=f32)), check
            cases[f"mapped_level{li}_{'f32' if f32 else 'f64'}"] = make
    for tag, (b, m, k, n) in {"dense_k4_243x8x1x1": (243, 8, 1, 1),
                              "dense_k3_8x1x1": (1, 8, 1, 1)}.items():
        acc, lp, up = (torch.as_tensor(rng.standard_normal(sh),
                                       device="cuda")
                       for sh in ((b, m, n), (b, m, k), (b, k, n)))

        def make(acc=acc, lp=lp, up=up, b=b):
            if b == 1:
                return ((lambda: ops.panel_update(acc[0], lp[0], up[0])),
                        lambda: True)
            return ((lambda: ops.panel_update_batched(acc, lp, up)),
                    lambda: all(torch.equal(
                        ops.panel_update_batched(acc, lp, up)[i],
                        ops.panel_update(acc[i], lp[i], up[i]))
                        for i in range(b)))
        cases[tag] = make
    cases["empty_243_blocks"] = lambda: (
        (lambda: ops.panel_update_empty(243, "cuda")), lambda: True)
    return cases


def scan_cases(torch, kern, rng):
    """{tag: (args, want)} for K6 or K7 at ``chip_smoke.py``'s shapes:
    prefill from a zero state, decode from a non-zero one."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import plain

    shapes, inputs, ref = (
        (cs.K6_SHAPES, cs.mamba_inputs, plain.mamba_scan_plain)
        if kern == "k6" else
        (cs.K7_SHAPES, cs.rwkv6_inputs, plain.rwkv6_scan_plain))
    out = {}
    for tag in ("prefill", "decode"):
        args = inputs(torch, rng, *shapes[tag], zero_state=tag == "prefill")
        out[tag] = (args, ref(*args))
    return out


def k5bwd_cases(torch):
    """{tag: (args, want)} for K5's backward at ``chip_smoke.py``'s
    ``K5_BWD_SHAPES`` (float32): q, k, v, the committed forward's output
    and log-sum-exp, dO, the keywords, and the plain backward."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import ops, plain

    out = {}
    for tag, (shape, causal, window) in cs.K5_BWD_SHAPES.items():
        q, k, v, do, kw = cs.k5_bwd_inputs(torch, *shape, causal=causal,
                                           window=window)
        o, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
        out[tag] = ((q, k, v, o, do, lse, kw),
                    plain.flash_attention_backward_plain(q, k, v, o, do, lse,
                                                         **kw))
    return out


def scan_bwd_cases(torch, kern):
    """{tag: (args, want)} for K6's or K7's backward at ``chip_smoke.py``'s
    prefill shapes (the train phases'), from a zero and a non-zero state,
    with normal upstream gradients drawn on the card, and the plain
    backward."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import plain

    kind, shape, ref = (
        ("mamba", cs.K6_SHAPES["prefill"], plain.mamba_scan_backward_plain)
        if kern == "k6bwd" else
        ("rwkv6", cs.K7_SHAPES["prefill"], plain.rwkv6_scan_backward_plain))
    out = {}
    for tag in ("zero", "state"):
        args = cs.scan_bwd_inputs(torch, kind, shape,
                                  zero_state=tag == "zero", seed=1)
        out[tag] = (args, ref(*args))
    return out


def train_ab(torch, libs):
    """{arch: [{variant, step_ms}, ...]}: the train steps of
    ``chip_smoke.py``'s train phases (whole models, float32, micro_steps
    1, the default AdamW) with the committed K5 backward and ``simt`` in
    turns, the same parameters and optimizer carried through."""
    import chip_smoke as cs
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.data import make_batch_for
    from repro_torch.kernels import ops
    from repro_torch.launch.train import device_batch
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import init_adamw
    from repro_torch.train.steps import make_train_step

    out = {}
    for arch, batch, seq in (
            ("smollm-135m", cs.TRAIN_BATCH, cs.TRAIN_SEQ),
            ("whisper-tiny", cs.WHISPER_TRAIN_BATCH, cs.WHISPER_TRAIN_TOKENS)):
        cfg = get_config(arch)
        params = tf.init_params(cfg, seed=0, device="cuda")
        shape = ShapeConfig("train", seq, batch, "train")
        batches = [device_batch(make_batch_for(cfg, shape, step=i),
                                torch.float32, "cuda") for i in range(4)]
        opt = init_adamw(params)
        step = make_train_step(cfg, micro_steps=1)
        tokens = batch * (seq + (cfg.encdec.enc_len if cfg.encdec else 0))
        for name in ("committed", "simt", "simt", "committed"):
            swap_in("k5bwd", libs[("k5bwd", name)])
            params, opt, rows = cs.train_steps(torch, ops, step, params, opt,
                                               batches, tokens)
            out.setdefault(arch, []).append(
                {"variant": name, "step_ms": [r["ms"] for r in rows]})
        del params, opt, batches
        torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    from repro_torch.kernels import ops

    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA card", file=sys.stderr)
        return 2
    train = "--train" in argv
    argv = [a for a in argv if a != "--train"]
    kernels = argv or ["k1", "k5", "k34", "k5bwd", "k6", "k7", "k6bwd",
                       "k7bwd", "k8"]
    libs = build([key for key in EXPERIMENTS if key[0] in kernels])
    todo = list(libs)
    rng = np.random.default_rng(0)
    cases = {"k1": k1_cases(torch, np, rng) if "k1" in kernels else {},
             "k5": k5_cases(torch, np, rng) if "k5" in kernels else {},
             "k34": k34_cases(torch, np, rng) if "k34" in kernels else {},
             "k5bwd": k5bwd_cases(torch) if "k5bwd" in kernels else {},
             "k8": k8_cases(torch, np) if "k8" in kernels else {},
             **{kern: scan_cases(torch, kern, rng) for kern in ("k6", "k7")
                if kern in kernels},
             **{kern: scan_bwd_cases(torch, kern)
                for kern in ("k6bwd", "k7bwd") if kern in kernels}}
    for key in todo:
        kern, name = key
        swap_in(kern, libs[key])
        line = {"kernel": kern, "variant": name}
        if kern == "k34":
            use_rule(ops, RULES.get(key))
            for tag, make in cases["k34"].items():
                fn, check = make()
                line[tag] = {"ms": device_ms(torch, fn),
                             "matches_plain": bool(check())}
            use_rule(ops, None)
            print(json.dumps(line), flush=True)
            continue
        for tag, (args, want) in cases[kern].items():
            if kern == "k8":
                from repro_torch.kernels import plain

                fn, right, plain_fn, (nbytes, _) = k8_run(torch, ops, plain,
                                                          args, want)
                line[tag] = {"ms": device_ms(torch, fn, n=50),
                             "matches_plain": right,
                             "bound_ms": nbytes / 3.35e9}
                if name == "committed":
                    line[tag]["plain_ms"] = device_ms(torch, plain_fn, n=3)
                continue
            if kern == "k1":
                fn = lambda: ops.minmax_relax(*args)
                got = fn()
                right = bool(torch.equal(got, want))
                err = None
            elif kern == "k5bwd":
                import chip_smoke as cs

                q, k, v, o, do, lse, kw = args
                fn = lambda: ops.flash_attention_backward(q, k, v, o, do,
                                                          lse, **kw)
                got, again = fn(), fn()
                errs = [float((x - w).abs().max()) / float(w.abs().max())
                        for x, w in zip(got, want)]
                err = max(errs)
                right = err <= cs.K5_BWD_TOL and all(
                    torch.equal(x, y) for x, y in zip(got, again))
                del got, again
            elif kern in ("k6bwd", "k7bwd"):
                import chip_smoke as cs

                bwd = (ops.mamba_scan_backward if kern == "k6bwd"
                       else ops.rwkv6_scan_backward)
                fn = lambda: bwd(*args)
                got, again = fn(), fn()
                errs = [float((x - w).abs().max()) / float(w.abs().max())
                        for x, w in zip(got, want)]
                err = max(errs)
                right = err <= cs.SCAN_TOL and all(
                    torch.equal(x, y) for x, y in zip(got, again))
                del got, again
            elif kern in ("k6", "k7"):
                import chip_smoke as cs

                scan = ops.mamba_scan if kern == "k6" else ops.rwkv6_scan
                fn = lambda: scan(*args)
                err, rel = cs.scan_error(torch, fn(), want)
                right = rel <= cs.SCAN_TOL
            else:
                q, k, v, kw = args
                fn = lambda: ops.flash_attention(q, k, v, **kw)
                got = fn()
                err = float((got - want).abs().max())
                right = err <= 2e-5
            line[tag] = {"ms": device_ms(torch, fn, n=10 if kern in (
                "k1", "k5bwd", "k6bwd", "k7bwd") else 20),
                         "matches_plain": right, "max_abs_err": err}
            if kern == "k5bwd":     # each gradient's error of its largest
                del line[tag]["max_abs_err"]
                line[tag]["rel_err_dq_dk_dv"] = errs
        print(json.dumps(line), flush=True)
    if train:
        print(json.dumps({"train_steps": train_ab(torch, libs)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
