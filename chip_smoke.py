#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. ``env``      — card, torch/CUDA versions, and the build of every kernel
                  from ``src/repro_torch/kernels/csrc`` (``nvcc``, sm_90a).
2. ``kernels``  — K1..K8 against their plain versions on the card at the
                  main paths' shapes (K1/K2 bitwise; K8 bitwise at every
                  superstep of 512 sources' fixpoint over the bbd-20k
                  in-neighbour table; K3 within tolerance, K4
                  bitwise against K3 per slice, in float32 and float64; the
                  mapped K3/K4 in place on ragged slices with absent rows
                  within tolerance of its plain version and bitwise dense
                  K3 per slice, both element modes, and over 2 systems in
                  one launch (padded system strides), each system bitwise
                  its own one-system launch; K5
                  at the standing prefill and decode shapes, at D = 128 and
                  at the serve paths' grouped shapes over caches whose
                  unused slots hold NaN, within 2e-5, and in bfloat16; K5
                  at gemma3-4b's D = 256: the windowed prefill at windows
                  1024, 1000, 40 and 2048 (the last bitwise the unwindowed
                  call), with an offset, the global prefill, ring, global
                  and windowed decodes, float32 and bfloat16, within 2e-5
                  of the plain version's float32 result beyond the
                  bfloat16 output's one rounding); K5 at whisper-tiny's
                  non-causal shapes (the encoder over 1500 positions, the
                  cross-attention of a 4-token prompt and of a decode
                  step) and internvl2-26b's group of 6 (prefill and
                  decode), within 2e-5); K5's backward at the train
                  paths' shapes (``K5_BWD_SHAPES``: smollm-135m's step,
                  the jamba period's attention layer, a gemma3-4b local
                  layer at D = 256 with window 1024,
                  internvl2-26b's group of 6, whisper-tiny's encoder and
                  its cross-attention), float32 and bfloat16: the forward
                  with the log-sum-exp bitwise the forward without it,
                  dq, dk, dv within 2e-5 of their largest (beyond
                  bfloat16's rounding) of the plain backward, dq of the
                  padded heads zero, two calls bitwise equal; K7's and
                  K6's backwards at the SSM train paths' shapes
                  (rwkv6-7b's 8 x 512, 64 heads of 64; the jamba period's
                  8 x 512, di = 16384, N = 16) from a zero and a non-zero
                  state with normal upstream gradients of the output and
                  of the final state: every gradient within 1e-4 of its
                  largest of the plain backward's, two calls bitwise
                  equal.
3. ``default``  — the main path at full size with default options:
                  ``bordered_block_diagonal(20_000, block=16, border=64,
                  seed=3)`` with ``LUOptions(concurrency=512)``: analyze
                  (no device argument: the card), factorize, refactorize,
                  solve with (n,) and (n, 4) right-hand sides.  The float64
                  sweep runs the mapped K3/K4 (float64) once per level with
                  trailing updates, checked per sweep; the factors' sha256
                  (``flat_sha256``) is printed for comparing commits.
4. ``kernel_path`` — the same matrix with ``backend="kernel",
                  numeric_backend="kernel"``: structure bitwise equal to
                  phase 3, factors within 1e-4, the mapped K3/K4 (float32)
                  once per level per sweep, every kernel seen by
                  ``torch.profiler`` (over analyze and the first
                  factorize) and by the launch counters; segment batching
                  bitwise on both numeric backends.
   ``bubble``   — bubble removal on the same matrix: analyze with
                  ``bubble=True`` on the default backends (K1 never runs)
                  and with ``backend="kernel"`` (K1 only on the one
                  full-width chunk): chunk widths, ``analyze_s``,
                  supersteps, K1/K2 launches, structure bitwise phase 3's.
   ``batched``  — the batched tier on phase 3's plan: ``factorize_batch``
                  of 2 value sets (``generic_values_csr`` seeds 0..1;
                  ``BATCH``, cut from 8 and 4), each
                  system's factors' sha256 equal to a sequential
                  ``factorize`` of it, the mapped K3/K4 once per level for
                  both (12 launches, as one sequential sweep), walls
                  against the 2 sequential ones; ``solve_batch`` on (2, n)
                  and (2, n, 4) bitwise the sequential solves (x, residual
                  history, accepted count), residuals <= 1e-10; systems 0
                  and 1 again on phase 4's plan (float32 updates); one
                  batched sweep of system 0 under ``torch.profiler``
                  (``PROFILED_SYSTEMS``); whether batched
                  cuBLAS products and triangular solves are bitwise per
                  slice at the sweep's shapes (reported, not required: the
                  tier makes one call per system); a zero pivot in system 3
                  of a small batch named as system 3 at the sequential
                  factorization's column.
   ``robust``   — the robust tier at n = 8,000 (``ROBUST_N``) on
                  ``shuffled_dominant(band=6, seed=2)`` and
                  ``indefinite(band=6, seed=1)`` with their values: the
                  plain options asserted to raise ``ZeroPivotError``
                  (panel, level, the robust tier's hint); then
                  ``pivot="static", perturb=True``: analyze (the pre-pass
                  span), factorize, refactorize, solves (residual <= 1e-8),
                  perturbed pivots, ``quality()`` (growth, condition,
                  verdict, seconds), and ``factorize_batch`` of (v, 1.25 v,
                  0.8 v), each system's sha256 its sequential one's.
   ``blocking`` — ``replan`` of phase 3's plan with ``blocking=True`` and
                  with ``autotune=True``: the merge pass's panels, merges,
                  padding and modeled gain, the tuned knobs, the blocked
                  paths' stage times beside phase 3's (residual <= 1e-10,
                  one mapped launch per level a sweep), a profiled blocked
                  refactorize (device calls, idle share; the default's is
                  ``breakdown_default``'s), and the blocked replan of phase
                  4's plan (float32 updates).
   ``serve_lu`` — ``SolverEngine(LUOptions(concurrency=512), capacity=2,
                  batch_slots=4)`` (``ENGINE_SLOTS``, cut from 8): a flush
                  of 4 requests on bbd-20k and 2 on a second bbd-20k
                  pattern (2 misses, 2 dispatches at occupancy 4/4 and
                  2/4), a flush of 3 on bbd-20k (a hit,
                  no analyze); one request per pattern bitwise the
                  sequential API, every residual <= 1e-10, the mapped
                  launches once per level per dispatch.
   ``distributed`` — Queue A item 10 on bbd-20k: ``torch.multiprocessing``
                  spawns a gloo world of 2 ranks (a ``FileStore``, both
                  ranks on ``cuda:0``), each running ``analyze`` with
                  ``distribute=True`` under the default and the kernel
                  options (per rank: ``analyze_s``, K1/K2 launches,
                  ``per_device_edge_checks``, ``balance_ratio``,
                  ``supersteps``, ``overlap_hidden_s``, ``merge_s``;
                  structure sha256 equal to phase 3's, a rank that raises
                  fails the run); the dynamic runtime on one slot through
                  ``analyze``, and the symbolic pass in turns: the static
                  loop against ``DynamicScheduler(devices=[cuda:0] * k)``
                  for k = 1 and 4 stream slots (chunks, steals, re-issues,
                  retired; counts, fingerprints and pattern bitwise);
                  ``plan.place(d)`` for d = 1, 2, 4 on phases 3 and 4's
                  plans, a refactorize at each after an unplaced one
                  (factors' sha256 and both solves
                  bitwise, 12 mapped launches a sweep) and the
                  ``placement.imbalance_modeled`` /
                  ``factor.level_imbalance_measured`` metrics at d = 2, 4.
5. ``breakdown_default`` / ``breakdown_kernel`` — analyze (both), and
                  refactorize and a (n, 4) solve (default options), once
                  more under ``torch.profiler``: wall time, device busy
                  time, idle share, device calls and the top kernels.
6. ``reference`` — a small matrix against dense numpy (L @ U = A, solve)
                  and against the port run on the CPU (bitwise structure).
7. ``serve``    — the LM serving path (``repro_torch.launch.serve``):
                  smollm-135m at full width, random parameters from seed 0,
                  8 requests of 512 prompt tokens and 32 greedy tokens on
                  the card, K5 in every layer's prefill and decode
                  attention; then one request (128 + 8 tokens) on the card
                  and on the CPU (plain attention) with the same
                  parameters: equal tokens, last logits within 1e-3.
8. ``breakdown_serve`` — the serve path's prefill and one decode step
                  under ``torch.profiler``: idle share and top kernels.
9. ``serve_rwkv6`` — the same serve run for rwkv6-7b whole (32 layers),
                  K7 in every layer's prefill and decode (1024 launches);
                  then, on its first 4 layers at full width, a 128-token
                  prompt and 8 teacher-forced decode steps on the card and
                  on the CPU (plain kernels) with the same parameters: every
                  step's logits within 1e-4 of the largest, the final
                  recurrent states too; greedy-token agreement reported.
10. ``breakdown_serve_rwkv6`` — phase 8 for rwkv6-7b.
11. ``serve_jamba`` — phase 9 for one 8-layer period of
                  jamba-1.5-large-398b at full width with each MoE FFN
                  replaced by the dense MLP of the same width (1 attention
                  + 7 mamba layers: K6 224 launches, K5 32 at D = 128); the
                  card-vs-CPU check on its first 2 layers (attention +
                  mamba).
12. ``breakdown_serve_jamba`` — phase 8 for the jamba period.
13. ``serve_gemma3`` — phase 9 for gemma3-4b whole (34 layers: 28 local
                  with a 1024-token window and ring caches, 6 global; D =
                  256) serving 8 requests of 1536 prompt tokens (past the
                  window) and 32 greedy tokens: K5 1088 launches, no other
                  kernel; the card-vs-CPU check on its first 6 layers (5
                  local, 1 global) with a 1016-token prompt and 16
                  teacher-forced steps, the rings wrapping at the 9th.
14. ``breakdown_serve_gemma3`` — phase 8 for gemma3-4b.
15. ``serve_whisper`` — phase 9 for whisper-tiny whole (4 encoder layers
                  over 1500 frame embeddings, 4 decoder layers with
                  cross-attention): 8 requests of 1500 frames and a
                  4-token prompt, 32 greedy tokens: K5 260 launches (4
                  encoder layers, then self- and cross-attention in each
                  decoder layer in the prefill and every decode step), no
                  other kernel; the card-vs-CPU check on the whole model,
                  one request's frames, a 4-token prompt and 16
                  teacher-forced steps.
16. ``breakdown_serve_whisper`` — phase 8 for whisper-tiny.
17. ``serve_internvl`` — phase 9 for internvl2-26b at full width cut to 12
                  of its 48 layers (``INTERNVL_LAYERS``; 24 until the SSM
                  train phases): 8 requests of 256 patch
                  embeddings and 512 tokens, 32 greedy tokens: K5 384
                  launches (48 query heads on 8 KV heads, D = 128); the
                  card-vs-CPU check on its first 2 layers with the same
                  patches, a 128-token prompt and 8 steps.
18. ``breakdown_serve_internvl`` — phase 8 for internvl2-26b.
19. ``serve_deepseek`` — the serve run for deepseek-v3-671b at full width
                  cut to one of its 61 (MLA, MoE) layers (13.36 G
                  parameters, 53.4 GB, drawn after gemma3's are freed): 8
                  requests of 512 + 32 tokens, no kernel of the port
                  launched (the reference computes MLA and MoE outside any
                  Pallas kernel), the MoE drop fractions of the prefill and
                  of decode (0: a decode row never overflows its 8 slots);
                  then the card-vs-CPU check by parts, the layer not being
                  copied to the host: (a) the MLA mixer over a 128-token
                  prompt and 8 teacher-forced steps, (b) the MoE FFN on
                  the serve prefill's inputs (router logits, routing equal
                  or differing only at near-ties, every 16th expert's
                  SwiGLU over the card's dispatch rows and the combine
                  recomputed on the CPU), each within 1e-4, and (c) the
                  whole layer's greedy tokens on the card.
20. ``breakdown_serve_deepseek`` — phase 8 for the deepseek layer.
21. ``train_smollm`` — the train path (``repro_torch.train.steps.
                  make_train_step``): smollm-135m whole at full width
                  (30 layers, seed-0 parameters drawn on the card),
                  float32, 8 x 1024 tokens from the synthetic pipeline,
                  5 AdamW steps of the default ``AdamWConfig``, micro_steps
                  1: per step loss, grad_norm, lr, ms, tokens/s and K5's
                  launches (exactly 60 forward and 30 backward: remat runs
                  each group's forward again in the backward pass; no other
                  kernel); ``train_peak_bytes`` (the steps' peak less what
                  the earlier phases held); one more step profiled
                  (idle share, device calls); the same parameters cut to
                  their first 2 layers on 2 x 256 tokens, card against CPU
                  (loss and grad_norm within 1e-5 relative, every gradient
                  leaf within 1e-4 of its largest, the parameters after
                  one step within 2.5 lr); 6 steps at lr 1e-3 without
                  warmup on one repeated batch must lower the loss.
22. ``train_whisper`` — the same for whisper-tiny whole, 8 x (1500 frames
                  + 64 tokens), 3 steps: K5 20 forward (4 encoder layers
                  once, the 4 decoder groups' self- and cross-attention
                  twice) and 12 backward a step; ``train_peak_bytes``;
                  card against CPU on the whole model's loss, grad_norm and
                  gradients of the first step's batch (every leaf within
                  3e-4 of its largest: see ``TRAIN_GRAD_TOL``).
23. ``train_rwkv6`` — Queue A item 12.10: rwkv6-7b at full width cut to 8
                  of its 32 layers (``RWKV6_TRAIN_CUT``), 8 x 512 tokens,
                  3 steps of the default ``AdamWConfig``: K7 16 forward
                  (each group's forward and its remat recompute) and 8
                  backward launches a step, no other kernel; per step
                  loss, grad_norm, ms, tokens/s; ``train_peak_bytes``;
                  one more step profiled; card vs CPU on its first 2
                  layers over 2 x 64 tokens (loss and grad_norm within
                  1e-5 relative, every gradient leaf within 1e-4 of its
                  largest); 2 steps at lr 2e-6 without warmup on one
                  repeated batch must lower the loss.
24. ``train_jamba`` — the same for the jamba period cut to its first two
                  layers (attention + MLP, mamba + MLP at d = 8192;
                  ``JAMBA_TRAIN_CUT``): K5 2 + 1 and K6 2 + 1 launches a
                  step (per-layer remat), card vs CPU on both layers.

Every serve line (phases 7, 9, 11, 13, 15, 17, 19) and train line (21–24)
carries ``dryrun``: ``repro_torch.launch.dryrun.run_cell`` of the same cut
config and shape, planned on ``meta`` tensors in DRYRUN_WORKERS spawned CPU
processes while the kernels build and are checked (``dryrun_plan``; the
``kernels`` line's ``dryrun_wait_s`` is how long the run then waited for
them, before any timed phase), against the row:
the launches equal (a train row's per step), and the predicted peak (plus the
row's other resident batches) within DRYRUN_PEAK_TOL of the measured one,
``max_memory_allocated`` less what the earlier phases held
(``serve_peak_bytes``, ``train_peak_bytes``).  ``serve_internvl``,
``train_rwkv6`` and ``train_jamba`` also carry ``dryrun_uncut``: the plan
of the model their cut leaves out (48, 32 and 3 layers) and whether it
fits this card.

Then a ``kernel_shapes`` line (the main paths' shapes the kernels are timed
at, K5's, K6's and K7's numbers at their decode shapes, K5's at the
serve paths' grouped shapes with SDPA's beside them, at gemma3's
windowed prefill, ring decode and global decode, and at whisper's and
internvl's prefill and decode shapes, an empty kernel's
device time, and dense K4 float64 against ``baddbmm`` in turns), one
``kernels`` line (each kernel's time beside its bound; K3/K4, dense and
mapped, once per element type, and the mapped one over 2 systems in
float64; K5's gemma3 windowed prefill, whisper encoder and internvl
prefill; K5's forward with the log-sum-exp at smollm's train shape and
its backward at each train shape, beside SDPA's forward and the backward
alone of SDPA; K6's and K7's backwards at the train phases' shapes, with
no library yardstick; ``ms`` and ``library_ms`` are the device
time alone, the
calls queued behind a spin kernel (``device_ms``); ``plain_ms`` is CUDA
events around calls of the plain version, a host-driven sequence of many
small launches whose time includes the host's gaps), the card's name and
power limit, and the final ``{"ok": true, ...}``.
The launch counters are reset just before each of phases 3, 4, 7, 9, 11,
13, 15, 17, 19, 21, 22, 23 and 24, each ``bubble`` analyze, the ``batched`` phase's batched sweeps, each
``robust`` and ``blocking`` path, each ``serve_lu`` flush and each
``distributed`` path (in each rank's own process for the sharded
analyze), and read
just after it, so each path reports its own launches (phase 3: K8, K2
and the float64 mapped K3/K4; phase 4: K1, K2 and the float32 mapped
K3/K4, no K8; ``bubble``: K2 and K8, and K1 on the kernel backend;
``batched``: the float64 mapped K3/K4 over 2 systems; ``robust``: K8, K2
and the float64 mapped K3/K4; ``blocking``: the mapped K3/K4 (no
fixpoint runs); ``serve_lu``: K8 and K2 on each miss and the mapped
K3/K4 over 4 systems; ``distributed``: K2 (and K8 on the default
options, K1 on the kernel options) on each rank and each dynamic run,
the mapped
K3/K4 on each placed sweep; phase 7: K5; phase 9: K7;
phase 11: K6 and K5; phases 13, 15 and 17: K5; phase 19: none;
phases 21 and 22: K5 and its backward; phase 23: K7 and its backward;
phase 24: K5, K6 and their backwards; the
dense K3/K4
entry points are off the paths since the sweep runs the mapped form),
split by stage in ``launches_by_stage``
for the LU paths; the ``kernels`` line takes each row's launches from the
path that runs it, K1's, K8's, K2's and the mapped K3/K4's rows add
``launches_on_new_paths``, and two rows time the mapped K3/K4 at the
blocked plans' widest level.  The comparison and timing launches of phase 2, the
breakdown and reference phases, the card-vs-CPU checks and the per-kernel
timings are not counted.  Each serve phase frees its parameters before the
next model is drawn.
"""
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
_T0 = time.perf_counter()        # each phase line carries its time since start
N_LARGE, BLOCK, BORDER, SEED, CONCURRENCY = 20_000, 16, 64, 3, 512
# H100 SXM published peaks (NVIDIA's data sheet, dense, at 700 W): HBM
# bandwidth, and the non-tensor-core float32 rate, applied to the int32
# min/compare ops of K1/K2 too (an optimistic rate, so the bound stays a
# lower bound)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# float64 outside the tensor cores (NVIDIA's H100 SXM data sheet: 34
# TFLOP/s), for the float64 instances of K3/K4 and the mapped update
PEAK_F64_OPS_S = 34e12
# TF32 on the tensor cores (NVIDIA's H100 SXM data sheet, dense): K5's
# prefill does each float32 product as 3 TF32 products (3xTF32)
PEAK_TF32_S = 495e12
# exponentials on the special function units: 16 results per clock per SM
# (CUDA C++ programming guide, throughput table, compute capability 9.0) x
# 132 SMs x 1.98 GHz, the clock at which 132 x 128 FMA lanes give the
# 67 TFLOP/s above; K6 computes one per (t, d, n)
PEAK_SFU_S = 132 * 16 * 1.98e9
# device_ms's spin: 1e8 cycles, >= 50 ms at the H100's <= 1.98 GHz clock
SPIN_CYCLES = 100_000_000
SERVE_ARCH, SERVE_REQUESTS, SERVE_PROMPT, SERVE_GEN = "smollm-135m", 8, 512, 32
# value sets of the batched phase (and systems of the mapped update's
# system-stride check): 2, cut from 8 (to 4) as the serve phases grew and
# to 2 as the train phases grew, to keep the smoke inside its time limit
# (the batched phase took 161 s of the 798 at 8, and 109 s of the 757 at
# 4, on an H100 80GB HBM3 at 700 W, most of it the sequential
# factorizations and solves it is compared with)
BATCH = 2
# the serving engine's dispatch slots (the serve_lu phase): 4, cut from 8
# to keep the smoke inside its time limit (its first flush, 8 + 2
# requests, took 57 s of the phase's 91 on an H100 80GB HBM3 at 700 W,
# most of it the host driving each system's sweep and solve)
ENGINE_SLOTS = 4
# systems of the batched phase's profiled sweep: the profiler's host-side
# processing costs about 0.2 ms an event on the card machine (H100 80GB
# HBM3, 700 W), and a sweep makes about 55,000 device calls a system, so
# a sweep of all 8 spent some 90 s of the smoke's time limit there, and
# one of 2 some 29 s
PROFILED_SYSTEMS = 1
# the robust phase's n, cut from the main path's 20,000: at 20,000 the
# indefinite generator's rescue ends at a relative residual near 7e-3
# after refinement (above the 1e-8 gate: element growth, not a port fault;
# at 8,000 the card and the CPU agree to 1e-10), and one analyze of these
# band generators takes 83-92 s on an H100 80GB HBM3 at 700 W (47-51 k
# supersteps); at 8,000 it takes 6-17 s there
ROBUST_N = 8_000
# the card-vs-CPU check of the SSM serve phases: a prompt, then teacher-
# forced decode steps, each step's logits gated at max |card - CPU| /
# max |CPU logit| (float32 sums in another order give ~1e-6; TF32 anywhere
# on the path would exceed it)
CHECK_PROMPT, CHECK_STEPS, CHECK_TOL = 128, 8, 1e-4
# gemma3-4b's serve run: prompts longer than its 1024-token window, so the
# windowed prefill cuts every local layer's keys and the local rings are
# full after the prefill and wrap at every decode step; its card-vs-CPU
# check: the first 6 layers (5 local, 1 global), a 1016-token prompt and
# 16 teacher-forced steps, so the rings wrap at the 9th step
GEMMA3_PROMPT = 1536
GEMMA3_CHECK_LAYERS, GEMMA3_CHECK_PROMPT, GEMMA3_CHECK_STEPS = 6, 1016, 16
# whisper-tiny's serve run: the whole model, 1500 frame embeddings a
# request and a 4-token prompt (the length of whisper's start-of-transcript
# sequence); its card-vs-CPU check: the whole model, one request's frames,
# the 4-token prompt and 16 teacher-forced steps
WHISPER_PROMPT, WHISPER_CHECK_STEPS = 4, 16
# internvl2-26b's serve run: full width cut to 12 of its 48 layers (all 48
# are 79.45 GB of float32 parameters, which leaves under 6 GB of the card),
# 256 patch embeddings and 512 tokens a request; cut from 24 layers (42.0
# GB) to keep the smoke inside its time limit as the train phases grow:
# the SSM train phases took 58 s, and the whole smoke 735 s of its 1200
# on an H100 80GB HBM3 at 700 W, where 24 layers took 10.5 s
INTERNVL_LAYERS = 12
INTERNVL_CUT = ("12 of 48 layers: 79.45 GB of float32 parameters whole "
                "(24 until the SSM train phases)")
# deepseek-v3-671b's serve run: the model at full width cut in depth to one
# layer (13.36 G parameters, 53.4 GB in float32 with its 45 GB of experts:
# two layers would need ~98 GB); its card-vs-CPU check by parts samples
# every 16th expert, and a routing pick that differs between the card and
# the CPU passes only where two of the token's k + 1 largest logits lie
# within 1e-5 of the largest logit (float32 sums in another order move a
# logit by ~1e-6)
DEEPSEEK_CUT = "1 of 61 layers; float32 experts ~45 GB a layer"
DEEPSEEK_EXPERT_STRIDE, DEEPSEEK_GAP_TOL = 16, 1e-5
SOURCES = {
    "minmax_relax": ("src/repro_torch/kernels/csrc/minmax_relax.cu",
                     "src/repro/kernels/gsofa_relax.py:60"),
    "ell_superstep": ("src/repro_torch/kernels/csrc/ell_superstep.cu",
                      "none"),
    "column_fingerprints": (
        "src/repro_torch/kernels/csrc/column_fingerprints.cu",
        "src/repro/kernels/supernode_fp.py:87"),
    "panel_update": ("src/repro_torch/kernels/csrc/panel_update.cu",
                     "src/repro/kernels/panel_update.py:53"),
    "panel_update_batched": ("src/repro_torch/kernels/csrc/panel_update.cu",
                             "src/repro/kernels/panel_update.py:86"),
    "panel_update_mapped": ("src/repro_torch/kernels/csrc/panel_update.cu",
                            "src/repro/kernels/panel_update.py:86"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:77"),
    "flash_attention_backward": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention.py:77"),
    "mamba_scan": ("src/repro_torch/kernels/csrc/mamba_scan.cu",
                   "src/repro/kernels/ssm_scan.py:71"),
    "rwkv6_scan": ("src/repro_torch/kernels/csrc/rwkv6_scan.cu",
                   "src/repro/kernels/ssm_scan.py:129"),
    "mamba_scan_backward": ("src/repro_torch/kernels/csrc/mamba_scan_bwd.cu",
                            "src/repro/kernels/ssm_scan.py:71"),
    "rwkv6_scan_backward": ("src/repro_torch/kernels/csrc/rwkv6_scan_bwd.cu",
                            "src/repro/kernels/ssm_scan.py:129"),
}
# the kernel path's kernels (K1, K2, the mapped K3/K4 in float32) and
# their profiler names
PROFILED_PATH = ("minmax_relax", "column_fingerprints",
                 "panel_update_mapped")
PROFILED = ("minmax_relax_kernel", "column_fingerprints_kernel",
            "panel_update_mapped_kernel<float")


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(torch, fn, *, inner: int = 1, reps: int = 5,
            warmup: int = 1) -> float:
    """Median device milliseconds of one ``fn()`` call, from CUDA events
    around ``inner`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_ms(torch, fn, *, n: int = 50, reps: int = 3) -> float:
    """Median device milliseconds of one ``fn()`` call with the host out of
    the way: a spin kernel (``torch.cuda._sleep``, ~50 ms) holds the stream
    while the host enqueues ``n`` calls, so the CUDA events around them time
    the calls back to back on the device.  ``cuda_ms`` instead includes the
    gaps where the device waits for the host's next launch, which dominate
    calls of a few microseconds.  Fails if the host took longer to enqueue
    the calls than the spin lasted."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        t0 = time.perf_counter()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        host_s = time.perf_counter() - t0
        check(host_s < SPIN_CYCLES / 2e9,
              f"enqueueing {n} calls took {host_s} s, longer than the spin")
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def bound(nbytes: float, ops: float, peak_ops: float = PEAK_OPS_S,
          sfu_ops: float = 0, alu_ops: float = 0):
    """(ms, what bounds it): the larger of the bytes over the memory rate
    and the operations over their peak rate, the ALU's and, for
    ``sfu_ops`` exponentials, the special function units'; ``alu_ops``
    float32 operations on the CUDA cores beside ``ops`` at ``peak_ops``
    (a kernel that does both kinds)."""
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = max(ops / peak_ops, sfu_ops / PEAK_SFU_S, alu_ops / PEAK_OPS_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def csr_of(a, values):
    import scipy.sparse as sp

    return sp.csr_matrix((values, a.indices.astype("int64"), a.indptr),
                         shape=(a.n, a.n))


def host_residual(a, values, x, b) -> float:
    """max over columns of ||b - A x|| / ||b||, in numpy on the host."""
    import numpy as np

    x = x.cpu().numpy()
    r = b - csr_of(a, values) @ x
    return float(np.max(np.linalg.norm(r, axis=0)
                        / np.linalg.norm(b, axis=0)))


def ell_superstep_check(torch, ops, plain, graph, srcs) -> int:
    """K8 against its plain version on the card from fresh labels of
    ``srcs`` over ``graph``'s in-neighbour table: next labels, edges, conv
    and flag bitwise at every superstep, the first and each later one,
    until the plain version finds no frontier.  Returns the supersteps."""
    from repro_torch.core.gsofa import init_labels

    s, dev = srcs.shape[0], srcs.device
    labels = init_labels(graph, srcs)
    kern = [labels.clone(), torch.full_like(labels, -7)]
    ref = [labels, torch.full_like(labels, 5)]
    counts = {side: [torch.zeros(k, dtype=torch.int32, device=dev)
                     for k in (s, s, 1)] for side in ("kernel", "plain")}
    it = 0
    while it < graph.n + 2:
        ops.ell_superstep(*kern, graph.in_ell, graph.out_deg, srcs,
                          *counts["kernel"], offset=0, it=it)
        plain.ell_superstep_plain(*ref, graph.in_ell, graph.out_deg, srcs,
                                  *counts["plain"], offset=0, it=it)
        check(torch.equal(kern[1], ref[1]),
              f"K8 labels differ from plain at superstep {it}")
        check(all(torch.equal(got, want) for got, want in zip(
            counts["kernel"], counts["plain"])),
            f"K8 edges, conv or flag differ from plain at superstep {it}")
        kern.reverse()
        ref.reverse()
        it += 1
        if int(counts["plain"][2]) != it:
            break
    check(it > 2, f"K8 check converged after {it} supersteps")
    return it


def kernel_checks(torch, ops, plain, graph):
    """Phase 2: every kernel against its plain version on the card."""
    import numpy as np

    dev = torch.device("cuda")
    adj_real = graph.adj_dense
    rng = np.random.default_rng(0)
    inf = plain.INF
    out = {}

    # K1 at S=512, U=V=4096 (random adjacency) and at the main path's
    # shape (the bbd-20k dense adjacency, U=V=20096)
    for tag, adj in (("4096", torch.as_tensor(
            (rng.random((4096, 4096)) < 0.01).astype(np.uint8), device=dev)),
            ("bbd", adj_real)):
        u = adj.shape[0]
        prop = rng.integers(-1, u + 2, size=(512, u)).astype(np.int32)
        prop[rng.random(prop.shape) < 0.3] = inf
        prop = torch.as_tensor(prop, device=dev)
        got = ops.minmax_relax(prop, adj)
        want = plain.minmax_relax_plain(prop, adj)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K1 ({tag}) differs from plain")
        out[f"K1_{tag}_bitwise"] = True

    # K8 at the default path's shape: S = 512 sources spread over the
    # bbd-20k in-neighbour table, every superstep of their fixpoint
    srcs = torch.as_tensor(np.sort(rng.choice(
        graph.n, CONCURRENCY, replace=False)).astype(np.int32), device=dev)
    out["K8_supersteps_bitwise"] = ell_superstep_check(torch, ops, plain,
                                                       graph, srcs)

    # K2 at S=512, V=20000, hashes spanning the whole int32 range
    s, v = 512, N_LARGE
    rel = torch.as_tensor(rng.integers(-1, v + 2, size=(s, v)).astype(
        np.int32), device=dev)
    src = torch.as_tensor(rng.integers(0, v, size=s).astype(np.int32),
                          device=dev)
    m1, m2 = (torch.as_tensor(rng.integers(0, 2 ** 32, size=s,
                                           dtype=np.uint64).astype(
        np.uint32).view(np.int32), device=dev) for _ in range(2))
    valid = torch.as_tensor((rng.random(s) < 0.9).astype(np.int32),
                            device=dev)
    got = ops.column_fingerprints(rel, src, m1, m2, valid)
    want = plain.column_fingerprints_plain(rel, src, m1, m2, valid)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "K2 differs from plain")
    out["K2_bitwise"] = True

    # K3 at a ragged and a 128-multiple shape; K4 bitwise vs K3 per slice
    for m, k, n in ((200, 96, 70), (256, 128, 128)):
        acc, lp, up = (torch.as_tensor(rng.standard_normal(sh).astype(
            np.float32), device=dev) for sh in ((m, n), (m, k), (k, n)))
        err, tol = k3_error(torch, ops, plain, acc, lp, up)
        check(err <= tol, f"K3 {m}x{k}x{n}: err {err} > tol {tol}")
        out[f"K3_{m}x{k}x{n}_err"] = err
        out[f"K3_{m}x{k}x{n}_tol"] = tol
        check(k4_bitwise(torch, ops, rng, 5, m, k, n), "K4 != K3 per slice")
    out["K4_bitwise_vs_K3"] = True

    # the float64 instances (the default sweep's): K4 bitwise K3 per slice,
    # K3 within float64 roundoff of the plain product
    for m, k, n in ((200, 96, 70), (8, 1, 1)):
        acc, lp, up = (torch.as_tensor(rng.standard_normal(sh), device=dev)
                       for sh in ((m, n), (m, k), (k, n)))
        err, tol = k3_error(torch, ops, plain, acc, lp, up)
        check(err <= tol, f"float64 K3 {m}x{k}x{n}: err {err} > tol {tol}")
        out[f"K3_f64_{m}x{k}x{n}_err"] = err
        check(k4_bitwise(torch, ops, rng, 5, m, k, n, dtype=torch.float64),
              "float64 K4 != K3 per slice")
    out["K4_f64_bitwise_vs_K3"] = True

    # the mapped K3/K4 in place on ragged slices with absent rows, both
    # element modes
    flat, u, lmap, tiles = mapped_inputs(torch, ops, rng, MAPPED_SHAPES)
    for f32 in (False, True):
        err, tol = mapped_check(torch, ops, plain, flat, u, lmap, tiles, f32)
        out[f"mapped_{'f32' if f32 else 'f64'}_err"] = err
        out[f"mapped_{'f32' if f32 else 'f64'}_tol"] = tol
    out["mapped_bitwise_vs_K3"] = True
    # the same records over BATCH systems in one launch (the batched
    # tier's form)
    for f32 in (False, True):
        err, tol = mapped_systems_check(torch, ops, plain, rng, flat, u,
                                        lmap, tiles, f32)
        out[f"mapped_{BATCH}_systems_{'f32' if f32 else 'f64'}_err"] = err
        out[f"mapped_{BATCH}_systems_{'f32' if f32 else 'f64'}_tol"] = tol
    out[f"mapped_{BATCH}_systems_bitwise_vs_one_system"] = True

    # K5 at the serve path's shapes and at D = 128, and in bfloat16
    for tag, shape in K5_SHAPES.items():
        q, k, v = attn_inputs(torch, rng, *shape)
        got = ops.flash_attention(q, k, v)
        want = plain.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(got.shape == want.shape and err <= K5_TOL,
              f"K5 {tag} {shape}: err {err} > {K5_TOL}")
        out[f"K5_{tag}_err"] = err
    for tag, shape in K5_GQA_SHAPES.items():
        q, k, v, kw = gqa_inputs(torch, rng, *shape)
        got = ops.flash_attention(q, k, v, **kw)
        want = plain.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(got.shape == want.shape and err <= K5_TOL
              and not bool(got[:, kw["live_heads"]:].any()),
              f"K5 {tag} {shape}: err {err} > {K5_TOL}, or a padded head "
              f"is not zero")
        out[f"K5_{tag}_err"] = err
    q, k, v = (x.to(torch.bfloat16) for x in attn_inputs(
        torch, rng, *K5_SHAPES["prefill"]))
    got = ops.flash_attention(q, k, v)
    err = float((got.float() - plain.flash_attention_plain(q, k, v).float()
                 ).abs().max())
    check(got.dtype == torch.bfloat16 and err <= 3e-2,
          f"K5 bfloat16: err {err} > 3e-2")
    out["K5_bf16_prefill_err"] = err
    out["K5_tol"] = K5_TOL

    # K5 at gemma3-4b's shapes (D = 256): the windowed prefill at several
    # window / tile alignments, the unwindowed (global) prefill, the ring
    # and global decodes over caches whose unused slots hold NaN, and a
    # windowed decode; float32 and bfloat16.  A window of at least kv_len
    # (here S) is the unwindowed call, bitwise.
    for tag, (shape, window) in K5_GEMMA3_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, kw = gqa_inputs(torch, rng, *shape, window=window,
                                     dtype=dtype)
            got = ops.flash_attention(q, k, v, **kw)
            err, excess = k5_error(torch, plain, got, q, k, v, kw)
            name = f"K5_gemma3_{tag}_{str(dtype)[6:]}"
            check(got.shape == q.shape and got.dtype == dtype
                  and excess <= K5_TOL
                  and not bool(got[:, kw["live_heads"]:].any()),
                  f"{name} {shape} window={window}: err {err}, excess over "
                  f"the output's rounding {excess} > {K5_TOL}, or a padded "
                  f"head is not zero")
            out[f"{name}_err"] = err
            if dtype == torch.bfloat16:
                out[f"{name}_excess"] = excess
            if window and window >= shape[6]:     # >= kv_len
                kw.pop("window")
                same = torch.equal(got, ops.flash_attention(q, k, v, **kw))
                check(same, f"{name}: window {window} >= kv_len differs "
                      f"from the unwindowed call")
                out[f"{name}_equals_unwindowed"] = same
    out["K5_bf16_rounding_step"] = BF16_U

    # K5 at whisper's non-causal and internvl's grouped serve shapes
    for tag, (shape, causal) in K5_SERVE_SHAPES.items():
        q, k, v, kw = gqa_inputs(torch, rng, *shape, causal=causal)
        got = ops.flash_attention(q, k, v, **kw)
        err = k5_error(torch, plain, got, q, k, v, kw)[0]
        check(got.shape == q.shape and bool(torch.isfinite(got).all())
              and err <= K5_TOL, f"K5 {tag} {shape} causal={causal}: err "
              f"{err} > {K5_TOL}")
        out[f"K5_{tag}_err"] = err

    # K7 and K6 at their serve paths' prefill and decode shapes, from a
    # zero and from a non-zero state, output and final state
    for name, shapes, inputs in (("K7", K7_SHAPES, rwkv6_inputs),
                                 ("K6", K6_SHAPES, mamba_inputs)):
        fn = ops.rwkv6_scan if name == "K7" else ops.mamba_scan
        ref = (plain.rwkv6_scan_plain if name == "K7"
               else plain.mamba_scan_plain)
        for tag, shape in shapes.items():
            for zero in (True, False):
                args = inputs(torch, rng, *shape, zero_state=zero)
                err, rel = scan_error(torch, fn(*args), ref(*args))
                check(rel <= SCAN_TOL, f"{name} {tag} {shape} zero={zero}: "
                      f"relative error {rel} > {SCAN_TOL}")
                out[f"{name}_{tag}_{'zero' if zero else 'state'}_err"] = err
    out["K6_K7_rel_tol"] = SCAN_TOL

    # K5's backward at the train paths' shapes
    out.update(k5_backward_checks(torch, ops, plain))
    # K7's and K6's backwards at the SSM train paths' shapes
    out.update(scan_backward_checks(torch, ops, plain))
    return out


# K5's shapes (B, H, S, T, D): the serve path's prefill and decode
# (smollm-135m: 8 requests, hp = 16 heads, hd = 64, 512 + 32 tokens; the
# last decode step attends over 543 + 1 cache slots), and a D = 128 prefill
# (qwen3's head size).  Tolerance: float32 sums over up to T keys, in
# another order than the plain version's cuBLAS products.
K5_SHAPES = {"prefill": (8, 16, 512, 512, 64), "decode": (8, 16, 1, 544, 64),
             "d128": (2, 16, 256, 256, 128)}
K5_TOL = 2e-5
# K5 as the serve paths call it (B, H, live heads, KV heads, S, cache slots,
# kv_len, D): smollm-135m's prefill and its last decode step (9 of 16 query
# heads live on 3 KV heads), and a decode step of the jamba period's
# attention layer (64 query heads on 8 KV heads, hd 128)
K5_GQA_SHAPES = {"smollm_prefill": (8, 16, 9, 3, 512, 512, 512, 64),
                 "smollm_decode": (8, 16, 9, 3, 1, 544, 544, 64),
                 "jamba_decode": (8, 64, 64, 8, 1, 544, 514, 128)}


# K5 at gemma3-4b's shapes ((B, H, live heads, KV heads, S, cache slots,
# kv_len, D), window): 8 requests of 1536 prompt tokens, 16 query heads (8
# live) on 4 KV heads, D = 256.  The serve path's windowed prefill (window
# 1024) and global prefill; windows of 1000 (not a multiple of the 32-key
# tile), 40 (below the 64-row query tile) and 2048 (>= S), and a window
# with queries the last 100 of 1540 keys, at 2 requests; decode over a
# full ring of 1024 slots and over a global cache (1540 of 1568 slots
# valid), and a windowed decode (S = 1: the last 1000 keys).
K5_GEMMA3_SHAPES = {
    "prefill_w1024": ((8, 16, 8, 4, 1536, 1536, 1536, 256), 1024),
    "prefill_global": ((8, 16, 8, 4, 1536, 1536, 1536, 256), None),
    "prefill_w1000": ((2, 16, 8, 4, 1536, 1536, 1536, 256), 1000),
    "prefill_w40": ((2, 16, 8, 4, 1536, 1536, 1536, 256), 40),
    "prefill_w2048": ((2, 16, 8, 4, 1536, 1536, 1536, 256), 2048),
    "prefill_offset_w1000": ((2, 16, 8, 4, 100, 1568, 1540, 256), 1000),
    "decode_ring": ((8, 16, 8, 4, 1, 1024, 1024, 256), None),
    "decode_global": ((8, 16, 8, 4, 1, 1568, 1540, 256), None),
    "decode_w1000": ((8, 16, 8, 4, 1, 1568, 1540, 256), 1000)}
# K5 at the encoder-decoder and VLM serve paths' shapes ((B, H, live heads,
# KV heads, S, cache slots, kv_len, D), causal): whisper-tiny (8 requests,
# 6 heads of 64 over its 1500 encoder positions: 23 key tiles and a ragged
# 24th) non-causal in the encoder, in the cross-attention of the 4-token
# prompt and of a decode step; internvl2-26b (48 query heads on 8 KV
# heads, a group of 6, D = 128) in the 768-position prefill (256 patches +
# 512 tokens) and a decode step over 790 of its 800 cache slots
K5_SERVE_SHAPES = {
    "whisper_encoder": ((8, 6, 6, 6, 1500, 1500, 1500, 64), False),
    "whisper_cross_prefill": ((8, 6, 6, 6, 4, 1500, 1500, 64), False),
    "whisper_cross_decode": ((8, 6, 6, 6, 1, 1500, 1500, 64), False),
    "internvl_prefill": ((8, 48, 48, 8, 768, 768, 768, 128), True),
    "internvl_decode": ((8, 48, 48, 8, 1, 800, 790, 128), True)}
# bfloat16's unit roundoff: K5 and the plain version agree within K5_TOL
# in float32, and K5 then rounds its output to bfloat16 once
BF16_U = 2.0 ** -8
# K5's backward (and its forward with the log-sum-exp) at the train paths'
# shapes ((B, H, live heads, KV heads, S, T, D), causal, window): smollm-
# 135m's train step (8 x 1024 tokens, 9 of 16 query heads live on 3 KV
# heads); a gemma3-4b local layer (D = 256, window 1024, 2 x 2048 tokens,
# 8 of 16 live on 4 KV heads); internvl2-26b's group of 6 (D = 128, 48 on
# 8 KV heads, 2 x 768); whisper-tiny's encoder (8 x 1500, non-causal) and
# its cross-attention (64 decoder tokens over 1500 encoder positions).
# Tolerance: dq, dk, dv within K5_BWD_TOL of the largest gradient of their
# kind (float32 sums over up to 2048 keys or queries, and over a group's
# heads, in another order than the plain version's cuBLAS products), in
# bfloat16 beyond the gradient's one rounding (BF16_U of the value)
K5_BWD_SHAPES = {
    "smollm_train": ((8, 16, 9, 3, 1024, 1024, 64), True, None),
    "jamba_train": ((8, 64, 64, 8, 512, 512, 128), True, None),
    "gemma3_local_train": ((2, 16, 8, 4, 2048, 2048, 256), True, 1024),
    "internvl_train": ((2, 48, 48, 8, 768, 768, 128), True, None),
    "whisper_encoder_train": ((8, 6, 6, 6, 1500, 1500, 64), False, None),
    "whisper_cross_train": ((8, 6, 6, 6, 64, 1500, 64), False, None)}
K5_BWD_TOL = 2e-5
# calls a backward timing queues behind device_ms's spin: a call of
# SDPA's backward through the autograd engine took 0.6-3.2 ms of host (50
# of them overran the ~50 ms spin) on an H100 80GB HBM3 at 700 W
BWD_DEVICE_N = 8


def k5_bwd_inputs(torch, b, h, live, hkv, s, t, d, *, causal, window,
                  dtype=None, seed=0):
    """q, dO (B, H, S, D), k, v (B, Hkv, T, D), standard normal from a
    generator on the card, and K5's keywords."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn((b, h, s, d), generator=g, device=dev)
             for _ in range(2))
    k, v = (torch.randn((b, hkv, t, d), generator=g, device=dev)
            for _ in range(2))
    q, k, v, do = (x.to(dtype or torch.float32) for x in (q, k, v, do))
    return q, k, v, do, {"causal": causal, "live_heads": live,
                         "window": window}


def k5_backward_checks(torch, ops, plain):
    """Phase 2's K5 backward checks, float32 and bfloat16 at each of
    K5_BWD_SHAPES: the forward with the log-sum-exp bitwise the forward
    without it, dq, dk, dv against the plain backward in float32 on the
    same inputs (K5_BWD_TOL of the largest, beyond bfloat16's rounding),
    dq of the padded heads exactly zero, two calls bitwise equal."""
    out = {}
    for tag, (shape, causal, window) in K5_BWD_SHAPES.items():
        live = shape[2]
        for dtype in (torch.float32, torch.bfloat16):
            name = f"K5_bwd_{tag}_{str(dtype)[6:]}"
            q, k, v, do, kw = k5_bwd_inputs(torch, *shape, causal=causal,
                                            window=window, dtype=dtype)
            out0 = ops.flash_attention(q, k, v, **kw)
            o, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
            torch.cuda.synchronize()
            check(torch.equal(o, out0), f"{name}: the forward with the "
                  f"log-sum-exp differs from the forward without it")
            got = ops.flash_attention_backward(q, k, v, o, do, lse, **kw)
            again = ops.flash_attention_backward(q, k, v, o, do, lse, **kw)
            want = plain.flash_attention_backward_plain(
                q.float(), k.float(), v.float(), o.float(), do.float(), lse,
                **kw)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{name}: two backward calls differ")
            step = BF16_U if dtype == torch.bfloat16 else 0.0
            errs = []
            for part, x, w in zip(("dq", "dk", "dv"), got, want):
                scale = float(w.abs().max())
                diff = (x.float() - w).abs()
                rel = float((diff - step * w.abs()).max()) / scale
                check(bool(torch.isfinite(x).all()) and rel <= K5_BWD_TOL,
                      f"{name} {shape}: {part} off by {rel} of its largest "
                      f"(> {K5_BWD_TOL})")
                errs.append(float(diff.max()) / scale)
            pad = float(got[0][:, live:].abs().max()) if live < shape[1] \
                else 0.0
            check(pad == 0.0, f"{name}: dq of a padded head is {pad}")
            out[name] = {"rel_err_dq_dk_dv": errs,
                         "max_abs_err": max(float((x.float() - w).abs().max())
                                            for x, w in zip(got, want)),
                         "bitwise_repeat": True,
                         "forward_lse_bitwise": True, "padded_dq_zero": True}
            del q, k, v, do, o, lse, got, again, want
    out["K5_bwd_rel_tol"] = K5_BWD_TOL
    return out


def k5_error(torch, plain, got, q, k, v, kw):
    """(max |K5 - plain|, its excess over the output's rounding): the
    plain version in float32 on the same inputs; the excess subtracts
    ``BF16_U * |plain|`` per element for a bfloat16 output (nothing for
    float32), so it is held to K5_TOL in both types."""
    want = plain.flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    diff = (got.float() - want).abs()
    step = BF16_U if got.dtype == torch.bfloat16 else 0.0
    return (float(diff.max()),
            float((diff - step * want.abs()).max()))


def attn_inputs(torch, rng, b, h, s, t, d):
    import numpy as np

    dev = torch.device("cuda")
    return tuple(torch.as_tensor(rng.standard_normal(sh).astype(np.float32),
                                 device=dev)
                 for sh in ((b, h, s, d), (b, h, t, d), (b, h, t, d)))


def gqa_inputs(torch, rng, b, h, live, hkv, s, t_alloc, kv_len, d, *,
               window=None, dtype=None, causal=True):
    """q (B, H, S, D) and k, v (B, Hkv, t_alloc, D) on the card (float32,
    or ``dtype``), the cache slots >= kv_len NaN (K5 must not read them),
    and K5's keywords."""
    import numpy as np

    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    kv = rng.standard_normal((2, b, hkv, t_alloc, d)).astype(np.float32)
    kv[:, :, :, kv_len:] = np.nan
    q, k, v = (torch.as_tensor(x, device="cuda").to(dtype or torch.float32)
               for x in (q, *kv))
    kw = {"causal": causal, "kv_len": kv_len, "live_heads": live}
    if window:
        kw["window"] = window
    return q, k, v, kw


# K7's shapes (B, L, H, K): rwkv6-7b's serve path (8 requests, 64 heads
# of 64; prefill 512, decode 1).  K6's (B, L, di, N): the jamba period's
# (8 requests, di = 2 x 8192, N = 16).  Tolerance: max |kernel - plain| over
# the output and the final state, relative to max(1, max |plain|): float32
# sums over K or N in another order, and the state grows with L.
K7_SHAPES = {"prefill": (8, 512, 64, 64), "decode": (8, 1, 64, 64)}
K6_SHAPES = {"prefill": (8, 512, 16384, 16), "decode": (8, 1, 16384, 16)}
SCAN_TOL = 1e-4


def _card_draws(torch, rng):
    """Standard normal and uniform draws on the card from a generator
    seeded by ``rng``: the scans' sequences at the main paths' shapes are
    67-268 M floats, seconds each through numpy on the host."""
    g = torch.Generator(device="cuda").manual_seed(int(rng.integers(2 ** 31)))

    def normal(*sh):
        return torch.randn(sh, generator=g, device="cuda")

    def uniform(lo, hi, *sh):
        return lo + (hi - lo) * torch.rand(sh, generator=g, device="cuda")

    return normal, uniform


def rwkv6_inputs(torch, rng, b, l, h, k, *, zero_state=True):
    """r, k, v (B, L, H, K) normal, w in (0.5, 0.999), u (H, K), state
    (B, H, K, K), on the card."""
    normal, uniform = _card_draws(torch, rng)
    state = (torch.zeros((b, h, k, k), device="cuda") if zero_state
             else normal(b, h, k, k))
    return (normal(b, l, h, k), normal(b, l, h, k), normal(b, l, h, k),
            uniform(0.5, 0.999, b, l, h, k), normal(h, k) * 0.3, state)


def mamba_inputs(torch, rng, b, l, di, n, *, zero_state=True):
    """x (B, L, di), dt ~ 0.05 |normal|, b_t, c_t (B, L, N), a < 0 (di, N),
    d (di,), h0 (B, di, N), on the card."""
    normal, _ = _card_draws(torch, rng)
    h0 = (torch.zeros((b, di, n), device="cuda") if zero_state
          else normal(b, di, n))
    return (normal(b, l, di), normal(b, l, di).abs() * 0.05,
            normal(b, l, n), normal(b, l, n), -(normal(di, n).abs() + 0.1),
            normal(di), h0)


def scan_bwd_inputs(torch, kind, shape, *, zero_state, seed):
    """A scan's inputs (``rwkv6_inputs`` or ``mamba_inputs``, ``kind``
    "rwkv6" or "mamba") and standard normal upstream gradients of its
    output and final state, all drawn on the card."""
    import numpy as np

    rng = np.random.default_rng(seed)
    inputs = rwkv6_inputs if kind == "rwkv6" else mamba_inputs
    args = inputs(torch, rng, *shape, zero_state=zero_state)
    normal, _ = _card_draws(torch, rng)
    return args + (normal(*args[0].shape), normal(*args[-1].shape))


def scan_backward_checks(torch, ops, plain):
    """Phase 2's K7 and K6 backward checks at their train paths' shapes
    (rwkv6-7b's and the jamba period's prefill shapes, 8 x 512), from a
    zero and a non-zero state, with non-zero upstream gradients of the
    output and of the final state: every gradient within SCAN_TOL of its
    largest entry of the plain backward's, finite, and two calls bitwise
    equal."""
    out = {}
    for key, kind, shape, fn, ref in (
            ("K7_bwd", "rwkv6", K7_SHAPES["prefill"],
             ops.rwkv6_scan_backward, plain.rwkv6_scan_backward_plain),
            ("K6_bwd", "mamba", K6_SHAPES["prefill"],
             ops.mamba_scan_backward, plain.mamba_scan_backward_plain)):
        worst = 0.0
        for zero in (True, False):
            name = f"{key}_{'zero' if zero else 'state'}"
            args = scan_bwd_inputs(torch, kind, shape, zero_state=zero,
                                   seed=int(zero))
            got = fn(*args)
            again = fn(*args)
            want = ref(*args)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{name} {shape}: two backward calls differ")
            rels = [float((g - w).abs().max()) / float(w.abs().max())
                    for g, w in zip(got, want)]
            check(all(bool(torch.isfinite(g).all()) for g in got)
                  and max(rels) <= SCAN_TOL, f"{name} {shape}: gradients "
                  f"off by {rels} of their largest (> {SCAN_TOL})")
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            out[name] = {"rel_err_per_gradient": rels, "max_abs_err": err,
                         "bitwise_repeat": True}
            worst = max(worst, err)
            del args, got, again, want
        out[f"{key}_max_abs_err"] = worst
    return out


def scan_error(torch, got, want):
    """(max abs error, max relative error) of a scan's (output, final
    state) against the plain version's, each relative to max(1, max
    |plain|)."""
    torch.cuda.synchronize()
    errs = [(float((g - w).abs().max()), max(1.0, float(w.abs().max())))
            for g, w in zip(got, want)]
    return max(e for e, _ in errs), max(e / sc for e, sc in errs)


def k3_error(torch, ops, plain, acc, lp, up):
    """(max |K3 - plain|, atol = eps * K * max|L| * max|U|), eps = 2e-6
    in float32 and 1e-14 in float64."""
    got = ops.panel_update(acc, lp, up)
    want = plain.panel_update_plain(acc, lp, up)
    torch.cuda.synchronize()
    eps = 1e-14 if acc.dtype == torch.float64 else 2e-6
    tol = eps * lp.shape[1] * float(lp.abs().max()) * float(up.abs().max())
    return float((got - want).abs().max()), tol


def k4_bitwise(torch, ops, rng, b, m, k, n, dtype=None) -> bool:
    dev = torch.device("cuda")
    acc, lp, up = (torch.as_tensor(rng.standard_normal(sh), device=dev,
                                   dtype=dtype or torch.float32)
                   for sh in ((b, m, n), (b, m, k), (b, k, n)))
    got = ops.panel_update_batched(acc, lp, up)
    return all(torch.equal(got[i], ops.panel_update(acc[i], lp[i], up[i]))
               for i in range(b))


# the mapped update's ragged slices (M, N, K): the sweep's commonest, a
# border panel's 48-deep chain, every tile kind and ragged edge
MAPPED_SHAPES = [(9, 1, 2), (14, 14, 48), (200, 3, 20), (5, 64, 7),
                 (33, 17, 512), (1, 1, 1), (130, 65, 16), (3, 5, 17)]


def mapped_inputs(torch, ops, rng, shapes, *, n_l=4096, absent=0.3):
    """A random float64 store on the card for the mapped update: (flat, u,
    lmap, tiles), slices of ``shapes`` (M, N, K) whose acc runs lie after
    the ``n_l`` L entries, a share ``absent`` of L entries structural
    zeros (-1)."""
    import numpy as np

    slices, lmaps, acc, moff, uoff = [], [], n_l, 0, 0
    for m, n, k in shapes:
        idx = rng.integers(0, n_l, m * k)
        idx[rng.random(m * k) < absent] = -1
        lmaps.append(idx)
        slices.append((acc, moff, uoff, m, n, k))
        acc, moff, uoff = acc + m * n, moff + m * k, uoff + k * n
    return tuple(torch.as_tensor(x, device="cuda") for x in (
        rng.standard_normal(acc), rng.standard_normal(uoff),
        np.concatenate(lmaps).astype(np.int32), ops.mapped_tiles(slices)))


def slice_records(tiles):
    """The tile records (host numpy) that stand for whole slices."""
    t = tiles.cpu().numpy()
    return t[(t[:, 6] == 0) & (t[:, 7] == 0)]


def mapped_check(torch, ops, plain, flat, u, lmap, tiles, f32):
    """The mapped K3/K4 once over ``tiles`` on a copy of ``flat`` against
    its plain version on another: (max abs error, tolerance eps * max K *
    max|flat| * max|u|, eps 2e-6 in float32 mode and 1e-14 in float64).
    Every slice must also be bitwise dense K3 on its gathered operands
    (float32 mode: on ``.float()`` operands, widened) and nothing else of
    ``flat`` may change; fails otherwise."""
    got, want = flat.clone(), flat.clone()
    ops.panel_update_mapped(got, u, lmap, tiles, f32=f32)
    plain.panel_update_mapped_plain(want, u, lmap, tiles, f32=f32)
    recs = slice_records(tiles)
    touched = torch.zeros(flat.shape, dtype=torch.bool, device=flat.device)
    for acc_off, map_off, u_off, m, n, k, *_ in recs.tolist():
        lm = lmap[map_off:map_off + m * k].view(m, k).long()
        lp = torch.where(lm >= 0, flat[lm.clamp(min=0)], 0.0)
        acc = flat[acc_off:acc_off + m * n].view(m, n)
        b = u[u_off:u_off + k * n].view(k, n)
        dense = (ops.panel_update(acc.float(), lp.float(), b.float()).double()
                 if f32 else ops.panel_update(acc, lp, b))
        mine = got[acc_off:acc_off + m * n].view(m, n)
        check(torch.equal(mine.view(torch.int64), dense.view(torch.int64)),
              f"mapped update (f32={f32}) of a {m}x{n}x{k} slice is not "
              f"bitwise dense K3")
        touched[acc_off:acc_off + m * n] = True
    check(torch.equal(got[~touched].view(torch.int64),
                      flat[~touched].view(torch.int64)),
          "the mapped update wrote outside its slices")
    torch.cuda.synchronize()
    eps = 2e-6 if f32 else 1e-14
    tol = (eps * int(recs[:, 5].max()) * float(flat.abs().max())
           * float(u.abs().max()))
    err = float((got - want).abs().max())
    check(err <= tol, f"mapped update (f32={f32}): err {err} > tol {tol}")
    return err, tol


def mapped_systems_check(torch, ops, plain, rng, flat, u, lmap, tiles, f32,
                         systems=None):
    """The mapped K3/K4 over ``systems`` (default ``BATCH``) stores in one
    launch: system 0 holds ``flat``/``u``, the others random values, each
    system's run padded by a few entries.  Every system must be bitwise
    the one-system launch on a copy of its own, nothing between systems
    may change, and the whole must lie within ``mapped_check``'s tolerance
    of the plain version; fails otherwise.  Returns (max abs error,
    tolerance)."""
    systems = systems or BATCH
    dev = flat.device
    n_f, n_u = flat.numel(), u.numel()
    fs, us = n_f + 5, n_u + 3
    big = torch.as_tensor(rng.standard_normal(systems * fs), device=dev)
    big.view(systems, fs)[0, :n_f] = flat
    ub = torch.as_tensor(rng.standard_normal(systems * us), device=dev)
    ub.view(systems, us)[0, :n_u] = u
    got, want = big.clone(), big.clone()
    kw = dict(f32=f32, systems=systems, flat_stride=fs, u_stride=us)
    ops.panel_update_mapped(got, ub, lmap, tiles, **kw)
    plain.panel_update_mapped_plain(want, ub, lmap, tiles, **kw)
    for sy in range(systems):
        one = big[sy * fs:sy * fs + n_f].clone()
        ops.panel_update_mapped(one, ub[sy * us:(sy + 1) * us].clone(),
                                lmap, tiles, f32=f32)
        check(torch.equal(got[sy * fs:sy * fs + n_f].view(torch.int64),
                          one.view(torch.int64)),
              f"mapped update over {systems} systems (f32={f32}): system "
              f"{sy} is not bitwise its one-system launch")
        gap = slice(sy * fs + n_f, (sy + 1) * fs)
        check(torch.equal(got[gap].view(torch.int64),
                          big[gap].view(torch.int64)),
              f"mapped update over {systems} systems wrote between systems")
    torch.cuda.synchronize()
    eps = 2e-6 if f32 else 1e-14
    tol = (eps * int(slice_records(tiles)[:, 5].max())
           * float(big.abs().max()) * float(ub.abs().max()))
    err = float((got - want).abs().max())
    check(err <= tol, f"mapped update over {systems} systems (f32={f32}): "
          f"err {err} > tol {tol}")
    return err, tol


def gemm_levels(plan) -> int:
    """Levels of the plan's sweep with at least one trailing update."""
    return sum(any(plan.gather_maps[j] is not None for j in level)
               for level in plan.schedule.levels)


def gemm_shapes(plan):
    """(level, panel, M, K, N) of every trailing GEMM of the plan's sweep."""
    st, sched = plan.store_template, plan.schedule
    out = []
    for li, level in enumerate(sched.levels):
        for j in level:
            maps = plan.gather_maps[j]
            if maps is None:
                continue
            s, e = sched.supernodes[j]
            out.append((li, int(j), len(st.rows[j]) - int(st.diag[j]),
                        len(maps.anc_rows), int(e - s)))
    return out


def run_path(torch, repro_torch, a, values, opts, *, device=None,
             profile_head=False, plan=None, analyze_kw=None, tol=1e-10,
             trace_analyze=False):
    """analyze -> factorize -> refactorize -> solve (n,) and (n, 4).  With
    ``profile_head`` the analyze and the first factorize, which launch every
    kernel of the path, run under torch.profiler; the kernels it saw come
    back as ``res["profiler"]``.  ``plan`` skips the analyze (a replanned
    plan; ``analyze_s`` is then None); ``analyze_kw`` goes to ``analyze``
    (the robust tier's ``values``); ``trace_analyze`` records the
    analyze's spans on ``plan.stats`` (the plan keeps ``opts``, untraced).
    Every residual, on the card and recomputed on the host, must be at
    most ``tol``."""
    import numpy as np
    from repro_torch.kernels import ops

    snaps = [ops.launch_counts()]      # read only: each stage's launches
    given = plan

    def head():
        t_an = None
        p = given
        if p is None:
            t0 = time.perf_counter()
            kw = dict(analyze_kw or {})
            if device is not None:
                kw["device"] = device
            p = repro_torch.analyze(
                a, opts.replace(trace=True) if trace_analyze else opts,
                **kw)
            torch.cuda.synchronize()
            t_an = time.perf_counter() - t0
            if trace_analyze:
                p = dataclasses.replace(p, options=opts)
        snaps.append(ops.launch_counts())
        t0 = time.perf_counter()
        factor = p.factorize(values)
        torch.cuda.synchronize()
        snaps.append(ops.launch_counts())
        return p, factor, t_an, time.perf_counter() - t0

    seen = None
    if profile_head:
        seen, (plan, factor, t_an, t_f) = profile_kernels(torch, head)
    else:
        plan, factor, t_an, t_f = head()
    ptr = factor.store.flat.data_ptr()
    digest = flat_sha256(factor.store.flat)
    t0 = time.perf_counter()
    factor = factor.refactorize(values)
    torch.cuda.synchronize()
    t_rf = time.perf_counter() - t0
    snaps.append(ops.launch_counts())
    check(factor.store.flat.data_ptr() == ptr,
          "refactorize did not reuse the device buffers")
    check(flat_sha256(factor.store.flat) == digest,
          "refactorize of the same values changed the factors' bits")
    rng = np.random.default_rng(42)
    b1 = rng.standard_normal(a.n)
    b4 = rng.standard_normal((a.n, 4))
    t0 = time.perf_counter()
    s1 = factor.solve(b1)
    s4 = factor.solve(b4)
    torch.cuda.synchronize()
    t_s = time.perf_counter() - t0
    snaps.append(ops.launch_counts())
    for s, b in ((s1, b1), (s4, b4)):
        check(tuple(s.x.shape) == b.shape and bool(torch.isfinite(s.x).all()),
              "solve returned a wrong shape or non-finite values")
        check(all(x >= y for x, y in zip(s.residuals, s.residuals[1:])),
              f"refinement history increased: {s.residuals}")
    res = {
        "analyze_s": t_an, "factorize_s": t_f, "refactorize_s": t_rf,
        "solve_s": t_s, "flat_sha256": digest, "lu_nnz": plan.lu_nnz,
        "n_supernodes": plan.n_supernodes, "n_levels": plan.n_levels,
        "supersteps": plan.sym.supersteps,
        "residual_n": s1.residual, "residual_n4": s4.residual,
        "host_residual_n": host_residual(a, values, s1.x[:, None],
                                         b1[:, None]),
        "host_residual_n4": host_residual(a, values, s4.x, b4),
        "launches_by_stage": {
            stage: {k: after[k] - before[k] for k in after}
            for stage, before, after in zip(
                ("analyze", "factorize", "refactorize", "solve"),
                snaps, snaps[1:])},
    }
    if seen is not None:
        res["profiler"] = seen
    check(all(res[k] <= tol for k in ("residual_n", "residual_n4",
                                      "host_residual_n", "host_residual_n4")),
          f"residual above {tol}: {res}")
    want = gemm_levels(plan)
    for stage in ("factorize", "refactorize"):
        got = res["launches_by_stage"][stage]["panel_update_mapped"]
        check(got == want, f"{stage}: the mapped update launched {got} "
              f"times, not once per level with trailing updates ({want})")
    return plan, factor, res


def flat_sha256(flat) -> str:
    """sha256 of a store's float64 values, as bytes on the host."""
    import hashlib

    return hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()


def structure_sha256(plan) -> dict:
    """sha256 of a plan's (or a ``SymbolicResult``'s) structure: per-row
    counts, supernodes, CSC pattern."""
    import hashlib

    import numpy as np

    def sha(x):
        return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()

    sym = getattr(plan, "sym", plan)
    return {"l_counts": sha(sym.l_counts),
            "u_counts": sha(sym.u_counts),
            "supernodes": sha(sym.supernodes),
            "indptr": sha(sym.pattern.indptr),
            "rowind": sha(sym.pattern.rowind)}


def bubble_phase(torch, repro_torch, ops, a, opts, plan):
    """Bubble removal on the main matrix: ``analyze`` with ``bubble=True``
    on the default backends and with ``backend="kernel"``, each with the
    launch counters reset just before and read just after; its structure
    must equal ``plan``'s bitwise; K1 must not run on the default
    backends (every chunk relaxes by ELL, through K8) and must run with
    the kernel backend (on the full-width chunk), where K8 runs the
    narrowed chunks."""
    from repro_torch.core.multisource import plan_chunks

    chunks = plan_chunks(a.n, opts.concurrency, bubble=True)
    want = structure_sha256(plan)
    out = {"n_chunks": len(chunks),
           "narrow_chunks": sum(ch.width < a.n for ch in chunks),
           "sum_widths": sum(ch.width for ch in chunks),
           "n_chunks_x_n": len(chunks) * a.n,
           "structure_sha256": want}
    for tag, o in (("default", opts.replace(bubble=True)),
                   ("kernel", opts.replace(bubble=True, backend="kernel"))):
        ops.reset_launches()
        t0 = time.perf_counter()
        p = repro_torch.analyze(a, o)
        torch.cuda.synchronize()
        t_an = time.perf_counter() - t0
        counts = ops.launch_counts()
        check(structure_sha256(p) == want,
              f"bubble ({tag}): structure differs from the default plan's")
        k1, k2 = counts["minmax_relax"], counts["column_fingerprints"]
        k8 = counts["ell_superstep"]
        check(k2 > 0, f"bubble ({tag}): K2 was not launched")
        check(k1 == 0 if tag == "default" else k1 > 0,
              f"bubble ({tag}): K1 launched {k1} times")
        check(k8 > 0 if tag == "default" or out["narrow_chunks"] else k8 == 0,
              f"bubble ({tag}): K8 launched {k8} times")
        out[tag] = {"analyze_s": t_an, "supersteps": p.sym.supersteps,
                    "reinits": p.sym.reinits,
                    "launches": {"minmax_relax": k1, "ell_superstep": k8,
                                 "column_fingerprints": k2}}
    return out


def batched_library_probe(torch, rng):
    """Whether cuBLAS's batched product and batched triangular solve are
    bitwise their per-matrix calls at phase A's shapes on the card (the
    batched tier does not rely on it: it makes one call per system)."""
    dev = torch.device("cuda")
    out = {}
    for m, k, w in ((30, 16, 16), (14, 2, 1), (64, 16, 16), (500, 16, 16)):
        x = torch.as_tensor(rng.standard_normal((BATCH, m, k)), device=dev)
        y = torch.as_tensor(rng.standard_normal((BATCH, k, w)), device=dev)
        both = x @ y
        out[f"bmm_{m}x{k}x{w}"] = all(torch.equal(both[i], x[i] @ y[i])
                                      for i in range(BATCH))
    for w in (2, 16):
        t = torch.as_tensor(rng.standard_normal((BATCH, w, w)), device=dev)
        t = t + w * torch.eye(w, dtype=t.dtype, device=dev)
        rhs = torch.as_tensor(rng.standard_normal((BATCH, w, 16)),
                              device=dev)
        both = torch.linalg.solve_triangular(t, rhs, upper=False,
                                             unitriangular=True)
        out[f"trsm_{w}x16"] = all(torch.equal(
            both[i], torch.linalg.solve_triangular(
                t[i], rhs[i], upper=False, unitriangular=True))
            for i in range(BATCH))
    return out


def batched_phase(torch, repro_torch, ops, a, plan, plan_k,
                  generic_values_csr):
    """The batched tier on the main plan: ``factorize_batch`` of BATCH
    value sets against BATCH sequential ``factorize`` calls (factors'
    sha256, walls), the mapped K3/K4 once per level for all systems (the
    counters reset just before the batched sweep and read just after),
    ``solve_batch`` on (B, n) and (B, n, 4) against the sequential
    solves, bitwise; systems 0 and BATCH - 1 again on the kernel plan; one
    batched sweep under torch.profiler."""
    import numpy as np

    vals = [generic_values_csr(a, seed=s) for s in range(BATCH)]
    vb = np.stack(vals)
    rng = np.random.default_rng(5)
    rhs = {"n": rng.standard_normal((BATCH, a.n)),
           "n4": rng.standard_normal((BATCH, a.n, 4))}
    out = {"batch": BATCH,
           "store_bytes": plan.store_template.total_entries * 8 * BATCH}

    def sequential(p, systems):
        """{system: (factors' sha256, {rhs tag: SolveResult})}, the
        factorize walls and the solves' walls."""
        res, walls, solve_walls = {}, [], []
        for s in systems:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f = p.factorize(vals[s])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            solves = {tag: f.solve(b[s]) for tag, b in rhs.items()}
            torch.cuda.synchronize()
            solve_walls.append(time.perf_counter() - t0)
            res[s] = (flat_sha256(f.store.flat), solves)
            again = f.solve(rhs["n"][s])
            check(torch.equal(again.x, res[s][1]["n"].x),
                  f"the sequential solve of system {s} does not repeat "
                  f"bitwise")
        return res, walls, solve_walls

    def batched(p, systems):
        """The batched sweep of ``systems`` and its solves; checks every
        system against ``sequential``; returns its numbers."""
        vbs = vb[list(systems)]
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bf = p.factorize_batch(vbs)
        torch.cuda.synchronize()
        t_b = time.perf_counter() - t0
        counts = ops.launch_counts()
        want = gemm_levels(p)
        check(counts["panel_update_mapped"] == want,
              f"the batched sweep launched the mapped update "
              f"{counts['panel_update_mapped']} times, not once per level "
              f"({want})")
        t0 = time.perf_counter()
        solved = {tag: bf.solve_batch(b[list(systems)])
                  for tag, b in rhs.items()}
        torch.cuda.synchronize()
        t_s = time.perf_counter() - t0
        seq, walls, solve_walls = sequential(p, systems)
        for i, s in enumerate(systems):
            digest, seq_solves = seq[s]
            check(flat_sha256(bf.store.flat[i]) == digest,
                  f"batched factors of system {s} differ from sequential")
            for tag, r in solved.items():
                sq = seq_solves[tag]
                check(torch.equal(r.x[i], sq.x)
                      and r.residuals[i] == sq.residuals
                      and int(r.refine_accepted[i]) == sq.refine_accepted,
                      f"solve_batch {tag} of system {s} differs from the "
                      f"sequential solve")
                check(r.residuals[i][-1] <= 1e-10,
                      f"system {s} {tag}: residual {r.residuals[i][-1]}")
        return {"systems": list(systems), "factorize_batch_s": t_b,
                "sequential_factorize_s": walls,
                "sequential_factorize_sum_s": sum(walls),
                "solve_batch_s": t_s,
                "sequential_solve_sum_s": sum(solve_walls),
                "mapped_launches": counts["panel_update_mapped"],
                "launches": counts,
                "residual_max": {tag: float(r.residual.max())
                                 for tag, r in solved.items()},
                "refine_accepted": {tag: r.refine_accepted.tolist()
                                    for tag, r in solved.items()},
                "factors_bitwise": True, "solves_bitwise": True}

    out["default"] = batched(plan, range(BATCH))
    counts = out["default"]["launches"]
    out["kernel"] = batched(plan_k, (0, BATCH - 1))
    out["library_bitwise_per_slice"] = batched_library_probe(torch, rng)
    _, out["profiled_factorize_batch"] = profiled(
        torch, lambda: plan.factorize_batch(vb[:PROFILED_SYSTEMS]))
    out["profiled_factorize_batch"]["systems"] = PROFILED_SYSTEMS
    return out, counts


def profiled(torch, fn, *, cross_check=False):
    """``fn()`` once under torch.profiler: (its result, {wall_ms,
    device_busy_ms, idle_share, device_calls, top, profiler_host_s}), the
    last the seconds the profiler's stop and summary took on the host.
    ``cross_check`` also holds the summary's per-name calls and device
    time against ``key_averages()`` (slow on large profiles)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        wall = (t1 - t0) * 1e3
    summary = device_summary(prof, wall)
    summary["profiler_host_s"] = time.perf_counter() - t1
    if cross_check:
        diff = key_averages_diff(prof)
        check(not diff, "the raw device events disagree with "
              f"key_averages(): {diff[:8]}")
        summary["device_events_match_key_averages"] = True
    return result, summary


def key_averages_diff(prof) -> list:
    """Where a finished profile's raw device events (``device_events``)
    and ``key_averages()`` disagree, per name: [name, raw calls, calls,
    raw us, us]; an empty list when they agree.  ``key_averages()`` keeps
    whole microseconds: < 1 us an event apart."""
    from torch.autograd import DeviceType

    calls, us = Counter(), Counter()
    for name, dur in device_events(prof):
        calls[name] += 1
        us[name] += dur
    if not calls:
        return [["no device events", 0, 0, 0.0, 0.0]]
    avg = {ev.key: ev for ev in prof.key_averages()
           if ev.device_type == DeviceType.CUDA
           and not getattr(ev, "is_user_annotation", False)}
    diff = []
    for k in sorted(set(avg) | set(calls)):
        n, t = (avg[k].count, avg[k].device_time_total) if k in avg else (
            0, 0.0)
        if n != calls[k] or abs(t - us[k]) > calls[k] + 1e-6 * us[k]:
            diff.append([k[:120], calls[k], n, us[k], t])
    return diff


def robust_phase(torch, repro_torch, ops, matrices, generic_values_csr):
    """The robust tier at n = ``ROBUST_N`` on the two hostile generators of
    the reference's tests (a row-shuffled dominant matrix and an indefinite one
    with zero diagonals): the plain options must raise ZeroPivotError
    naming panel and level; ``pivot="static", perturb=True`` with the
    matrix's values then runs the path (analyze with its pre-pass span,
    factorize, refactorize, solves, residual <= 1e-8), the quality report,
    and ``factorize_batch`` of (v, 1.25 v, 0.8 v), each system bitwise its
    sequential factorization.  Launch counters reset just before each
    robust path and read just after."""
    import dataclasses as dc

    import numpy as np

    out = {"n": ROBUST_N}
    totals = Counter()
    for name, a, vals in (
            ("shuffled", *(lambda a: (a, matrices.shuffled_dominant_values_csr(
                a, band=6, seed=2)))(matrices.shuffled_dominant(
                    ROBUST_N, band=6, seed=2))),
            ("indefinite", *(lambda a: (a, matrices.indefinite_values_csr(
                a, seed=1)))(matrices.indefinite(ROBUST_N, band=6, seed=1)))):
        plain_opts = repro_torch.LUOptions(concurrency=CONCURRENCY,
                                           supernode_relax=2)
        t0 = time.perf_counter()
        try:
            repro_torch.analyze(a, plain_opts).factorize(vals)
        except repro_torch.ZeroPivotError as e:
            plain = {"k": e.k, "panel": e.panel, "level": e.level,
                     "message": str(e), "s": time.perf_counter() - t0}
        else:
            fail(f"robust ({name}): the plain options factored without a "
                 f"ZeroPivotError")
        check(plain["panel"] is not None and plain["level"] is not None
              and "pivot='static', perturb=True" in plain["message"],
              f"robust ({name}): the zero pivot is not attributed: {plain}")
        opts = plain_opts.replace(pivot="static", perturb=True)
        ops.reset_launches()
        plan, factor, res = run_path(
            torch, repro_torch, a, vals, opts, analyze_kw={"values": vals},
            tol=1e-8, trace_analyze=True)
        launches = ops.launch_counts()
        totals.update(launches)
        prepass = plan.stats.find("robust_prepass")
        for kernel in ("column_fingerprints", "panel_update_mapped"):
            check(launches[kernel] > 0,
                  f"robust ({name}): {kernel} was not launched")
        t0 = time.perf_counter()
        q = factor.quality()
        torch.cuda.synchronize()
        t_q = time.perf_counter() - t0
        check(q.verdict in ("ok", "suspect"),
              f"robust ({name}): quality verdict {q}")
        vb = np.stack([vals, 1.25 * vals, 0.8 * vals])
        t0 = time.perf_counter()
        bf = plan.factorize_batch(vb)
        torch.cuda.synchronize()
        t_b = time.perf_counter() - t0
        seq = [res["flat_sha256"]] + [flat_sha256(plan.factorize(v).store.flat)
                                      for v in vb[1:]]
        check(all(flat_sha256(bf.store.flat[i]) == seq[i] for i in range(3)),
              f"robust ({name}): a batched system differs from its "
              f"sequential factorization")
        out[name] = {
            "plain_zero_pivot": plain,
            "prepass_s": prepass.total_s if prepass is not None else None,
            **res, "perturbed_pivots": factor.perturbed_pivots,
            "quality": {**dc.asdict(q), "seconds": t_q},
            "factorize_batch_s": t_b,
            "batch_perturbed_pivots": bf.perturbed_pivots.tolist(),
            "batch_bitwise_sequential": True, "launches": launches}
    return out, dict(totals)


def level_operands(torch, plan, factor, rng, *, widest=False):
    """The mapped K3/K4's operands at one level of ``plan``'s sweep, on the
    factored store of ``factor`` with random U rows: the level with the
    most slices, or with ``widest`` the one with the widest slice (N, then
    K).  Returns (flat copy, u, lmap, tiles, work) with ``work`` the
    level's numbers and the bound's counts: the L entries the map hits, U,
    acc read and written, 2 flops per hit per column."""
    from repro_torch.kernels import work as W
    from repro_torch.kernels.ops import resolve_device

    dev = resolve_device(plan.device)
    upd = plan._device_state(dev)[2]
    bounds = [int(x) for x in upd.level_tiles]
    recs_by_level = [slice_records(upd.tiles[lo:hi]) if hi > lo else None
                     for lo, hi in zip(bounds, bounds[1:])]
    if widest:
        key = [(int(r[:, 4].max()), int(r[:, 5].max()))
               if r is not None else (0, 0) for r in recs_by_level]
    else:
        key = [len(r) if r is not None else 0 for r in recs_by_level]
    lvl = max(range(len(key)), key=key.__getitem__)
    tiles = upd.tiles[bounds[lvl]:bounds[lvl + 1]]
    recs = recs_by_level[lvl]
    lmap_h = upd.lmap.cpu().numpy()
    hits = [int((lmap_h[mo:mo + m * k] >= 0).sum())
            for _, mo, _, m, _, k, *_ in recs.tolist()]
    outs = int((recs[:, 3] * recs[:, 4]).sum())
    u_len = int((recs[:, 5] * recs[:, 4]).sum())
    u = torch.as_tensor(rng.standard_normal(u_len), device=dev)
    work = {"level": lvl, "slices": len(recs), "tiles": int(tiles.shape[0]),
            "outputs": outs, "l_hits": sum(hits), "u_entries": u_len,
            "max_n": int(recs[:, 4].max()), "max_k": int(recs[:, 5].max()),
            "slices_per_level": [len(r) if r is not None else 0
                                 for r in recs_by_level],
            **dict(zip(("bytes", "flops"), W.panel_update_mapped_work(
                hits, recs[:, 4], outs, u_len)))}
    return factor.store.flat.clone(), u, upd.lmap, tiles, work


def blocking_phase(torch, repro_torch, ops, plan, values, res, plan_k,
                   res_k):
    """Structure-aware blocking and the roofline autotune on phase 3's
    plan, by ``replan`` (no fixpoint re-run): the merge pass's numbers, the
    blocked and the autotuned path (factorize, refactorize, solves,
    residual <= 1e-10, one mapped launch per level a sweep; counters reset
    just before each and read just after) beside phase 3's in this call,
    a profiled blocked refactorize (the default one is
    ``breakdown_default``'s), and the blocked replan of phase 4's plan
    (float32 updates).  Returns the phase
    line and the blocked plans and factors (the kernel rows time the
    mapped K3/K4 at their widest level)."""
    import numpy as np
    from repro_torch.supernodes.blocking import merge_supernodes
    from repro_torch.tune import cost_model_for

    opts = plan.options
    model = cost_model_for(opts)
    merged, stats = merge_supernodes(plan.pattern, plan.sym.supernodes,
                                     model, max_width=opts.block_max_width)
    a = plan.a
    out = {"default": {k: res[k] for k in (
        "factorize_s", "refactorize_s", "solve_s", "n_supernodes",
        "n_levels")},
        "merge": {"panels_before": stats.n_before,
                  "panels_after": stats.n_after, "merges": stats.merges,
                  "pad_entries_before": stats.pad_entries_before,
                  "pad_entries_after": stats.pad_entries_after,
                  "modeled_before_s": stats.modeled_before_s,
                  "modeled_after_s": stats.modeled_after_s,
                  "modeled_gain_s": stats.modeled_gain_s}}
    blocked = {}
    for tag, knobs in (("blocked", {"blocking": True}),
                       ("autotuned", {"autotune": True})):
        t0 = time.perf_counter()
        p = repro_torch.replan(plan, opts.replace(**knobs))
        t_re = time.perf_counter() - t0
        if tag == "blocked":
            check(np.array_equal(p.schedule.supernodes, merged),
                  "replan(blocking=True) differs from the merge pass")
        ops.reset_launches()
        p, f, r = run_path(torch, repro_torch, a, values, p.options,
                           plan=p)
        r["launches"] = ops.launch_counts()
        r.update(replan_s=t_re,
                 store_pad_entries=p.store_template.pad_entries,
                 max_panel_width=int(np.diff(p.schedule.supernodes).max()))
        if p.tuned is not None:
            r["tuned"] = {"chosen": p.tuned.chosen,
                          "modeled_s": p.tuned.modeled_s,
                          "baseline_s": p.tuned.baseline_s,
                          "n_panels": p.tuned.n_panels,
                          "candidates": len(p.tuned.candidates)}
        blocked[tag] = (p, f)
        out[tag] = r
    out["default"]["store_pad_entries"] = plan.store_template.pad_entries
    # the default plan's profiled refactorize is breakdown_default's
    fb = blocked["blocked"][1]
    _, out["profiled_refactorize_blocked"] = profiled(
        torch, lambda: fb.refactorize(values))
    kopts = plan_k.options
    t0 = time.perf_counter()
    pk = repro_torch.replan(plan_k, kopts.replace(blocking=True))
    t_re = time.perf_counter() - t0
    ops.reset_launches()
    pk, fk, rk = run_path(torch, repro_torch, a, values, pk.options, plan=pk)
    rk["launches"] = ops.launch_counts()
    rk["replan_s"] = t_re
    rk["kernel_path"] = {k: res_k[k] for k in (
        "factorize_s", "refactorize_s", "solve_s", "n_supernodes")}
    out["kernel_blocked"] = rk
    return out, blocked["blocked"], (pk, fk)


def serve_lu_phase(torch, repro_torch, ops, sparse, plan, generic_values_csr):
    """The sparse-LU serving engine: ``SolverEngine(LUOptions(concurrency=
    512), capacity=2, batch_slots=ENGINE_SLOTS)``.  First flush:
    ENGINE_SLOTS requests on bbd-20k (values ``generic_values_csr`` seeds
    0, 1, ...) and 2 on another bbd-20k pattern (seed 4): 2 misses, 2
    dispatches, one full and one at 2 of ENGINE_SLOTS.  Second flush: 3
    requests on bbd-20k, a cache hit with no
    analyze.  One request per pattern bitwise the sequential API
    (``plan.factorize(v).solve(b)``), every residual <= 1e-10; launch
    counters reset just before each flush and read just after."""
    import numpy as np
    from repro_torch.serve import SolverEngine, pattern_fingerprint

    a0 = plan.a
    a4 = sparse.bordered_block_diagonal(N_LARGE, block=BLOCK, border=BORDER,
                                        seed=4)
    eng = SolverEngine(repro_torch.LUOptions(concurrency=CONCURRENCY),
                       capacity=2, batch_slots=ENGINE_SLOTS)
    rng = np.random.default_rng(9)
    reqs = {}

    def submit(a, seed):
        vals = generic_values_csr(a, seed=seed)
        b = rng.standard_normal(a.n)
        rid = eng.submit(a, vals, b)
        reqs[rid] = (a, vals, b)
        return rid

    out = {}
    for tag, stream in (("flush_1", [(a0, s) for s in range(ENGINE_SLOTS)]
                         + [(a4, 0), (a4, 1)]),
                        ("flush_2", [(a0, s) for s in (10, 11, 12)])):
        before = dict(eng.stats)
        rids = [submit(a, s) for a, s in stream]
        ops.reset_launches()
        t0 = time.perf_counter()
        results = eng.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        check([r.rid for r in results] == rids,
              f"serve_lu {tag}: results out of submission order")
        for r in results:
            a, vals, b = reqs[r.rid]
            check(r.residual <= 1e-10
                  and host_residual(a, vals, r.x[:, None], b[:, None])
                  <= 1e-10, f"serve_lu {tag}: request {r.rid} residual "
                  f"{r.residual}")
        delta = {k: eng.stats[k] - before[k] for k in eng.stats}
        plans = {id(eng.cache.get(pattern_fingerprint(a))):
                 eng.cache.get(pattern_fingerprint(a)) for a, _ in stream}
        want = sum(gemm_levels(p) for p in plans.values())
        check(launches["panel_update_mapped"] == want,
              f"serve_lu {tag}: the mapped update launched "
              f"{launches['panel_update_mapped']} times, not once per level "
              f"per dispatch ({want})")
        out[tag] = {"requests": len(stream), "wall_s": wall, "stats": delta,
                    "launches": launches,
                    "mapped_launches_per_dispatch": [
                        gemm_levels(p) for p in plans.values()],
                    "slots": [r.slot for r in results],
                    "batch_ids": [r.batch_id for r in results],
                    "cache_hit": [r.cache_hit for r in results],
                    "residual_max": max(r.residual for r in results)}
        out[tag]["results"] = results
    s1, s2 = out["flush_1"]["stats"], out["flush_2"]["stats"]
    check(s1["cache_misses"] == 2 and s1["batches"] == 2
          and s1["padded_slots"] == ENGINE_SLOTS - 2,
          f"serve_lu flush_1: {s1}")
    check(s2["cache_hits"] == 1 and s2["cache_misses"] == 0
          and s2["analyze_s"] == 0.0 and s2["batches"] == 1
          and out["flush_2"]["launches"]["column_fingerprints"] == 0,
          f"serve_lu flush_2 was not a cache hit without analyze: {s2}")
    # one request per pattern against the sequential API, bitwise
    bitwise = {}
    for tag, a, plan_a in (("bbd_seed3", a0, plan),
                           ("bbd_seed4", a4,
                            eng.cache.get(pattern_fingerprint(a4)))):
        r = next(r for r in out["flush_1"]["results"]
                 if reqs[r.rid][0] is a)
        _, vals, b = reqs[r.rid]
        t0 = time.perf_counter()
        seq = plan_a.factorize(vals).solve(b)
        torch.cuda.synchronize()
        check(torch.equal(r.x, seq.x) and r.residual == seq.residuals[-1],
              f"serve_lu: request {r.rid} ({tag}) differs from the "
              f"sequential API")
        bitwise[tag] = {"rid": r.rid, "sequential_s":
                        time.perf_counter() - t0}
    for tag in ("flush_1", "flush_2"):
        del out[tag]["results"]
    out["bitwise_sequential"] = bitwise
    out["stats"] = dict(eng.stats)
    return out


def distributed_rank(rank, world, want):
    """One rank of the ``distributed`` phase's gloo world (spawned by
    ``tests/_torch_world.run_world``; rank r on ``cuda:(r % cards)``,
    so both ranks share the one card): ``analyze`` of bbd-20k with
    ``distribute=True`` under the default and the kernel options, the
    launch counters reset just before and read just after each; rank 0
    holds the structure against the single-device plan's."""
    import torch

    import repro_torch
    from repro_torch import sparse
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_flat_mesh

    a = sparse.bordered_block_diagonal(N_LARGE, block=BLOCK, border=BORDER,
                                       seed=SEED)
    mesh = make_flat_mesh()
    out = {"rank": rank, "device": str(mesh.device)}
    opts = repro_torch.LUOptions(concurrency=CONCURRENCY, distribute=True)
    for tag, o in (("default", opts),
                   ("kernel", opts.replace(backend="kernel",
                                           numeric_backend="kernel"))):
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = repro_torch.analyze(a, o)
        torch.cuda.synchronize()
        t_an = time.perf_counter() - t0
        counts = ops.launch_counts()
        sha = structure_sha256(plan)
        if rank == 0:
            check(sha == want, f"distributed ({tag}): rank 0's structure "
                  f"differs from the single-device plan's")
        dist = plan.sym.dist
        out[tag] = {
            "analyze_s": t_an,
            "launches": {k: counts[k] for k in (
                "minmax_relax", "ell_superstep", "column_fingerprints")},
            "per_device_edge_checks": dist["per_device_edge_checks"].tolist(),
            "balance_ratio": dist["balance_ratio"],
            "supersteps": plan.sym.supersteps,
            "overlap_hidden_s": dist["overlap_hidden_s"],
            "merge_s": dist["merge_s"], "n_devices": plan.n_devices,
            "structure_sha256": sha}
    return out


def imbalance_metrics(torch, plan, factor, values, d) -> dict:
    """``placement.imbalance_modeled`` and
    ``factor.level_imbalance_measured`` of ``plan.place(d)`` and one
    refactorize under tracing (registry reset before, read after)."""
    from repro_torch.obs import metrics as om
    from repro_torch.obs import trace as ot

    ot.disable()
    om.registry().reset()
    ot.enable()
    try:
        plan.place(d)
        factor.refactorize(values)
        torch.cuda.synchronize()
        out = {}
        for name in ("placement.imbalance_modeled",
                     "factor.level_imbalance_measured"):
            h = om.registry().get(name)
            out[name] = ({"levels": h.count, "mean": h.mean, "max": h.max}
                         if h is not None else None)
    finally:
        ot.disable()
        om.registry().reset()
    return out


def distributed_phase(torch, repro_torch, ops, a, values, opts, plan,
                      factor, res, plan_k, factor_k, res_k):
    """Queue A item 10 on bbd-20k: the sharded analyze in a gloo world of
    2 ranks on the card (``distributed_rank``); the dynamic runtime on one
    slot through ``analyze``, then the symbolic pass alone: the static loop
    against ``DynamicScheduler(devices=[cuda:0] * slots)`` for 1 and 4
    stream slots in turns, default and kernel backends, counts,
    fingerprints and pattern bitwise the static plan's;
    ``plan.place(d)`` for d in 1, 2, 4 on the default and the kernel
    plans: in-place refactorizes after one unplaced one, factors' sha256
    bitwise the unplaced plan's at every d, the (n,) and (n, 4) solves at
    d = 2 and 4 (default) and 4 (kernel), the mapped K3/K4 still once per
    level, and the two imbalance metrics at d = 2 and 4.  Launch counters
    are reset just before each path and read just after."""
    import tempfile

    import numpy as np
    from _torch_world import run_world
    from repro_torch.core.gsofa import prepare_graph
    from repro_torch.core.spaceopt import auto_concurrency
    from repro_torch.core.symbolic import PatternCollector, symbolic_factorize
    from repro_torch.runtime.scheduler import DynamicScheduler
    from repro_torch.supernodes import ColumnFingerprints

    want = structure_sha256(plan)
    out = {}
    (ROOT / "build").mkdir(exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as workdir:
        ranks = run_world(2, distributed_rank, want, workdir=workdir)
    out["sharded"] = {"world": 2, "wall_s": time.perf_counter() - t0,
                      "single_device_analyze_s": {
                          "default": res["analyze_s"],
                          "kernel": res_k["analyze_s"]},
                      "ranks": ranks}
    for r in ranks:
        for tag in ("default", "kernel"):
            rec = r[tag]
            check(rec["structure_sha256"] == want,
                  f"distributed ({tag}): rank {r['rank']}'s structure "
                  f"differs from the single-device plan's")
            check(rec["launches"]["column_fingerprints"] > 0,
                  f"distributed ({tag}): K2 was not launched on rank "
                  f"{r['rank']}")
            check((rec["launches"]["minmax_relax"] > 0) == (tag == "kernel"),
                  f"distributed ({tag}): K1 launched "
                  f"{rec['launches']['minmax_relax']} times on rank "
                  f"{r['rank']}")
            check((rec["launches"]["ell_superstep"] > 0) == (tag == "default"),
                  f"distributed ({tag}): K8 launched "
                  f"{rec['launches']['ell_superstep']} times on rank "
                  f"{r['rank']}")

    dev = torch.device("cuda", 0)
    dyn = {"static_analyze_s": {"default": res["analyze_s"],
                                "kernel": res_k["analyze_s"]}}
    ops.reset_launches()
    t0 = time.perf_counter()
    p = repro_torch.analyze(a, opts.replace(runtime="dynamic"))
    torch.cuda.synchronize()
    dyn["analyze_1_slot"] = {"analyze_s": time.perf_counter() - t0,
                             **p.sym.runtime,
                             "launches": ops.launch_counts()}
    check(structure_sha256(p) == want,
          "dynamic (1 slot): structure differs from the static plan's")
    check(dyn["analyze_1_slot"]["launches"]["ell_superstep"] > 0,
          "dynamic (1 slot): K8 was not launched")
    # the symbolic pass alone: the static loop against a DynamicScheduler
    # on 1 and 4 stream slots on cuda:0, in turns (default backend), the
    # static loop and 4 slots (kernel backend); each scheduler run's counts,
    # fingerprints and pattern are held against the static plan's
    for tag, backend, p_static, turns in (
            ("default", "ell", plan, ("static", 1, 4, 4, 1, "static")),
            ("kernel", "kernel", plan_k, ("static", 4))):
        graph = prepare_graph(
            a, dense_block=128 if backend == "kernel" else None, device=dev)
        eff_c = auto_concurrency(graph, None, CONCURRENCY, backend)
        times = {}
        for slots in turns:
            ops.reset_launches()
            t0 = time.perf_counter()
            if slots == "static":
                sym = symbolic_factorize(
                    a, concurrency=CONCURRENCY, backend=backend, graph=graph,
                    detect_supernodes=True, collect_pattern=True)
            else:
                fp = ColumnFingerprints(n=a.n)
                collector = PatternCollector(n=a.n)
                run = DynamicScheduler(
                    graph, devices=[dev] * slots, concurrency=eff_c,
                    backend=backend, on_chunk=fp.update,
                    on_mask=collector.update).run()
            torch.cuda.synchronize()
            times.setdefault(str(slots), []).append(time.perf_counter() - t0)
            counts = ops.launch_counts()
            if slots == "static":
                check(structure_sha256(sym) == want,
                      f"symbolic ({tag}, static): structure differs from "
                      f"the static plan's")
                continue
            want_fp = p_static.sym.fingerprints
            pattern = collector.to_csc()
            check(run["completed"] == run["chunks"],
                  f"dynamic ({slots} slots, {tag}): chunks left undone")
            check(np.array_equal(run["l_counts"], p_static.sym.l_counts)
                  and np.array_equal(run["u_counts"], p_static.sym.u_counts)
                  and all(np.array_equal(getattr(fp, k), getattr(want_fp, k))
                          for k in ("counts", "hsum", "hxor", "subdiag",
                                    "seen"))
                  and np.array_equal(pattern.indptr, p_static.pattern.indptr)
                  and np.array_equal(pattern.rowind, p_static.pattern.rowind),
                  f"dynamic ({slots} slots, {tag}): counts, fingerprints or "
                  f"pattern differ from the static plan's")
            check((counts["ell_superstep"] > 0) == (tag == "default"),
                  f"dynamic ({slots} slots, {tag}): K8 launched "
                  f"{counts['ell_superstep']} times")
            if slots == 4:
                dyn[f"symbolic_4_slots_{tag}"] = {
                    "n_devices": slots, **{k: run[k] for k in (
                        "chunks", "completed", "steals", "reissues",
                        "retired")},
                    "launches": {k: counts[k] for k in (
                        "minmax_relax", "ell_superstep",
                        "column_fingerprints")}}
        dyn[f"symbolic_s_{tag}"] = times
    out["dynamic"] = dyn

    rng = np.random.default_rng(42)
    b1 = rng.standard_normal(a.n)
    b4 = rng.standard_normal((a.n, 4))
    placed = {}
    # turns with the unplaced plan; solves checked where the segments
    # differ from the unplaced order (d = 1 is the unplaced code path)
    for tag, p, f, turns, solve_at in (
            ("default", plan, factor, (None, 2, 4, 1), ("2", "4")),
            ("kernel", plan_k, factor_k, (None, 4, 2, 1), ("4",))):
        digest = flat_sha256(f.store.flat)
        x1, x4 = f.solve(b1).x, f.solve(b4).x
        want_mapped = gemm_levels(p)
        rows = {"refactorize_s": {}, "flat_sha256": digest}
        for d in turns:
            key = "unplaced" if d is None else str(d)
            if d is None:
                p.placement = None
            else:
                p.place(d)
            ops.reset_launches()
            t0 = time.perf_counter()
            f = f.refactorize(values)
            torch.cuda.synchronize()
            rows["refactorize_s"].setdefault(key, []).append(
                time.perf_counter() - t0)
            mapped = ops.launch_counts()["panel_update_mapped"]
            check(flat_sha256(f.store.flat) == digest,
                  f"placed ({tag}, d={d}): factors differ from the "
                  f"unplaced plan's")
            check(mapped == want_mapped,
                  f"placed ({tag}, d={d}): {mapped} mapped launches, not "
                  f"{want_mapped}")
            rows.setdefault(key, {"mapped_launches": mapped})
            if key not in solve_at or "solve_s" in rows[key]:
                continue
            t0 = time.perf_counter()
            s1, s4 = f.solve(b1), f.solve(b4)
            torch.cuda.synchronize()
            check(torch.equal(s1.x, x1) and torch.equal(s4.x, x4),
                  f"placed ({tag}, d={d}): solves differ from the "
                  f"unplaced plan's")
            rows[key]["solve_s"] = time.perf_counter() - t0
        if tag == "default":
            rows["imbalance"] = {str(d): imbalance_metrics(
                torch, p, f, values, d) for d in (2, 4)}
        p.placement = None
        placed[tag] = rows
    out["placed"] = placed
    return out


def zero_pivot_check(torch, repro_torch, sparse, generic_values_csr):
    """System 3 of a batch of 4 made singular (row n // 2 zero): the
    batched sweep must name system 3 and the column the sequential
    factorization of that system names."""
    import numpy as np

    a = sparse.bordered_block_diagonal(600, block=16, border=16, seed=1)
    plan = repro_torch.analyze(a, repro_torch.LUOptions(concurrency=128))
    vb = np.stack([generic_values_csr(a, seed=s) for s in range(4)])
    col = a.n // 2
    vb[3, a.indptr[col]:a.indptr[col + 1]] = 0.0
    found = []
    for run in (lambda: plan.factorize_batch(vb),
                lambda: plan.factorize(vb[3])):
        try:
            run()
        except repro_torch.ZeroPivotError as e:
            found.append({"k": e.k, "system": e.system, "panel": e.panel,
                          "level": e.level, "message": str(e)})
        else:
            fail("a singular system factored without a ZeroPivotError")
    got, seq = found
    check(got["system"] == 3 and got["k"] == seq["k"] == col
          and (got["panel"], got["level"]) == (seq["panel"], seq["level"]),
          f"zero pivot: batched {got}, sequential {seq}")
    return {"batched": got, "sequential": seq}


def reference_check(torch, repro_torch, sparse, generic_values_csr):
    """Phase 5: a small system against dense numpy and the CPU port."""
    import numpy as np

    a = sparse.bordered_block_diagonal(600, block=16, border=16, seed=1)
    values = generic_values_csr(a)
    dense = csr_of(a, values).toarray()
    out = {}
    plans = {}
    for dev in ("cuda", "cpu"):
        opts = repro_torch.LUOptions(concurrency=128, backend="kernel",
                                     numeric_backend="numpy")
        plan = repro_torch.analyze(a, opts, device=dev)
        factor = plan.factorize(values)
        plans[dev] = (plan, factor)
    (pg, fg), (pc, fc) = plans["cuda"], plans["cpu"]
    check(np.array_equal(pg.sym.l_counts, pc.sym.l_counts)
          and np.array_equal(pg.sym.u_counts, pc.sym.u_counts)
          and np.array_equal(pg.sym.supernodes, pc.sym.supernodes)
          and np.array_equal(pg.pattern.rowind, pc.pattern.rowind),
          "card and CPU symbolic results differ")
    lu = fg.l @ fg.u
    out["lu_rel_err"] = float(np.abs(lu - dense).max() / np.abs(dense).max())
    check(out["lu_rel_err"] <= 1e-12, f"L@U != A: {out['lu_rel_err']}")
    out["card_vs_cpu_factor_rel"] = float(
        (fg.store.flat.cpu() - fc.store.flat).abs().max()
        / fc.store.flat.abs().max())
    check(out["card_vs_cpu_factor_rel"] <= 1e-12, "card vs CPU factors")
    b = np.random.default_rng(3).standard_normal(a.n)
    x = fg.solve(b).x.cpu().numpy()
    xr = np.linalg.solve(dense, b)
    out["solve_rel_err"] = float(np.abs(x - xr).max() / np.abs(xr).max())
    check(out["solve_rel_err"] <= 1e-10, f"solve vs numpy {out}")
    return out


def device_events(prof):
    """A finished profile's device-side events (kernels, copies, fills) as
    (name, microseconds), read from the profiler's raw results: building
    its Python event tree for ``key_averages()`` costs the host some 0.1
    ms an event, and one sweep of bbd-20k makes some 10^5 of them.  The
    events ``key_averages()`` leaves out (hidden ones) are left out here
    too."""
    from torch.autograd import DeviceType

    for ev in prof.profiler.kineto_results.events():
        if (ev.device_type() == DeviceType.CUDA
                and not ev.is_user_annotation()
                and not getattr(ev, "is_hidden_event", lambda: False)()):
            yield ev.name(), ev.duration_ns() / 1e3


def profile_kernels(torch, fn):
    """Run ``fn`` under torch.profiler; return ({kernel name: (calls,
    device ms)}, fn's result)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        result = fn()
        torch.cuda.synchronize()
    seen = {}
    for key, us in device_events(prof):
        for name in PROFILED:
            if name in key:
                calls, ms = seen.get(name, (0, 0.0))
                seen[name] = (calls + 1, ms + us / 1e3)
    return seen, result


def device_summary(prof, wall_ms: float, k: int = 5) -> dict:
    """A profile's device side, from one pass over its events: busy
    milliseconds of every kernel, copy and fill (one stream, so they never
    overlap), the idle share of ``wall_ms``, the device calls, and the
    ``k`` names with the most time as [name, calls, ms]."""
    calls, us = Counter(), Counter()
    for name, dur in device_events(prof):
        calls[name] += 1
        us[name] += dur
    busy = sum(us.values()) / 1e3
    top = sorted(us, key=us.get, reverse=True)[:k]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms,
            "device_calls": sum(calls.values()),
            "top": [[name[:80], calls[name], us[name] / 1e3]
                    for name in top]}


def breakdown(torch, repro_torch, a, values, opts, *, sweep: bool):
    """Stages of the main path once more, each under torch.profiler: its
    wall time (profiler on), the device's busy time, the idle share and the
    kernels that took the most device time.  ``analyze`` always; with
    ``sweep`` also ``refactorize`` (the panel sweep of every factorization)
    and a (n, 4) solve.  Profiling costs time per launch, and the sweep
    launches some 10^5 kernels, so the callers pick the stages."""
    import numpy as np

    b4 = np.random.default_rng(7).standard_normal((a.n, 4))
    out = {}

    def stage(name, fn):
        result, out[name] = profiled(torch, fn)
        return result

    plan = stage("analyze", lambda: repro_torch.analyze(a, opts))
    if sweep:
        factor = plan.factorize(values)
        stage("refactorize", lambda: factor.refactorize(values))
        stage("solve_n4", lambda: factor.solve(b4))
    return out


def greedy(torch, tf, fp32_highest, cfg, params, prompt, gen_len):
    """Prefill ``prompt`` and decode ``gen_len`` greedy tokens on the
    parameters' device; returns (tokens (B, gen_len), the last step's
    float32 logits), both on the host."""
    with torch.inference_mode(), fp32_highest():
        h, caches, _ = tf.forward(params, cfg, prompt, mode="prefill",
                                  cache_len=prompt.shape[1] + gen_len)
        logits = tf.logits_last(params, cfg, h)
        toks = [logits.argmax(-1)]
        for _ in range(gen_len - 1):
            h, caches, _ = tf.forward(params, cfg, toks[-1][:, None],
                                      mode="decode", caches=caches)
            logits = tf.logits_last(params, cfg, h)
            toks.append(logits.argmax(-1))
    return torch.stack(toks, dim=1).cpu(), logits.cpu()


def serve_run(torch, ops, cfg, *, prompt_len=SERVE_PROMPT):
    """The serve path at full width on the card: draw the parameters, warm
    up, then serve SERVE_REQUESTS x (prompt_len + SERVE_GEN) with the
    launch counters set to 0 just before.  Returns the parameters and the
    phase line's common keys."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf

    held = torch.cuda.memory_allocated()     # the earlier phases' tensors
    t0 = time.perf_counter()
    params = tf.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    # warm-up (cuBLAS handles, the kernel library's first load): not counted
    serve.serve(cfg, requests=1, prompt_len=64, gen_len=2, params=params)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    res = serve.serve(cfg, requests=SERVE_REQUESTS, prompt_len=prompt_len,
                      gen_len=SERVE_GEN, params=params)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    toks = res["tokens"]
    check(toks.shape == (SERVE_REQUESTS, SERVE_GEN) and toks.min() >= 0
          and toks.max() < cfg.vocab, f"serve tokens {toks.shape}")
    b, p, g = SERVE_REQUESTS, prompt_len, SERVE_GEN
    moe_keys = ({k: res[k] for k in ("moe_drop_frac_prefill",
                                     "moe_drop_frac_decode")}
                if cfg.moe else {})
    return params, {
        "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "heads": [cfg.n_heads, cfg.hp, cfg.n_kv_heads], "hd": cfg.hd,
        "vocab": cfg.vocab, "n_params": tf.n_params(params),
        "requests": b, "prompt_len": p, "gen_len": g,
        "init_params_s": t_init,
        "prefill_ms": res["prefill_s"] * 1e3,
        "prefill_tok_s": b * p / res["prefill_s"],
        "decode_ms": res["decode_s"] * 1e3,
        # the decode loop makes gen - 1 tokens per request (the first comes
        # from the prefill)
        "decode_tok_s": b * (g - 1) / res["decode_s"],
        "decode_ms_per_step": res["decode_s"] * 1e3 / (g - 1),
        "max_memory_allocated": peak,
        # the serve run's own peak: parameters, caches and activations
        "serve_peak_bytes": peak - held, "launches": launches,
        **moe_keys, "sample_tokens": toks[0].tolist()}


def serve_phase(torch, ops):
    """Phase 7: the serve path at full width on the card, then one request
    on the card and on the CPU with the same parameters."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.plain import fp32_highest
    from repro_torch.models import transformer as tf

    cfg = get_config(SERVE_ARCH)
    params, line = serve_run(torch, ops, cfg)
    launches = line["launches"]
    want = cfg.n_layers * SERVE_GEN        # prefill + (gen - 1) decode steps
    check(launches["flash_attention"] == want,
          f"K5 launched {launches['flash_attention']} times, not {want}")

    prompt = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, 128)))
    card_toks, card_logits = greedy(torch, tf, fp32_highest, cfg, params,
                                    prompt.cuda(), 8)
    host = tf.to_device(params, "cpu")
    t0 = time.perf_counter()
    host_toks, host_logits = greedy(torch, tf, fp32_highest, cfg, host,
                                    prompt, 8)
    t_host = time.perf_counter() - t0
    logits_rel = float((card_logits - host_logits).abs().max()
                       / host_logits.abs().max())
    check(torch.equal(card_toks, host_toks),
          f"card tokens {card_toks.tolist()} != CPU {host_toks.tolist()}")
    check(logits_rel <= 1e-3, f"card vs CPU last logits: {logits_rel}")
    return params, {
        **line, "check_tokens": card_toks[0].tolist(),
        "check_tokens_equal": True, "check_logits_rel": logits_rel,
        "check_cpu_s": t_host}


def teacher_forced(torch, tf, fp32_highest, cfg, params, prompt, forced,
                   inputs):
    """Prefill ``prompt`` (1, P) with ``inputs`` (the model's frames or
    patches, {} for neither), then decode the tokens of ``forced`` (1, T)
    one at a time, whatever the model predicts.  Returns every step's
    float32 logits (T + 1, V) and the final recurrent states {(group,
    layer, leaf): tensor}, all on the host."""
    dev = params["embed"]["table"].device
    with torch.inference_mode(), fp32_highest():
        h, caches, _ = tf.forward(
            params, cfg, prompt.to(dev), mode="prefill",
            cache_len=cfg.n_patches + prompt.shape[1] + forced.shape[1],
            **{k: x.to(dev) for k, x in inputs.items()})
        logits = [tf.logits_last(params, cfg, h)]
        for t in range(forced.shape[1]):
            h, caches, _ = tf.forward(params, cfg, forced[:, t:t + 1].to(dev),
                                      mode="decode", caches=caches)
            logits.append(tf.logits_last(params, cfg, h))
    states = {(g, name, key): leaf.cpu()
              for g, cg in enumerate(caches) for name, ce in cg.items()
              if "state" in ce for key, leaf in ce["state"].items()
              if key != "idx"}
    return torch.cat(logits).cpu(), states


# the kernel each mixer launches once a prefill and once a decode step;
# MLA none: the reference computes it with plain einsums outside any
# Pallas kernel, and so does the port
MIXER_KERNEL = {"attn": "flash_attention", "local": "flash_attention",
                "rwkv6": "rwkv6_scan", "mamba": "mamba_scan", "mla": None}


def expected_launches(cfg, launches):
    """The serve run's launches: each mixer's kernel once per layer in the
    prefill and in every decode step, and in an encoder-decoder model K5
    once more per attention layer (the cross-attention) and once per
    encoder layer in the prefill; no other kernel."""
    want = {name: 0 for name in launches}
    for mixer, _ in cfg.pattern:           # prefill + (gen - 1) decode steps
        if MIXER_KERNEL[mixer] is not None:
            cross = cfg.encdec is not None and mixer in ("attn", "local")
            want[MIXER_KERNEL[mixer]] += ((1 + cross) * cfg.n_groups
                                          * SERVE_GEN)
    if cfg.encdec is not None:
        want["flash_attention"] += cfg.encdec.n_enc_layers
    return want


def checked_serve_phase(torch, ops, cfg, *, cut, check_layers,
                        prompt_len=SERVE_PROMPT, check_prompt=CHECK_PROMPT,
                        check_steps=CHECK_STEPS):
    """Phases 9, 11, 13, 15 and 17: the serve path at full width on the
    card (each kernel launched once per layer that runs it, a prefill and
    every decode step, and no other kernel: checked exactly), then the
    first ``check_layers`` layers of the same parameters (and the whole
    encoder) on the card and on the CPU, a ``check_prompt``-token prompt
    (with one request's frames or patches) and ``check_steps``
    teacher-forced decode steps.  Returns the parameters (the breakdown
    phase reuses them) and the phase line."""
    import numpy as np
    from repro_torch.kernels.plain import fp32_highest
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf

    params, line = serve_run(torch, ops, cfg, prompt_len=prompt_len)
    launches = line["launches"]
    want = expected_launches(cfg, launches)
    check(launches == want, f"{cfg.name}: launches {launches}, not {want}")

    # the first layers on the card and, copied, on the CPU
    n_groups = max(1, check_layers // len(cfg.pattern))
    pattern = cfg.pattern[:check_layers]
    sub_cfg = dataclasses.replace(cfg, n_layers=check_layers,
                                  pattern=pattern)
    sub = {k: v for k, v in params.items() if k != "groups"}
    sub["groups"] = [{f"l{i}": gp[f"l{i}"] for i in range(len(pattern))}
                     for gp in params["groups"][:n_groups]]
    rng = np.random.default_rng(1)
    inputs = serve.draw_batch(cfg, rng, 1, check_prompt, device="cpu")
    prompt = inputs.pop("tokens")
    forced = torch.as_tensor(rng.integers(0, cfg.vocab, (1, check_steps)))
    card_logits, card_states = teacher_forced(
        torch, tf, fp32_highest, sub_cfg, sub, prompt, forced, inputs)
    host = tf.to_device(sub, "cpu")
    t0 = time.perf_counter()
    host_logits, host_states = teacher_forced(
        torch, tf, fp32_highest, sub_cfg, host, prompt, forced, inputs)
    t_host = time.perf_counter() - t0
    del host
    step_rel = ((card_logits - host_logits).abs().amax(dim=1)
                / host_logits.abs().amax(dim=1)).tolist()
    state_rel = {f"{g}/{name}/{key}": float(
        (card_states[g, name, key] - leaf).abs().max()
        / max(1.0, float(leaf.abs().max())))
        for (g, name, key), leaf in host_states.items()}
    agree = int((card_logits.argmax(1) == host_logits.argmax(1)).sum())
    check(max(step_rel) <= CHECK_TOL,
          f"{cfg.name}: card vs CPU logits {step_rel} > {CHECK_TOL}")
    recurrent = any(MIXER_KERNEL[m] != "flash_attention" for m, _ in pattern)
    check(bool(state_rel) == recurrent
          and all(r <= CHECK_TOL for r in state_rel.values()),
          f"{cfg.name}: card vs CPU final states {state_rel}")
    kinds = {}
    if recurrent:
        kinds["ssm"] = dataclasses.asdict(cfg.ssm)
    elif any(m == "local" for m, _ in cfg.pattern):
        kinds["sliding_window"] = cfg.sliding_window
    if cfg.encdec is not None:
        kinds["encdec"] = dataclasses.asdict(cfg.encdec)
    if cfg.n_patches:
        kinds["n_patches"] = cfg.n_patches
    return params, {
        **line, "cut": cut, "pattern": [list(lk) for lk in cfg.pattern],
        "d_ff": cfg.d_ff, **kinds,
        "param_bytes": sum(t.numel() * t.element_size()
                           for t in tf._leaves(params)),
        "check_layers": f"the first {check_layers} layers "
                        f"({', '.join(m for m, _ in pattern)}), full width"
                        + (", and the whole encoder" if cfg.encdec else ""),
        "check_prompt": check_prompt,
        "check_teacher_forced_steps": check_steps,
        "check_logits_rel_per_step": step_rel,
        "check_logits_tol": CHECK_TOL, "check_state_rel": state_rel,
        "check_greedy_agree": f"{agree}/{check_steps + 1}",
        "check_cpu_s": t_host}


def rel_err(torch, got, want) -> float:
    """max |got - want| / max |want|, on the host."""
    got, want = got.cpu().float(), want.cpu().float()
    return float((got - want).abs().max() / want.abs().max())


def mla_check(torch, cfg, params, tf, attention, layers, fp32_highest):
    """(a) of the deepseek phase: the MLA mixer of the layer on the card
    and, copied, on the CPU: a CHECK_PROMPT-token prefill of the layer's
    own mixer inputs (the normed embeddings of random tokens, made on the
    card) into a latent cache, then CHECK_STEPS teacher-forced decode
    steps.  Returns each output's max |card - CPU| / max |CPU|, the
    prefill's first."""
    import numpy as np

    lp = params["groups"][0]["l0"]
    n = CHECK_PROMPT + CHECK_STEPS
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, n)), device="cuda")
    with torch.inference_mode():
        x_card = layers.rmsnorm(lp["norm1"], layers.embed(
            params["embed"], toks), cfg.norm_eps)
    outs = {}
    for dev, mixer, x in (("cuda", lp["mixer"], x_card),
                          ("cpu", tf.to_device(lp["mixer"], "cpu"),
                           x_card.cpu())):
        with torch.inference_mode(), fp32_highest():
            y, (ckv, krope) = attention.mla_forward(
                mixer, x[:, :CHECK_PROMPT], cfg, return_latent=True)
            cache = attention.fill_mla_cache(attention.init_mla_cache(
                cfg, 1, n, device=dev), ckv, krope)
            ys = [y]
            for t in range(CHECK_PROMPT, n):
                y, cache = attention.mla_decode(mixer, x[:, t:t + 1], cache,
                                                cfg)
                ys.append(y)
        outs[dev] = [y.cpu() for y in ys]
    return [rel_err(torch, c, h) for c, h in zip(outs["cuda"], outs["cpu"])]


def moe_check(torch, cfg, params, tf, attention, layers, moe, fp32_highest):
    """(b) of the deepseek phase: the MoE FFN of the layer on the serve
    prefill's own inputs (SERVE_REQUESTS x SERVE_PROMPT tokens, the normed
    residual after MLA, made on the card).  The router logits on the card
    and on the CPU; the routing of both (expert ids, positions, keep mask)
    equal, or else every differing token's smallest gap between adjacent
    logits of its k + 1 largest (the k-th/(k+1)-th gap, or the gap of two
    picks whose order swapped) below DEEPSEEK_GAP_TOL of the largest
    logit; every DEEPSEEK_EXPERT_STRIDE-th expert's SwiGLU over the card's
    dispatch rows recomputed on the CPU; and the combine of the card's expert outputs with the card's routing
    plus the shared expert recomputed on the CPU against the card's
    ``moe_forward``.  The 45 GB of experts stay on the card."""
    import numpy as np

    m = cfg.moe
    lp = params["groups"][0]["l0"]
    ffn = lp["ffn"]
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (SERVE_REQUESTS, SERVE_PROMPT)), device="cuda")
    cap = moe._capacity(SERVE_PROMPT, cfg)
    with torch.inference_mode(), fp32_highest():
        x = layers.embed(params["embed"], toks)
        o = attention.mla_forward(lp["mixer"], layers.rmsnorm(
            lp["norm1"], x, cfg.norm_eps), cfg)
        h2 = layers.rmsnorm(lp["norm2"], x + o, cfg.norm_eps)
        # why a row's tokens route alike under random weights: the MLA
        # output's share of the residual and its alignment within a row
        skew = {"mla_rms_over_embedding_rms": float(
                    o.pow(2).mean().sqrt() / x.pow(2).mean().sqrt()),
                "cos_to_row_mean": float(torch.nn.functional
                                         .cosine_similarity(
                    h2, h2.mean(1, keepdim=True), dim=-1).mean())}
        del x, o
        y_card, metrics = moe.moe_forward(ffn, h2, cfg)
        logits = h2.float() @ ffn["router"]
        r_card = moe.route(logits, cap, m.top_k)
        disp = moe.dispatch(h2, r_card, cap, m.n_experts)
        h_out = moe.expert_swiglu(ffn, disp)
        sample = torch.arange(0, m.n_experts, DEEPSEEK_EXPERT_STRIDE)
        disp_sample = disp[sample.cuda()].cpu()
        del disp
        out = {"moe_check_inputs": list(h2.shape), "capacity": cap,
               "moe_drop_frac": float(metrics["moe_drop_frac"]),
               "moe_aux_loss": float(metrics["moe_aux_loss"]),
               "routing_skew": skew}

    host = {"router": ffn["router"].cpu(),
            **{k: ffn[k][sample.cuda()].cpu()
               for k in ("w_gate", "w_up", "w_down")}}
    shared = tf.to_device(ffn["shared"], "cpu")
    h2_host = h2.cpu()
    with torch.inference_mode():
        logits_host = h2_host.float() @ host["router"]
        out["router_logits_rel"] = rel_err(torch, logits, logits_host)
        r_host = moe.route(logits_host, cap, m.top_k)
        card = [t.cpu() for t in r_card]
        r_card_host = moe.Route(*card)
        # a token routes alike when its expert ids agree; a pick that
        # differs moves the positions of later pairs of those experts
        differ = (card[0] != r_host.expert).any(-1)          # (B, S)
        top = torch.topk(logits_host, m.top_k + 1, dim=-1).values
        gap = ((top[..., :-1] - top[..., 1:]).amin(-1)
               / logits_host.abs().max())
        out["routing_equal"] = bool(
            not differ.any() and torch.equal(card[2], r_host.pos)
            and torch.equal(card[3], r_host.keep))
        out["routing_tokens_differing"] = int(differ.sum())
        out["routing_differing_topk_gaps"] = gap[differ].tolist()
        out["routing_min_topk_gap"] = float(gap.min())
        check(out["routing_equal"] or (
            differ.any() and bool((gap[differ] < DEEPSEEK_GAP_TOL).all())),
            f"deepseek: card vs CPU routing differs: {out}")
        h_sample = moe.expert_swiglu(host, disp_sample)[:-1]
        out["experts_checked"] = sample.tolist()
        out["experts_rel"] = rel_err(torch, h_out[sample.cuda()], h_sample)
        y_host = moe.combine(h_out.cpu(), r_card_host, cap) + layers.mlp(
            shared, h2_host.view(-1, cfg.d_model)).view(h2_host.shape)
        out["combine_rel"] = rel_err(torch, y_card, y_host)
    check(out["router_logits_rel"] <= CHECK_TOL
          and out["experts_rel"] <= CHECK_TOL
          and out["combine_rel"] <= CHECK_TOL,
          f"deepseek: card vs CPU MoE beyond {CHECK_TOL}: {out}")
    return out


def deepseek_phase(torch, ops, cfg):
    """Phase 19: deepseek-v3-671b at full width cut to one (MLA, MoE)
    layer: the serve run (no kernel of the port launched: the reference
    computes MLA and MoE outside any Pallas kernel), then its card-vs-CPU
    check by parts (the 53.4 GB layer is not copied to the host): (a) the
    MLA mixer, (b) the MoE FFN's routing, sampled experts and combine, (c)
    the whole layer's greedy tokens, on the card only."""
    import numpy as np
    from repro_torch.kernels.plain import fp32_highest
    from repro_torch.models import attention, layers, moe
    from repro_torch.models import transformer as tf

    params, line = serve_run(torch, ops, cfg)
    launches = line["launches"]
    check(launches == expected_launches(cfg, launches)
          and not any(launches.values()),
          f"deepseek: launches {launches}, not all 0")
    # param_count() leaves out the norms' scales
    check(line["n_params"] >= cfg.param_count(),
          f"deepseek: {line['n_params']} parameters, fewer than "
          f"{cfg.param_count()}")
    check(line["moe_drop_frac_decode"] == 0.0,
          f"deepseek: decode dropped {line['moe_drop_frac_decode']}")

    t0 = time.perf_counter()
    mla_rel = mla_check(torch, cfg, params, tf, attention, layers,
                        fp32_highest)
    check(max(mla_rel) <= CHECK_TOL,
          f"deepseek: card vs CPU MLA outputs {mla_rel} > {CHECK_TOL}")
    t_mla = time.perf_counter() - t0
    t0 = time.perf_counter()
    moe_res = moe_check(torch, cfg, params, tf, attention, layers, moe,
                        fp32_highest)
    t_moe = time.perf_counter() - t0
    prompt = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, CHECK_PROMPT)), device="cuda")
    toks, logits = greedy(torch, tf, fp32_highest, cfg, params, prompt,
                          CHECK_STEPS)
    check(bool(torch.isfinite(logits).all()) and toks.min() >= 0
          and toks.max() < cfg.vocab, f"deepseek: layer tokens {toks}")
    return params, {
        **line, "cut": DEEPSEEK_CUT, "pattern": [list(lk) for lk in
                                                 cfg.pattern],
        "mla": dataclasses.asdict(cfg.mla), "moe": dataclasses.asdict(cfg.moe),
        "param_bytes": sum(t.numel() * t.element_size()
                           for t in tf._leaves(params)),
        "check_mla": f"the layer's MLA mixer, a {CHECK_PROMPT}-token prompt "
                     f"and {CHECK_STEPS} teacher-forced steps",
        "check_mla_rel_per_output": mla_rel, "check_tol": CHECK_TOL,
        "check_mla_s": t_mla, "check_moe": moe_res,
        "check_moe_s": t_moe, "check_layer_tokens": toks[0].tolist()}


# the train phases: smollm-135m whole at full width, 8 x 1024 tokens from
# the synthetic pipeline (batch i at step i), 5 steps of the default
# AdamWConfig in float32, micro_steps 1 (K5 sees the whole batch); its
# card-vs-CPU check on the same seed-0 parameters cut to the first 2
# layers, 2 x 256 tokens; the descent check 6 steps at lr 1e-3 without
# warmup on one repeated batch.  whisper-tiny whole, 8 x (1500 frames + 64
# tokens), 3 steps.  Tolerances: loss and grad_norm within TRAIN_LOSS_TOL
# relative, each gradient leaf within TRAIN_GRAD_TOL of its largest entry
# (float32 sums in another order, K5 against the plain attention); the
# parameters after one step within 2.5 lr (Adam's first step is lr times
# the gradient's sign, and a gradient near 0 may take either sign).
# whisper's gradients get 3e-4: over 1500 near-evenly weighted keys K5's
# forward (3xTF32 products, ~2^-21 each against float32's 2^-24) leaves
# its outputs up to 2e-5 of their largest from float32's, and the
# backward's delta = rowsum(dO * O) carries that into dq and on into the
# q and k projections' gradients (1.3e-4 measured on an H100 80GB HBM3
# at 700 W, where K5's backward alone was within 1e-6 of float32's)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 5
TRAIN_CHECK_LAYERS, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 2, 2, 256
TRAIN_DESCENT_STEPS, TRAIN_DESCENT_LR = 6, 1e-3
WHISPER_TRAIN_BATCH, WHISPER_TRAIN_TOKENS, WHISPER_TRAIN_STEPS = 8, 64, 3
TRAIN_LOSS_TOL = 1e-5
TRAIN_GRAD_TOL = {"smollm-135m": 1e-4, "whisper-tiny": 3e-4,
                  "rwkv6-7b": 1e-4, "jamba-1.5-large-398b": 1e-4}
K5_COUNTS = ("flash_attention", "flash_attention_backward")
# the SSM train phases (Queue A item 12.10): rwkv6-7b at full width cut to
# 8 of its 32 layers (260.6 M parameters a layer and 0.537 B of embedding
# and head: 10.5 GB of float32 parameters, 52 GB to train with AdamW's
# float32 master copy, two moments and the gradients; the whole model would
# need 142 GB), and the jamba period's first two layers at d = 8192
# (attention + MLP, mamba + MLP: 2.85 B parameters, 11.4 GB, 57 GB to
# train; a third layer would pass 70 GB before activations); 8 x 512
# tokens, 3 steps of the default AdamWConfig, micro_steps 1; card vs CPU
# on the first 2 layers over 2 x 64 tokens (the host's float32 products of
# 1-3 B parameters: seconds; rwkv6-7b's leaves carry float32 noise near
# the 1e-4 gate at full width: the CPU against itself, 1 thread against 8,
# differs by 1.6e-4 of the largest at 2 x 32 and 2 x 64 tokens, and the
# card by 1.9e-4 at 2 x 32 and 6.0e-5 at 2 x 64, on an H100 80GB HBM3 at
# 700 W; ROADMAP Queue C), without the host's AdamW step (checked on
# smollm: jamba's AdamW state would be 45.6 GB of host memory); the loss
# must descend over 2 steps on a repeated batch at lr 2e-6 without warmup:
# an Adam step moves every weight by about lr, and a pre-activation
# summing 4096-16384 of them by up to lr times their count, so the loss
# moved by 1-5 nats a step at lr 3e-5 and overshot (rwkv6-7b 6.31, 7.17,
# 3.27; jamba 6.26, 5.22, 9.09 on an H100 80GB HBM3 at 700 W)
RWKV6_TRAIN_LAYERS = 8
RWKV6_TRAIN_CUT = ("8 of 32 layers: 10.5 GB of float32 parameters, 52 GB "
                   "to train; the whole model would need 142 GB")
JAMBA_TRAIN_CUT = ("the jamba period (dense_period) cut to its first 2 "
                   "layers, attention + MLP and mamba + MLP at d = 8192: "
                   "11.4 GB of float32 parameters, 57 GB to train")
SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, SSM_TRAIN_STEPS = 8, 512, 3
SSM_CHECK_LAYERS, SSM_CHECK_BATCH, SSM_CHECK_SEQ = 2, 2, 64
SSM_DESCENT_STEPS, SSM_DESCENT_LR = 2, 2e-6


# the dry run (``repro_torch.launch.dryrun.run_cell``) of every serve and
# train row, on the row's cut config and shape: its predicted peak (the
# live bytes of a ``meta`` trace of the step over the state it holds) must
# lie within DRYRUN_PEAK_TOL of the measured ``max_memory_allocated`` less
# what was held before the row, its launches must equal the row's.  The
# plans run in DRYRUN_WORKERS processes of their own (spawned, CPU only,
# ``meta`` tensors, ``nice`` 10), started before the kernels build and
# waited for before the first timed phase, so that no timed row shares
# the host with them: a ``meta`` trace runs every op through torch's
# Python meta functions, about 90 s of host for the fourteen plans on the
# card machine's host (the serve rows of smollm and internvl's 48 layers
# about 18 s each)
DRYRUN_PEAK_TOL, DRYRUN_WORKERS = 0.2, 6


def dryrun_cells():
    """{row: (config, ShapeConfig, run_cell keywords)} of every serve and
    train phase, cut as the phase cuts it: a serve row is a prefill of
    SERVE_REQUESTS prompts (its ``seq_len`` counting the patches) and
    SERVE_GEN - 1 decode steps, a train row one step of micro_steps 1."""
    from repro_torch.configs.base import ShapeConfig, dense_period, get_config

    jamba = dense_period(get_config("jamba-1.5-large-398b"))
    cut = dataclasses.replace
    serve = {"serve": (get_config(SERVE_ARCH), SERVE_PROMPT),
             "serve_rwkv6": (get_config("rwkv6-7b"), SERVE_PROMPT),
             "serve_jamba": (jamba, SERVE_PROMPT),
             "serve_gemma3": (get_config("gemma3-4b"), GEMMA3_PROMPT),
             "serve_whisper": (get_config("whisper-tiny"), WHISPER_PROMPT),
             "serve_internvl": (cut(get_config("internvl2-26b"),
                                    n_layers=INTERNVL_LAYERS), SERVE_PROMPT),
             "serve_deepseek": (cut(get_config("deepseek-v3-671b"),
                                    n_layers=1), SERVE_PROMPT)}
    cells = {tag: (cfg, ShapeConfig(tag, cfg.n_patches + prompt,
                                    SERVE_REQUESTS, "prefill"),
                   {"gen_len": SERVE_GEN})
             for tag, (cfg, prompt) in serve.items()}
    for tag, cfg, seq, batch in (
            ("train_smollm", get_config("smollm-135m"), TRAIN_SEQ,
             TRAIN_BATCH),
            ("train_whisper", get_config("whisper-tiny"),
             WHISPER_TRAIN_TOKENS, WHISPER_TRAIN_BATCH),
            ("train_rwkv6", cut(get_config("rwkv6-7b"),
                                n_layers=RWKV6_TRAIN_LAYERS), SSM_TRAIN_SEQ,
             SSM_TRAIN_BATCH),
            ("train_jamba", cut(jamba, n_layers=2, pattern=jamba.pattern[:2]),
             SSM_TRAIN_SEQ, SSM_TRAIN_BATCH)):
        cells[tag] = (cfg, ShapeConfig(tag, seq, batch, "train"),
                      {"micro_steps": 1})
    # the cuts' whole models (planned, not run): internvl2-26b's 48
    # layers served, rwkv6-7b's 32 and the jamba period's first 3 trained
    for tag, row, changes in (
            ("serve_internvl_uncut", "serve_internvl", {"n_layers": 48}),
            ("train_rwkv6_uncut", "train_rwkv6", {"n_layers": 32}),
            ("train_jamba_uncut", "train_jamba",
             {"n_layers": 3, "pattern": jamba.pattern[:3]})):
        cfg, shape, kw = cells[row]
        cells[tag] = (cut(cfg, **changes), shape, kw)
    return cells


def uncut_plan(tag: str, plan) -> dict:
    """The plan of a cut row's whole model (``dryrun_cells``)."""
    rec = plan.get()
    return {"tag": tag, "peak_bytes": rec["peak_bytes"], "fits": rec["fits"],
            "state_bytes": rec["state_bytes"], "launches": rec["launches"],
            "plan_s": rec["plan_s"]}


def dryrun_plan(tag: str, capacity: int) -> dict:
    """The dry run of row ``tag`` (``dryrun_cells``), in a worker process:
    its peak, launches, state and whether it fits ``capacity``."""
    import os

    os.environ["CUDA_VISIBLE_DEVICES"] = ""       # meta tensors only
    os.nice(10)                 # the rows on the card come first
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.launch import dryrun

    torch.set_num_threads(1)
    cfg, shape, kw = dryrun_cells()[tag]
    rec = dryrun.run_cell(cfg, shape, capacity_bytes=capacity,
                          with_costs=False, **kw)
    return {"peak_bytes": rec["memory"]["peak_bytes"],
            "fits": rec["memory"]["fits"], "launches": rec["launches"],
            "state_bytes": rec["state_bytes"], "plan_s": rec["plan_s"]}


def dryrun_check(tag: str, plan, measured_peak: int, measured_launches,
                 *, steps: int = 1, resident: int = 0) -> dict:
    """The dry run of row ``tag`` (an ``AsyncResult`` of ``dryrun_plan``)
    against the row: launches (``steps`` times the plan's, for a train
    row's steps) equal to the row's nonzero counts, and the peak plus
    ``resident`` (what the row holds beyond the plan's state: its other
    batches) within DRYRUN_PEAK_TOL of the measured peak."""
    rec = plan.get()
    predicted = rec["peak_bytes"] + resident
    ratio = predicted / measured_peak
    measured = {k: n for k, n in measured_launches.items() if n}
    want = {k: steps * n for k, n in rec["launches"].items()}
    check(measured == want, f"{tag}: launches {measured}, the dry run's "
          f"{want}")
    check(abs(ratio - 1) <= DRYRUN_PEAK_TOL, f"{tag}: the dry run's peak "
          f"{predicted} is {ratio} of the measured {measured_peak}")
    return {"predicted_peak_bytes": predicted,
            "measured_peak_bytes": measured_peak,
            "predicted_over_measured": ratio, "resident_extra": resident,
            "predicted_launches": rec["launches"],
            "measured_launches": {k: n // steps for k, n in measured.items()},
            "fits": rec["fits"], "state_bytes": rec["state_bytes"],
            "plan_s": rec["plan_s"]}


def _batch_bytes(batches) -> int:
    return sum(t.numel() * t.element_size() for b in batches
               for t in b.values())


def train_steps(torch, ops, step, params, opt, batches, tokens, *,
                counts=K5_COUNTS, key="k5"):
    """Run ``step`` over ``batches``; per step its metrics, host-clock ms
    (ending in a synchronize), tokens/s and, under ``key``, the launches
    of the kernels ``counts`` (K5's forward and backward), or with
    ``counts=None`` of every kernel launched."""
    rows = []
    for i, batch in enumerate(batches):
        before = ops.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        after = ops.launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        rows.append({"step": i + 1, **{k: float(v) for k, v in m.items()},
                     "ms": dt * 1e3, "tokens_per_s": tokens / dt,
                     key: ({k: n for k, n in delta.items() if n}
                           if counts is None
                           else {k: delta[k] for k in counts})})
    return params, opt, rows


def card_vs_cpu(torch, cfg, card, host, batch):
    """The loss, grad_norm and every gradient leaf of ``cfg`` on the card
    and on the CPU (plain kernels) from the same parameters and batch:
    the relative differences, and the largest leaf's."""
    from repro_torch.launch.train import device_batch
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import global_norm, tree_zip
    from repro_torch.train.steps import loss_and_grads
    from repro_torch.kernels.plain import fp32_highest

    with fp32_highest():
        g_card, m_card = loss_and_grads(
            card, cfg, device_batch(batch, torch.float32, "cuda"))
        g_host, m_host = loss_and_grads(
            host, cfg, device_batch(batch, torch.float32, "cpu"))
    out = {"loss_card": float(m_card["loss"]),
           "loss_cpu": float(m_host["loss"])}
    for key, a, b in (("loss", m_card["loss"], m_host["loss"]),
                      ("grad_norm", global_norm(g_card),
                       global_norm(g_host))):
        out[f"{key}_rel"] = abs(float(a) - float(b)) / abs(float(b))
        check(out[f"{key}_rel"] <= TRAIN_LOSS_TOL,
              f"{cfg.name}: card {key} {float(a)} against the CPU's "
              f"{float(b)}")
    tol = TRAIN_GRAD_TOL[cfg.name]
    worst = max(float((a.cpu() - b).abs().max() / b.abs().max().clamp(
        min=1e-30)) for a, b in tree_zip(g_card, g_host))
    check(worst <= tol, f"{cfg.name}: a gradient leaf on the card is off "
          f"by {worst} of its largest (> {tol})")
    out["grad_tol"] = tol
    out["grad_leaf_max_rel"] = worst
    out["grad_leaves"] = sum(1 for _ in tree_zip(g_card, g_host))
    del g_card
    return out


def train_smollm_phase(torch, ops, plan=None):
    """Phase 21: ``make_train_step`` on smollm-135m whole; see the
    constants above.  K5's launches a step are checked: with
    ``cfg.remat`` each of the 30 groups runs its forward twice (the
    forward, then its recompute in the backward pass), so 60 forward and
    30 backward launches, and no other kernel.  ``train_peak_bytes`` is
    the steps' ``max_memory_allocated`` less what was held before the
    phase; ``plan`` (``dryrun_plan``'s result, or None) is held to it."""
    import dataclasses as dc
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.data import make_batch_for
    from repro_torch.launch.train import device_batch
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import AdamWConfig, init_adamw
    from repro_torch.train.steps import make_train_step

    import numpy as np

    cfg = get_config("smollm-135m")
    dev = torch.device("cuda")
    held = torch.cuda.memory_allocated()     # the earlier phases' tensors
    params = tf.init_params(cfg, seed=0, device=dev)
    # a host copy of the seed-0 draw cut to its first layers (the steps
    # below update ``params`` in place; its card copy is made after them)
    cut_host = tf.to_device({"embed": params["embed"],
                             "final_norm": params["final_norm"],
                             "groups": params["groups"][:TRAIN_CHECK_LAYERS]},
                            "cpu")
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    batches = [device_batch(make_batch_for(cfg, shape, step=i),
                            torch.float32, dev) for i in range(TRAIN_STEPS)]
    opt = init_adamw(params)
    step = make_train_step(cfg, micro_steps=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    params, opt, rows = train_steps(torch, ops, step, params, opt, batches,
                                    TRAIN_BATCH * TRAIN_SEQ)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {"flash_attention": 2 * cfg.n_layers,
            "flash_attention_backward": cfg.n_layers}
    for r in rows:
        check(r["k5"] == want, f"train_smollm step {r['step']}: K5 "
              f"launches {r['k5']}, expected {want}")
        check(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]),
              f"train_smollm step {r['step']}: loss {r['loss']}")
    check(sum(launches.values()) == TRAIN_STEPS * sum(want.values()),
          f"train_smollm launched other kernels: {launches}")
    dry = plan and dryrun_check("train_smollm", plan, peak - held, launches,
                                steps=TRAIN_STEPS,
                                resident=_batch_bytes(batches[1:]))
    _, prof = profiled(torch, lambda: step(params, opt, batches[0]))
    del params, opt

    cut_card = tf.to_device(cut_host, dev)
    cfg_cut = dc.replace(cfg, n_layers=TRAIN_CHECK_LAYERS)
    check_batch = make_batch_for(cfg_cut, ShapeConfig(
        "check", TRAIN_CHECK_SEQ, TRAIN_CHECK_BATCH, "train"))
    vs_cpu = card_vs_cpu(torch, cfg_cut, cut_card, cut_host, check_batch)
    step_cut = make_train_step(cfg_cut, micro_steps=1)
    p_card, _, m_card = step_cut(cut_card, init_adamw(cut_card),
                                 device_batch(check_batch, torch.float32,
                                              dev))
    p_host, _, _ = step_cut(cut_host, init_adamw(cut_host),
                            device_batch(check_batch, torch.float32, "cpu"))
    lr = float(m_card["lr"])
    moved = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        tf._leaves(p_card), tf._leaves(p_host)))
    check(moved <= 2.5 * lr, f"train_smollm: the parameters after one step "
          f"differ by {moved} > 2.5 lr ({lr}) between card and CPU")
    vs_cpu.update({"params_after_one_step_max_abs": moved, "lr": lr})
    del p_card, p_host, cut_card, cut_host

    params = tf.init_params(cfg, seed=0, device=dev)
    descent = make_train_step(cfg, micro_steps=1, acfg=AdamWConfig(
        lr=TRAIN_DESCENT_LR, warmup_steps=0))
    _, _, d_rows = train_steps(torch, ops, descent, params,
                               init_adamw(params),
                               [batches[0]] * TRAIN_DESCENT_STEPS,
                               TRAIN_BATCH * TRAIN_SEQ)
    losses = [r["loss"] for r in d_rows]
    check(losses[-1] < losses[0] - 0.01, f"train_smollm: the loss did not "
          f"descend on a repeated batch: {losses}")
    del params, batches
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "layers": cfg.n_layers, "cut": "none: the "
            "whole model", "batch": [TRAIN_BATCH, TRAIN_SEQ],
            "micro_steps": 1, "dtype": "float32", "steps": rows,
            "launches": launches, "k5_per_step": want,
            "max_memory_allocated": peak, "train_peak_bytes": peak - held,
            "dryrun": dry, "profiled_step": prof,
            "card_vs_cpu": {"layers": TRAIN_CHECK_LAYERS,
                            "batch": [TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ],
                            **vs_cpu},
            "descent": {"lr": TRAIN_DESCENT_LR, "losses": losses}}


def train_whisper_phase(torch, ops, plan=None):
    """Phase 22: ``make_train_step`` on whisper-tiny whole, 3 steps.  K5
    a step: the 4 encoder layers once each (the encoder is not
    checkpointed), the 4 decoder groups' self- and cross-attention twice
    each (forward and recompute): 4 + 16 = 20 forward launches, and 4 + 8
    = 12 backward.  Card vs CPU: the whole model's loss, grad_norm and
    gradients on the first step's batch, before the steps.
    ``train_peak_bytes`` and ``plan`` as ``train_smollm_phase``'s."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.data import make_batch_for
    from repro_torch.launch.train import device_batch
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import init_adamw
    from repro_torch.train.steps import make_train_step

    import numpy as np

    cfg = get_config("whisper-tiny")
    dev = torch.device("cuda")
    held = torch.cuda.memory_allocated()     # the earlier phases' tensors
    params = tf.init_params(cfg, seed=0, device=dev)
    host = tf.to_device(params, "cpu")
    shape = ShapeConfig("train", WHISPER_TRAIN_TOKENS, WHISPER_TRAIN_BATCH,
                        "train")
    raw = [make_batch_for(cfg, shape, step=i)
           for i in range(WHISPER_TRAIN_STEPS)]
    vs_cpu = card_vs_cpu(torch, cfg, params, host, raw[0])
    del host
    batches = [device_batch(b, torch.float32, dev) for b in raw]
    step = make_train_step(cfg, micro_steps=1)
    opt = init_adamw(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    params, opt, rows = train_steps(
        torch, ops, step, params, opt, batches,
        WHISPER_TRAIN_BATCH * (WHISPER_TRAIN_TOKENS + cfg.encdec.enc_len))
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_enc, n_dec = cfg.encdec.n_enc_layers, cfg.n_layers
    want = {"flash_attention": n_enc + 2 * 2 * n_dec,
            "flash_attention_backward": n_enc + 2 * n_dec}
    for r in rows:
        check(r["k5"] == want, f"train_whisper step {r['step']}: K5 "
              f"launches {r['k5']}, expected {want}")
        check(np.isfinite(r["loss"]), f"train_whisper: loss {r['loss']}")
    check(abs(rows[0]["loss"] - vs_cpu["loss_card"])
          <= TRAIN_LOSS_TOL * abs(vs_cpu["loss_card"]), "train_whisper: the "
          "first step's loss differs from the checked forward's")
    dry = plan and dryrun_check("train_whisper", plan, peak - held,
                                launches, steps=WHISPER_TRAIN_STEPS,
                                resident=_batch_bytes(batches[1:]))
    del params, opt, batches
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "cut": "none: the whole model",
            "batch": [WHISPER_TRAIN_BATCH, cfg.encdec.enc_len,
                      WHISPER_TRAIN_TOKENS], "micro_steps": 1,
            "steps": rows, "launches": launches, "k5_per_step": want,
            "max_memory_allocated": peak, "train_peak_bytes": peak - held,
            "dryrun": dry, "card_vs_cpu": vs_cpu}


def ssm_train_phase(torch, ops, cfg, *, tag, cut, plan=None):
    """Phases 23 and 24: ``make_train_step`` on an SSM model at full
    width (``cfg``, cut in depth as ``cut`` says); see the constants
    above.  First, card vs CPU on its first SSM_CHECK_LAYERS layers (a
    view of the seed-0 draw and its copy on the host).  Then the steps,
    each checked to launch exactly the kernels of the remat rule: every
    layer's mixer kernel (K7, K6 or K5) once in the forward and once in
    its group's or its own checkpoint's recompute (``cfg.remat`` with more
    than one group, or ``cfg.layer_remat``), its backward once, and no
    other kernel.  Then a profiled step, and the descent on a repeated
    batch with a fresh optimizer.  ``train_peak_bytes`` and ``plan`` as
    ``train_smollm_phase``'s."""
    import dataclasses as dc
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_batch_for
    from repro_torch.launch.train import device_batch
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import AdamWConfig, init_adamw
    from repro_torch.train.steps import make_train_step

    import numpy as np

    dev = torch.device("cuda")
    held = torch.cuda.memory_allocated()     # the earlier phases' tensors
    t0 = time.perf_counter()
    params = tf.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    groups = max(1, SSM_CHECK_LAYERS // len(cfg.pattern))
    cfg_cut = dc.replace(cfg, n_layers=groups * len(cfg.pattern))
    cut_card = {**params, "groups": params["groups"][:groups]}
    check_batch = make_batch_for(cfg_cut, ShapeConfig(
        "check", SSM_CHECK_SEQ, SSM_CHECK_BATCH, "train"))
    vs_cpu = card_vs_cpu(torch, cfg_cut, cut_card,
                         tf.to_device(cut_card, "cpu"), check_batch)
    del cut_card

    kernel = {"rwkv6": "rwkv6_scan", "mamba": "mamba_scan",
              "attn": "flash_attention"}
    runs = 1 + (cfg.remat and cfg.n_groups > 1) + cfg.layer_remat
    want = Counter()
    for mixer, _ in cfg.pattern * cfg.n_groups:
        want[kernel[mixer]] += runs
        want[f"{kernel[mixer]}_backward"] += 1
    want = dict(want)
    shape = ShapeConfig("train", SSM_TRAIN_SEQ, SSM_TRAIN_BATCH, "train")
    batches = [device_batch(make_batch_for(cfg, shape, step=i),
                            torch.float32, dev)
               for i in range(SSM_TRAIN_STEPS)]
    opt = init_adamw(params)
    step = make_train_step(cfg, micro_steps=1)
    tokens = SSM_TRAIN_BATCH * SSM_TRAIN_SEQ
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    params, opt, rows = train_steps(torch, ops, step, params, opt, batches,
                                    tokens, counts=None, key="launches")
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for r in rows:
        check(r["launches"] == want, f"train_{tag} step {r['step']}: "
              f"launches {r['launches']}, expected {want}")
        check(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]),
              f"train_{tag} step {r['step']}: loss {r['loss']}")
    dry = plan and dryrun_check(f"train_{tag}", plan, peak - held, launches,
                                steps=SSM_TRAIN_STEPS,
                                resident=_batch_bytes(batches[1:]))
    prof = profiled(torch, lambda: step(params, opt, batches[0]))[1]
    del opt              # before a fresh optimizer state of 3 x 10-11 GB
    descent = make_train_step(cfg, micro_steps=1, acfg=AdamWConfig(
        lr=SSM_DESCENT_LR, warmup_steps=0))
    _, _, d_rows = train_steps(torch, ops, descent, params,
                               init_adamw(params),
                               [batches[0]] * SSM_DESCENT_STEPS, tokens)
    losses = [r["loss"] for r in d_rows]
    check(losses[-1] < losses[0] - 0.01, f"train_{tag}: the loss did not "
          f"descend on a repeated batch: {losses}")
    del params, batches
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "layers": cfg.n_layers, "cut": cut,
            "batch": [SSM_TRAIN_BATCH, SSM_TRAIN_SEQ], "micro_steps": 1,
            "dtype": "float32", "init_params_s": init_s, "steps": rows,
            "launches": launches, "launches_per_step": want,
            "max_memory_allocated": peak, "train_peak_bytes": peak - held,
            "dryrun": dry, "profiled_step": prof,
            "card_vs_cpu": {"layers": cfg_cut.n_layers,
                            "batch": [SSM_CHECK_BATCH, SSM_CHECK_SEQ],
                            "host_adamw_step": "not run: AdamW is "
                            "checked card vs CPU on smollm, and jamba's "
                            "state would take 45.6 GB of host memory",
                            **vs_cpu},
            "descent": {"lr": SSM_DESCENT_LR, "losses": losses}}


def breakdown_serve(torch, cfg, params, *, prompt_len=SERVE_PROMPT):
    """Phases 8, 10, 12, 14, 16, 18 and 20: the serve path's prefill and
    one decode step (after one warm decode step) under torch.profiler."""
    import numpy as np
    from repro_torch.launch import serve
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    prefill = make_prefill_step(
        cfg, cache_len=cfg.n_patches + prompt_len + SERVE_GEN)
    decode = make_decode_step(cfg)
    batch = serve.draw_batch(cfg, np.random.default_rng(0), SERVE_REQUESTS,
                             prompt_len, device="cuda")
    out = {}

    def stage(name, fn):
        result, out[name] = profiled(torch, fn, cross_check=True)
        return result

    tok, caches, _ = stage("prefill", lambda: prefill(params, batch))
    tok, caches, _ = decode(params, caches, tok[:, None])
    stage("decode_step", lambda: decode(params, caches, tok[:, None]))
    return out


def k5_train_rows(torch, ops, plain, checks, train_res, row, shapes_line):
    """The ``kernels`` line's rows of K5 on the train paths: its forward
    with the log-sum-exp at smollm's train shape and its backward at each
    of K5_BWD_SHAPES (float32), timed through ``row`` (``main``'s); the
    backward's CUDA-core bound goes into ``shapes_line``."""
    from repro_torch.kernels import work as W

    dev = torch.device("cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # K5's forward with the log-sum-exp at smollm's train shape and its
    # backward at the train paths' shapes (float32; rows of their own, the
    # launches the train phases', 0 where no train phase runs the shape);
    # the bound counts 2.5 x the forward's operations as 3 TF32 products
    # each (the prefill's rule, and the backward's own: 3xTF32 on the
    # tensor cores; the CUDA-core bound beside it in the kernel_shapes
    # line); the yardsticks are SDPA's forward and the backward alone of
    # SDPA with enable_gqa over the live heads (a boolean band mask for
    # the window)
    for tag, (shape, causal, window) in K5_BWD_SHAPES.items():
        b_, h_, live, hkv, s_, t_, d_ = shape
        q, k, v, do, kw = k5_bwd_inputs(torch, *shape, causal=causal,
                                        window=window)
        o, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
        band = None
        if window:
            ones = torch.ones((s_, t_), dtype=torch.bool, device=dev)
            band = ones.tril(t_ - s_) & ~ones.tril(t_ - s_ - window)
        sdpa_kw = ({"attn_mask": band} if window else
                   {"is_causal": causal})
        model = tag.split("_")[0]
        desc = (f"{tag.replace('_train', '').replace('_', ' ')} train: "
                f"{'causal' if causal else 'non-causal'}"
                f"{f', window {window}' if window else ''}, S = {s_}, "
                f"T = {t_}, D = {d_}, {live} of {h_} q / {hkv} KV heads")
        if tag == "smollm_train":
            nbytes, flops = W.attn_work(b_, h_, s_, t_, d_, live, hkv,
                                        window, causal)
            nbytes += 4 * b_ * h_ * s_
            row(f"flash_attention (forward with log-sum-exp, {desc})",
                train_res["smollm"]["launches"]["flash_attention"],
                float((o - plain.flash_attention_plain(q, k, v, **kw)
                       ).abs().max()),
                lambda: ops.flash_attention(q, k, v, return_lse=True, **kw),
                lambda: plain.flash_attention_plain(q, k, v, return_lse=True,
                                                    **kw),
                nbytes, 3 * flops,
                lambda: sdpa(q[:, :live], k, v, enable_gqa=True, **sdpa_kw),
                kernel="flash_attention", peak_ops=PEAK_TF32_S,
                plain_kw={"reps": 3})
        qs, ks, vs = (x.detach().requires_grad_(True)
                      for x in (q[:, :live], k, v))
        out_l = sdpa(qs, ks, vs, enable_gqa=True, **sdpa_kw)
        do_l = do[:, :live].contiguous()
        nbytes, flops = W.k5_bwd_work(*shape, causal=causal, window=window)
        row(f"flash_attention_backward ({desc})",
            train_res[model]["launches"]["flash_attention_backward"]
            if model in train_res else 0,
            checks[f"K5_bwd_{tag}_float32"]["max_abs_err"],
            lambda: ops.flash_attention_backward(q, k, v, o, do, lse, **kw),
            lambda: plain.flash_attention_backward_plain(q, k, v, o, do, lse,
                                                         **kw),
            nbytes, 3 * flops,
            lambda: torch.autograd.grad(out_l, (qs, ks, vs), do_l,
                                        retain_graph=True),
            kernel="flash_attention_backward", peak_ops=PEAK_TF32_S,
            plain_kw={"reps": 3}, device_n=BWD_DEVICE_N)
        shapes_line[f"flash_attention_backward_{tag}"] = {
            "shape": {"B": b_, "H": h_, "live_heads": live, "Hkv": hkv,
                      "S": s_, "T": t_, "D": d_, "causal": causal,
                      "window": window},
            "bound_cuda_cores": dict(zip(("bound_ms", "bound_by"),
                                         bound(nbytes, flops)))}
        del q, k, v, do, o, lse, qs, ks, vs, out_l, do_l, band


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch next to {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT / "tests"))     # _torch_world: gloo ranks
    import numpy as np

    import repro_torch
    from repro_torch import sparse
    from repro_torch.core.gsofa import prepare_graph
    from repro_torch.kernels import _build, ops, plain
    from repro_torch.kernels import work as W
    from repro_torch.sparse.numeric import generic_values_csr

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    # the dry run of every serve and train row, planned for this card's
    # memory while the kernels build and are checked, and waited for
    # before the first timed phase; the workers are stopped however the
    # run ends
    import atexit
    import multiprocessing

    pool = multiprocessing.get_context("spawn").Pool(DRYRUN_WORKERS)
    atexit.register(pool.terminate)
    capacity = torch.cuda.get_device_properties(0).total_memory
    plans = {tag: pool.apply_async(dryrun_plan, (tag, capacity))
             for tag in dryrun_cells()}
    pool.close()
    t0 = time.perf_counter()
    built = _build.build()
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "built": sorted(built), "build_s": time.perf_counter() - t0})

    a = sparse.bordered_block_diagonal(N_LARGE, block=BLOCK, border=BORDER,
                                       seed=SEED)
    graph = prepare_graph(a, dense_block=128, device="cuda")
    adj = graph.adj_dense
    checks = kernel_checks(torch, ops, plain, graph)
    t0 = time.perf_counter()
    pool.join()
    emit({"phase": "kernels", "dryrun_wait_s": time.perf_counter() - t0,
          **checks})

    values = generic_values_csr(a)
    ops.reset_launches()
    opts = repro_torch.LUOptions(concurrency=CONCURRENCY)
    plan, factor, res = run_path(torch, repro_torch, a, values, opts)
    counts_default = ops.launch_counts()
    for name in ("ell_superstep", "column_fingerprints",
                 "panel_update_mapped"):
        check(counts_default[name] > 0,
              f"{name} was not launched on the default path")
    emit({"phase": "default", "n": a.n, "nnz": a.nnz,
          "device": plan.device, "launches": counts_default, **res})

    kopts = opts.replace(backend="kernel", numeric_backend="kernel")
    ops.reset_launches()
    plan_k, factor_k, res_k = run_path(torch, repro_torch, a, values, kopts,
                                       profile_head=True)
    launches = ops.launch_counts()          # phase 4 alone: the kernel path
    seen = res_k.pop("profiler")
    check(np.array_equal(plan_k.sym.l_counts, plan.sym.l_counts)
          and np.array_equal(plan_k.sym.u_counts, plan.sym.u_counts)
          and np.array_equal(plan_k.sym.supernodes, plan.sym.supernodes)
          and np.array_equal(plan_k.pattern.indptr, plan.pattern.indptr)
          and np.array_equal(plan_k.pattern.rowind, plan.pattern.rowind),
          "kernel-path structure differs from the default path")
    f64 = factor.store.flat
    factor_rel = float((factor_k.store.flat - f64).abs().max()
                       / f64.abs().max())
    check(factor_rel <= 1e-4, f"kernel-path factors off by {factor_rel}")
    for name in PROFILED_PATH:
        check(launches[name] > 0,
              f"{name} was not launched on the kernel path")
    check(launches["ell_superstep"] == 0,
          f"K8 launched {launches['ell_superstep']} times on the kernel path")
    for name in PROFILED:
        check(name in seen, f"torch.profiler did not see {name}: {seen}")
    # segment batching within the port: one mapped launch per level vs one
    # per panel, bitwise on both backends (float32 and float64)
    unbatched = dataclasses.replace(
        plan, options=opts.replace(segment_batch=False)).factorize(values)
    seg_equal = bool(torch.equal(unbatched.store.flat, factor.store.flat))
    check(seg_equal, "float64: segment_batch=True differs from False")
    unbatched_k = dataclasses.replace(
        plan_k, options=kopts.replace(segment_batch=False)).factorize(values)
    check(torch.equal(unbatched_k.store.flat, factor_k.store.flat),
          "kernel backend: segment_batch=True differs from False")
    emit({"phase": "kernel_path", "launches": launches,
          "profiler": {k: {"calls": c, "device_ms": ms}
                       for k, (c, ms) in seen.items()},
          "factor_rel_vs_default": factor_rel,
          "segment_batch_bitwise_kernel": True,
          "segment_batch_bitwise_float64": seg_equal, **res_k})

    bubble_res = bubble_phase(torch, repro_torch, ops, a, opts, plan)
    emit({"phase": "bubble", "default_analyze_s": res["analyze_s"],
          **bubble_res})
    batched_res, counts_batched = batched_phase(
        torch, repro_torch, ops, a, plan, plan_k, generic_values_csr)
    emit({"phase": "batched", **batched_res,
          "zero_pivot": zero_pivot_check(torch, repro_torch, sparse,
                                         generic_values_csr)})

    from repro_torch.sparse import matrices
    robust_res, counts_robust = robust_phase(torch, repro_torch, ops,
                                             matrices, generic_values_csr)
    emit({"phase": "robust", **robust_res})
    blocking_res, (plan_b, factor_b), (plan_bk, factor_bk) = blocking_phase(
        torch, repro_torch, ops, plan, values, res, plan_k, res_k)
    emit({"phase": "blocking", **blocking_res})
    serve_lu_res = serve_lu_phase(torch, repro_torch, ops, sparse, plan,
                                  generic_values_csr)
    emit({"phase": "serve_lu", **serve_lu_res})
    dist_res = distributed_phase(torch, repro_torch, ops, a, values, opts,
                                 plan, factor, res, plan_k, factor_k, res_k)
    emit({"phase": "distributed", **dist_res})
    # K2 and the mapped K3/K4 on the new paths (the kernels line's rows)
    new_paths = {
        "robust": counts_robust,
        "blocking": blocking_res["blocked"]["launches"],
        "autotune": blocking_res["autotuned"]["launches"],
        "blocking_kernel": blocking_res["kernel_blocked"]["launches"],
        "serve_lu": {k: serve_lu_res["flush_1"]["launches"][k]
                     + serve_lu_res["flush_2"]["launches"][k]
                     for k in counts_robust}}
    # item 10's paths: each rank's K1/K2 of the sharded analyze, the
    # dynamic analyzes' K1/K2, the placed sweeps' mapped launches (d = 1,
    # 2, 4, one refactorize each)
    dyn = dist_res["dynamic"]
    for tag in ("default", "kernel"):
        new_paths[f"sharded_{tag}"] = {
            k: [r[tag]["launches"][k] for r in dist_res["sharded"]["ranks"]]
            for k in ("minmax_relax", "ell_superstep", "column_fingerprints")}
        new_paths[f"dynamic_4_slots_{tag}"] = dyn[
            f"symbolic_4_slots_{tag}"]["launches"]
        new_paths[f"placed_{tag}"] = {"panel_update_mapped": sum(
            dist_res["placed"][tag][str(d)]["mapped_launches"]
            for d in (1, 2, 4))}         # the first placed sweep at each d
    new_paths["dynamic_1_slot"] = dyn["analyze_1_slot"]["launches"]
    new_paths["bubble"] = bubble_res["default"]["launches"]

    emit({"phase": "breakdown_default",
          **breakdown(torch, repro_torch, a, values, opts, sweep=True)})
    emit({"phase": "breakdown_kernel",
          **breakdown(torch, repro_torch, a, values, kopts, sweep=False)})

    emit({"phase": "reference",
          **reference_check(torch, repro_torch, sparse, generic_values_csr)})

    from repro_torch.configs.base import dense_period, get_config

    params, serve_res = serve_phase(torch, ops)
    serve_res["dryrun"] = dryrun_check(
        "serve", plans["serve"], serve_res["serve_peak_bytes"],
        serve_res["launches"])
    emit({"phase": "serve", **serve_res})
    emit({"phase": "breakdown_serve",
          **breakdown_serve(torch, get_config(SERVE_ARCH), params)})
    del params

    serve_launches = {}
    for tag, cfg, cut, layers, kw in (
            ("rwkv6", get_config("rwkv6-7b"), "none: the whole model", 4,
             {}),
            ("jamba", dense_period(get_config("jamba-1.5-large-398b")),
             "one 8-layer period of 72 (1 attention + 7 mamba), each MoE "
             "FFN (16 experts) replaced by the dense MLP of the same width",
             2, {}),
            ("gemma3", get_config("gemma3-4b"), "none: the whole model",
             GEMMA3_CHECK_LAYERS,
             {"prompt_len": GEMMA3_PROMPT,
              "check_prompt": GEMMA3_CHECK_PROMPT,
              "check_steps": GEMMA3_CHECK_STEPS}),
            ("whisper", get_config("whisper-tiny"), "none: the whole model",
             4, {"prompt_len": WHISPER_PROMPT, "check_prompt": WHISPER_PROMPT,
                 "check_steps": WHISPER_CHECK_STEPS}),
            ("internvl", dataclasses.replace(get_config("internvl2-26b"),
                                             n_layers=INTERNVL_LAYERS),
             INTERNVL_CUT, 2, {})):
        params, res = checked_serve_phase(torch, ops, cfg, cut=cut,
                                          check_layers=layers, **kw)
        res["dryrun"] = dryrun_check(f"serve_{tag}", plans[f"serve_{tag}"],
                                     res["serve_peak_bytes"], res["launches"])
        if f"serve_{tag}_uncut" in plans:
            res["dryrun_uncut"] = uncut_plan(f"serve_{tag}_uncut",
                                             plans[f"serve_{tag}_uncut"])
        serve_launches[tag] = res["launches"]
        emit({"phase": f"serve_{tag}", **res})
        emit({"phase": f"breakdown_serve_{tag}",
              **breakdown_serve(torch, cfg, params,
                                prompt_len=kw.get("prompt_len",
                                                  SERVE_PROMPT))})
        del params
        torch.cuda.empty_cache()

    # after the earlier models' parameters are freed: the deepseek layer
    # holds 53.4 GB
    cfg = dataclasses.replace(get_config("deepseek-v3-671b"), n_layers=1)
    params, res = deepseek_phase(torch, ops, cfg)
    res["dryrun"] = dryrun_check("serve_deepseek", plans["serve_deepseek"],
                                 res["serve_peak_bytes"], res["launches"])
    serve_launches["deepseek"] = res["launches"]
    emit({"phase": "serve_deepseek", **res})
    emit({"phase": "breakdown_serve_deepseek",
          **breakdown_serve(torch, cfg, params)})
    del params
    torch.cuda.empty_cache()

    train_res = {"smollm": train_smollm_phase(torch, ops,
                                              plans["train_smollm"])}
    emit({"phase": "train_smollm", **train_res["smollm"]})
    train_res["whisper"] = train_whisper_phase(torch, ops,
                                               plans["train_whisper"])
    emit({"phase": "train_whisper", **train_res["whisper"]})
    train_res["rwkv6"] = ssm_train_phase(
        torch, ops, dataclasses.replace(get_config("rwkv6-7b"),
                                        n_layers=RWKV6_TRAIN_LAYERS),
        tag="rwkv6", cut=RWKV6_TRAIN_CUT, plan=plans["train_rwkv6"])
    train_res["rwkv6"]["dryrun_uncut"] = uncut_plan(
        "train_rwkv6_uncut", plans["train_rwkv6_uncut"])
    emit({"phase": "train_rwkv6", **train_res["rwkv6"]})
    jamba = dense_period(get_config("jamba-1.5-large-398b"))
    train_res["jamba"] = ssm_train_phase(
        torch, ops, dataclasses.replace(jamba, n_layers=2,
                                        pattern=jamba.pattern[:2]),
        tag="jamba", cut=JAMBA_TRAIN_CUT, plan=plans["train_jamba"])
    train_res["jamba"]["dryrun_uncut"] = uncut_plan(
        "train_jamba_uncut", plans["train_jamba_uncut"])
    emit({"phase": "train_jamba", **train_res["jamba"]})

    # per-kernel times at the main paths' shapes: the kernel and the
    # library call on the device alone (device_ms), the plain version with
    # CUDA events around it (cuda_ms, ``plain_kw`` its repetitions)
    rng = np.random.default_rng(1)
    dev = torch.device("cuda")
    kern = []

    def timing(fn, plain_fn, nbytes, nops, library_fn=None, *,
               peak_ops=PEAK_OPS_S, sfu_ops=0, alu_ops=0, plain_kw=None,
               device_n=50):
        b_ms, b_by = bound(nbytes, nops, peak_ops, sfu_ops, alu_ops)
        return {"ms": device_ms(torch, fn, n=device_n),
                "plain_ms": cuda_ms(torch, plain_fn, **(plain_kw or {})),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": library_fn and device_ms(torch, library_fn,
                                                       n=device_n)}

    def row(name, n_launches, err, *args, kernel=None, **kw):
        src, replaces = SOURCES[kernel or name]
        kern.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": n_launches,
                     "max_abs_err": err, **timing(*args, **kw)})

    s, u = CONCURRENCY, adj.shape[0]
    prop = torch.as_tensor(rng.integers(0, u, size=(s, u)).astype(np.int32),
                           device=dev)
    got = ops.minmax_relax(prop, adj)
    err = float((got - plain.minmax_relax_plain(prop, adj)).abs().max())
    nnz_adj = int((adj != 0).sum())
    row("minmax_relax", launches["minmax_relax"], err,
        lambda: ops.minmax_relax(prop, adj),
        lambda: plain.minmax_relax_plain(prop, adj),
        *W.minmax_relax_work(s, u, adj.shape[1], nnz_adj),
        plain_kw={"reps": 1, "warmup": 0})
    kern[-1]["launches_on_new_paths"] = {
        path: new_paths[path]["minmax_relax"]
        for path in ("sharded_kernel", "dynamic_4_slots_kernel")}

    # K8 on the default path: its first superstep at S = 512 (no row
    # skipped, the most work a superstep does) over the bbd-20k table
    from repro_torch.core.gsofa import init_labels

    v, k8 = N_LARGE, graph.in_ell.shape[1]
    srcs8 = torch.arange(v - s, v, dtype=torch.int32, device=dev)
    lab8 = init_labels(graph, srcs8)
    nxt8, ref8 = torch.empty_like(lab8), torch.empty_like(lab8)
    c_k, c_p = ([torch.zeros(n, dtype=torch.int32, device=dev)
                 for n in (s, s, 1)] for _ in range(2))

    def k8_call():
        ops.ell_superstep(lab8, nxt8, graph.in_ell, graph.out_deg, srcs8,
                          *c_k, offset=0, it=0)

    def k8_plain():
        plain.ell_superstep_plain(lab8, ref8, graph.in_ell, graph.out_deg,
                                  srcs8, *c_p, offset=0, it=0)

    k8_call()
    k8_plain()
    err = float((nxt8 - ref8).abs().max())
    row("ell_superstep", counts_default["ell_superstep"], err, k8_call,
        k8_plain, *W.ell_superstep_work(s, v, k8))
    kern[-1]["launches_on_new_paths"] = {
        path: new_paths[path]["ell_superstep"]
        for path in ("bubble", "robust", "serve_lu", "sharded_default",
                     "dynamic_1_slot", "dynamic_4_slots_default")}

    rel = torch.as_tensor(rng.integers(-1, v + 2, size=(s, v)).astype(
        np.int32), device=dev)
    lanes = [torch.as_tensor(x, device=dev) for x in (
        np.arange(s, dtype=np.int32) * 37,
        rng.integers(-2 ** 31, 2 ** 31, size=s).astype(np.int32),
        rng.integers(-2 ** 31, 2 ** 31, size=s).astype(np.int32),
        np.ones(s, dtype=np.int32))]
    err = float((ops.column_fingerprints(rel, *lanes)
                 - plain.column_fingerprints_plain(rel, *lanes)).abs().max())
    row("column_fingerprints", launches["column_fingerprints"], err,
        lambda: ops.column_fingerprints(rel, *lanes),
        lambda: plain.column_fingerprints_plain(rel, *lanes),
        *W.column_fingerprints_work(s, v))
    kern[-1]["launches_on_new_paths"] = {
        path: new_paths[path]["column_fingerprints"]
        for path in ("robust", "serve_lu", "sharded_default",
                     "sharded_kernel", "dynamic_1_slot",
                     "dynamic_4_slots_default", "dynamic_4_slots_kernel")}

    # K3/K4 at the commonest GEMM shape and the largest stack of the bbd-20k
    # sweep: float32 (the kernel path's launches) and float64 (the default
    # path's)
    shapes = gemm_shapes(plan)
    k3_shape = Counter((mm, kk, nn) for _, _, mm, kk, nn in shapes
                       ).most_common(1)[0][0]
    groups = Counter((li, mm, kk, nn) for li, _, mm, kk, nn in shapes)
    (_, bm, bk, bn), bsz = max(groups.items(), key=lambda kv: kv[1])
    check(bsz > 1, "no stacked GEMM group in the bbd-20k sweep")
    for dtype, suffix, counts, peak in (
            (torch.float32, "", launches, PEAK_OPS_S),
            (torch.float64, " (float64)", counts_default, PEAK_F64_OPS_S)):
        esize = 8 if dtype == torch.float64 else 4
        m, k, n = k3_shape
        acc, lp, up = (torch.as_tensor(rng.standard_normal(sh), dtype=dtype,
                                       device=dev)
                       for sh in ((m, n), (m, k), (k, n)))
        err, tol = k3_error(torch, ops, plain, acc, lp, up)
        check(err <= tol, f"K3{suffix} at the common bbd shape: {err} > {tol}")
        row("panel_update" + suffix, counts["panel_update"], err,
            lambda: ops.panel_update(acc, lp, up),
            lambda: plain.panel_update_plain(acc, lp, up),
            *W.panel_update_work(m, k, n, esize),
            lambda: torch.addmm(acc, lp, up, alpha=-1),
            kernel="panel_update", peak_ops=peak, plain_kw={"inner": 100})

        m, k, n = bm, bk, bn
        accb, lpb, upb = (torch.as_tensor(rng.standard_normal(sh),
                                          dtype=dtype, device=dev)
                          for sh in ((bsz, m, n), (bsz, m, k), (bsz, k, n)))
        got = ops.panel_update_batched(accb, lpb, upb)
        err = float((got - plain.panel_update_batched_plain(accb, lpb, upb)
                     ).abs().max())
        check(k4_bitwise(torch, ops, rng, bsz, m, k, n, dtype=dtype),
              f"K4{suffix} != K3 per slice")
        row("panel_update_batched" + suffix, counts["panel_update_batched"],
            err, lambda: ops.panel_update_batched(accb, lpb, upb),
            lambda: plain.panel_update_batched_plain(accb, lpb, upb),
            *W.panel_update_work(m, k, n, esize, bsz),
            lambda: torch.baddbmm(accb, lpb, upb, alpha=-1),
            kernel="panel_update_batched", peak_ops=peak,
            plain_kw={"inner": 100})
    # dense K4 float64 (the last stack above) against baddbmm in turns,
    # five samples each, and an empty kernel's device time at one block
    # and at that stack's grid (one block per slice): the floor
    panel_line = {"panel_update_batched_f64_vs_baddbmm": {
        "shape": [bsz, bm, bk, bn], "panel_update_batched_ms": [],
        "baddbmm_ms": []}}
    turns = panel_line["panel_update_batched_f64_vs_baddbmm"]
    for _ in range(5):
        turns["panel_update_batched_ms"].append(device_ms(
            torch, lambda: ops.panel_update_batched(accb, lpb, upb), reps=1))
        turns["baddbmm_ms"].append(device_ms(
            torch, lambda: torch.baddbmm(accb, lpb, upb, alpha=-1), reps=1))
    panel_line["empty_kernel_ms"] = {
        str(nb): device_ms(torch, lambda: ops.panel_update_empty(nb, dev))
        for nb in (1, bsz)}

    # the mapped K3/K4 over bbd-20k's largest level (most slices) on the
    # factored store with random U rows, float64 (the default path's) and
    # float32 (the kernel path's), and at the widest level of the blocked
    # plans (merged panels up to 256 wide, explicit-zero rows): each
    # checked against its plain version and bitwise dense K3 per slice; the
    # bound counts the L entries the map hits, U, and acc read and written,
    # and 2 flops per hit per column (``level_operands``); no single
    # PyTorch call updates a ragged set of slices in place
    flat_lvl, u_lvl, lmap, tiles, work = level_operands(torch, plan, factor,
                                                        rng)
    panel_line["panel_update_mapped"] = work
    # each mapped row's launches on the new paths of its element type and
    # system count (the blocked rows' own paths are their ``launches``)
    on_paths = {"panel_update_mapped": ("blocking_kernel", "placed_kernel"),
                "panel_update_mapped (float64)": ("robust", "blocking",
                                                  "autotune",
                                                  "placed_default")}
    for name, p_, f_, f32, counts, peak, widest in (
            ("panel_update_mapped", plan, factor, True, launches,
             PEAK_OPS_S, False),
            ("panel_update_mapped (float64)", plan, factor, False,
             counts_default, PEAK_F64_OPS_S, False),
            ("panel_update_mapped (blocked, float64)", plan_b, factor_b,
             False, new_paths["blocking"], PEAK_F64_OPS_S, True),
            ("panel_update_mapped (blocked, float32)", plan_bk, factor_bk,
             True, new_paths["blocking_kernel"], PEAK_OPS_S, True)):
        fl, uu, lm, tl, wk = ((flat_lvl, u_lvl, lmap, tiles, work)
                              if not widest else
                              level_operands(torch, p_, f_, rng, widest=True))
        if widest:
            panel_line[name] = wk
        err, _ = mapped_check(torch, ops, plain, fl, uu, lm, tl, f32)
        row(name, counts["panel_update_mapped"], err,
            lambda: ops.panel_update_mapped(fl, uu, lm, tl, f32=f32),
            lambda: plain.panel_update_mapped_plain(fl, uu, lm, tl, f32=f32),
            wk["bytes"], wk["flops"], kernel="panel_update_mapped",
            peak_ops=peak, plain_kw={"reps": 3})
        if name in on_paths:
            kern[-1]["launches_on_new_paths"] = {
                path: new_paths[path]["panel_update_mapped"]
                for path in on_paths[name]}
    # the same level over BATCH systems in one launch (the batched
    # default sweep's and the serving engine's form, float64): the
    # factored store repeated, random U rows per system; the bound is
    # BATCH times the one-system work
    u_len = work["u_entries"]
    flat_b = factor.store.flat.repeat(BATCH)
    u_b = torch.as_tensor(rng.standard_normal(BATCH * u_len), device=dev)
    kw_b = dict(systems=BATCH, flat_stride=factor.store.flat.numel(),
                u_stride=u_len)
    got_b, want_b = flat_b.clone(), flat_b.clone()
    ops.panel_update_mapped(got_b, u_b, lmap, tiles, **kw_b)
    plain.panel_update_mapped_plain(want_b, u_b, lmap, tiles, **kw_b)
    err = float((got_b - want_b).abs().max())
    del got_b, want_b
    row(f"panel_update_mapped ({BATCH} systems, float64)",
        counts_batched["panel_update_mapped"], err,
        lambda: ops.panel_update_mapped(flat_b, u_b, lmap, tiles, **kw_b),
        lambda: plain.panel_update_mapped_plain(flat_b, u_b, lmap, tiles,
                                                **kw_b),
        BATCH * work["bytes"], BATCH * work["flops"],
        kernel="panel_update_mapped", peak_ops=PEAK_F64_OPS_S,
        plain_kw={"reps": 1})
    kern[-1]["launches_on_new_paths"] = {
        "serve_lu": new_paths["serve_lu"]["panel_update_mapped"]}

    # K5 at the standing prefill shape (its row; the bound counts 3 TF32
    # products per float32 one on the tensor cores, the CUDA-core bound
    # beside it), the standing decode shape and the serve paths' grouped
    # shapes (bound by the unique bytes); scaled_dot_product_attention is
    # the library yardstick only, on the live heads with enable_gqa
    sdpa = torch.nn.functional.scaled_dot_product_attention
    shapes_line = {
        "phase": "kernel_shapes", "minmax_relax": [s, u, u],
        "ell_superstep": [s, v, k8],
        "column_fingerprints": [s, v], "panel_update": list(k3_shape),
        "panel_update_batched": [bsz, bm, bk, bn], **panel_line,
        "adj_nnz": nnz_adj,
        "flash_attention": list(K5_SHAPES["prefill"])}
    for tag in ("prefill", "decode"):
        shape = K5_SHAPES[tag]
        qkv = attn_inputs(torch, rng, *shape)
        err = float((ops.flash_attention(*qkv)
                     - plain.flash_attention_plain(*qkv)).abs().max())
        causal = shape[2] > 1       # S = 1 sees every key
        nbytes, flops = W.attn_work(*shape)
        fns = (lambda: ops.flash_attention(*qkv),
               lambda: plain.flash_attention_plain(*qkv))
        lib = lambda: sdpa(*qkv, is_causal=causal)
        if tag == "prefill":
            row("flash_attention", serve_res["launches"]["flash_attention"],
                err, *fns, nbytes, 3 * flops, lib, peak_ops=PEAK_TF32_S,
                plain_kw={"inner": 5})
            kern[-1]["launches_on_new_paths"] = {
                f"serve_{path}": serve_launches[path]["flash_attention"]
                for path in ("jamba", "gemma3", "whisper", "internvl")}
            shapes_line["flash_attention_bound_cuda_cores"] = dict(zip(
                ("bound_ms", "bound_by"), bound(nbytes, flops)))
        else:
            shapes_line["flash_attention_decode"] = {
                "shape": list(shape), "max_abs_err": err,
                **timing(*fns, nbytes, flops, lib, plain_kw={"inner": 5})}
    for tag, shape in K5_GQA_SHAPES.items():
        b_, h_, live, hkv, s_, t_alloc, kv_len, d_ = shape
        qg, kg, vg, kw = gqa_inputs(torch, rng, *shape)
        err = checks[f"K5_{tag}_err"]
        nbytes, flops = W.attn_work(b_, h_, s_, kv_len, d_, live, hkv)
        ks, vs = kg[:, :, :kv_len], vg[:, :, :kv_len]
        t = timing(lambda: ops.flash_attention(qg, kg, vg, **kw),
                   lambda: plain.flash_attention_plain(qg, kg, vg, **kw),
                   nbytes, 3 * flops if s_ > 1 else flops,
                   lambda: sdpa(qg[:, :live], ks, vs, is_causal=s_ > 1,
                                enable_gqa=True),
                   peak_ops=PEAK_TF32_S if s_ > 1 else PEAK_OPS_S,
                   plain_kw={"inner": 5})
        shapes_line[f"flash_attention_{tag}"] = {
            "shape": {"B": b_, "H": h_, "live_heads": live, "Hkv": hkv,
                      "S": s_, "T_alloc": t_alloc, "kv_len": kv_len,
                      "D": d_},
            "max_abs_err": err, **t}

    # K5 at gemma3-4b's serve shapes (D = 256): the windowed prefill (a
    # row of its own, its launches the gemma3 serve run's), the ring decode
    # and the global decode, their errors phase 2's; the bound counts the
    # (query, key) pairs and keys the window leaves; SDPA over the live
    # heads with enable_gqa, the band as a boolean mask, is the yardstick
    for tag in ("prefill_w1024", "decode_ring", "decode_global"):
        shape, window = K5_GEMMA3_SHAPES[tag]
        b_, h_, live, hkv, s_, t_alloc, kv_len, d_ = shape
        qg, kg, vg, kw = gqa_inputs(torch, rng, *shape, window=window)
        err = checks[f"K5_gemma3_{tag}_float32_err"]
        nbytes, flops = W.attn_work(b_, h_, s_, kv_len, d_, live, hkv, window)
        ks, vs = kg[:, :, :kv_len], vg[:, :, :kv_len]
        band = None
        if s_ > 1:
            ones = torch.ones((s_, kv_len), dtype=torch.bool, device=dev)
            band = ones.tril(kv_len - s_)
            if window:
                band &= ~ones.tril(kv_len - s_ - window)
        args = (lambda: ops.flash_attention(qg, kg, vg, **kw),
                lambda: plain.flash_attention_plain(qg, kg, vg, **kw),
                nbytes, 3 * flops if s_ > 1 else flops,
                lambda: sdpa(qg[:, :live], ks, vs, attn_mask=band,
                             enable_gqa=True))
        tkw = {"peak_ops": PEAK_TF32_S if s_ > 1 else PEAK_OPS_S,
               "plain_kw": {"inner": 5}}
        shapes_line[f"flash_attention_gemma3_{tag}"] = {
            "shape": {"B": b_, "H": h_, "live_heads": live, "Hkv": hkv,
                      "S": s_, "T_alloc": t_alloc, "kv_len": kv_len,
                      "D": d_, "window": window}, "max_abs_err": err}
        if tag == "prefill_w1024":
            row("flash_attention (gemma3-4b: D = 256, window 1024)",
                serve_launches["gemma3"]["flash_attention"], err, *args,
                kernel="flash_attention", **tkw)
        else:
            shapes_line[f"flash_attention_gemma3_{tag}"].update(
                timing(*args, **tkw))
        del qg, kg, vg, ks, vs, band

    # K5 at whisper's and internvl's serve shapes, their errors phase 2's:
    # whisper's encoder and internvl's prefill as rows of their own (their
    # launches the serve runs'), the rest in the kernel_shapes line; SDPA
    # over the live heads with enable_gqa, causal as the row, is the
    # yardstick
    for tag, (shape, causal) in K5_SERVE_SHAPES.items():
        b_, h_, live, hkv, s_, t_alloc, kv_len, d_ = shape
        qg, kg, vg, kw = gqa_inputs(torch, rng, *shape, causal=causal)
        err = checks[f"K5_{tag}_err"]
        nbytes, flops = W.attn_work(b_, h_, s_, kv_len, d_, live, hkv,
                                    causal=causal)
        ks, vs = kg[:, :, :kv_len], vg[:, :, :kv_len]
        args = (lambda: ops.flash_attention(qg, kg, vg, **kw),
                lambda: plain.flash_attention_plain(qg, kg, vg, **kw),
                nbytes, 3 * flops if s_ > 1 else flops,
                lambda: sdpa(qg[:, :live], ks, vs, is_causal=causal and s_ > 1,
                             enable_gqa=True))
        tkw = {"peak_ops": PEAK_TF32_S if s_ > 1 else PEAK_OPS_S,
               "plain_kw": {"inner": 5}}
        shapes_line[f"flash_attention_{tag}"] = {
            "shape": {"B": b_, "H": h_, "live_heads": live, "Hkv": hkv,
                      "S": s_, "T_alloc": t_alloc, "kv_len": kv_len,
                      "D": d_, "causal": causal}, "max_abs_err": err}
        if tag in ("whisper_encoder", "internvl_prefill"):
            model = tag.split("_")[0]
            row(f"flash_attention ({tag.replace('_', ' ')}: "
                f"{'causal' if causal else 'non-causal'}, S = {s_}, "
                f"D = {d_}, {live} q / {hkv} KV heads)",
                serve_launches[model]["flash_attention"], err, *args,
                kernel="flash_attention", **tkw)
        else:
            shapes_line[f"flash_attention_{tag}"].update(timing(*args, **tkw))
        del qg, kg, vg, ks, vs

    k5_train_rows(torch, ops, plain, checks, train_res, row, shapes_line)

    # K6 and K7 from a zero state at their serve paths' prefill shapes
    # (their rows) and from a non-zero state at the decode shapes, their
    # errors those of phase 2 at the same shapes and states; no one
    # PyTorch call computes either scan (library_ms null)
    for name, key, path, shapes, inputs, work, fn, ref in (
            ("mamba_scan", "K6", "jamba", K6_SHAPES, mamba_inputs,
             W.mamba_work, ops.mamba_scan, plain.mamba_scan_plain),
            ("rwkv6_scan", "K7", "rwkv6", K7_SHAPES, rwkv6_inputs,
             W.rwkv6_work, ops.rwkv6_scan, plain.rwkv6_scan_plain)):
        for tag, state in (("prefill", "zero"), ("decode", "state")):
            shape = shapes[tag]
            args = inputs(torch, rng, *shape, zero_state=state == "zero")
            err = checks[f"{key}_{tag}_{state}_err"]
            nbytes, nops, *sfu = work(*shape)
            t = (lambda: fn(*args), lambda: ref(*args), nbytes, nops)
            kw = {"sfu_ops": sfu[0] if sfu else 0, "plain_kw": {"reps": 3}}
            if tag == "prefill":
                shapes_line[name] = list(shape)
                row(name, serve_launches[path][name], err, *t, **kw)
            else:
                shapes_line[f"{name}_decode"] = {
                    "shape": list(shape), "max_abs_err": err,
                    **timing(*t, **kw)}
    # K6's and K7's backwards at their train phases' shapes, from a zero
    # state with normal upstream gradients, their errors phase 2's (the
    # larger of the zero and non-zero state); their launches the train
    # phases'; no one PyTorch call computes a scan's gradient
    for name, key, path, kind, work, fn, ref in (
            ("mamba_scan_backward", "K6_bwd", "jamba", "mamba",
             W.mamba_bwd_work, ops.mamba_scan_backward,
             plain.mamba_scan_backward_plain),
            ("rwkv6_scan_backward", "K7_bwd", "rwkv6", "rwkv6",
             W.rwkv6_bwd_work, ops.rwkv6_scan_backward,
             plain.rwkv6_scan_backward_plain)):
        shape = (K6_SHAPES if kind == "mamba" else K7_SHAPES)["prefill"]
        args = scan_bwd_inputs(torch, kind, shape, zero_state=True, seed=3)
        shapes_line[name] = list(shape)
        if kind == "mamba":
            nbytes, nops, sfu = work(*shape)
            kw = {"sfu_ops": sfu}
        else:  # the chunked form's products are 3xTF32 on the tensor cores
            nbytes, nops, alu = work(*shape)
            kw = {"peak_ops": PEAK_TF32_S, "alu_ops": alu}
            shapes_line[name] = {
                "shape": list(shape),
                "bound_step_by_step_cuda_cores": dict(zip(
                    ("bound_ms", "bound_by"),
                    bound(*W.rwkv6_bwd_step_work(*shape))))}
        row(name, train_res[path]["launches"][name],
            checks[f"{key}_max_abs_err"], lambda: fn(*args),
            lambda: ref(*args), nbytes, nops, plain_kw={"reps": 1},
            device_n=10, **kw)
        del args
    emit(shapes_line)
    emit({"kernels": kern})

    check("jax" not in sys.modules and "repro" not in sys.modules,
          "the JAX package was imported")
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
