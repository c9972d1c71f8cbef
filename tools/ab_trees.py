#!/usr/bin/env python3
"""One end-to-end sample of a checkout of the port, for comparing two
commits on one card in one call.

    git archive <parent> | tar -x -C build/parent      # build/ is ignored
    for t in build/parent . . build/parent; do
        python3 tools/ab_trees.py $t [serve] [analyze] [lu] [batched]; done

Imports ``repro_torch`` (and, for ``serve``, ``chip_smoke``) from the tree
given and runs the sections named (the first three by default), each
after a warm-up:

* ``serve`` — smollm-135m serving 8 x 512 prompt + 32 greedy tokens three
  times (``chip_smoke.serve_run``; median prefill ms and ms per decode
  step), its prefill and one decode step under ``torch.profiler``
  (``chip_smoke.breakdown_serve``: wall, device busy, idle share, device
  calls, top kernels), the host time to enqueue one layer's decode
  attention;
* ``analyze`` — bbd-20k's ``analyze`` under kernel options three times
  (wall s);
* ``lu`` — bbd-20k under default and kernel options: the plan's first
  factorize, three more factorizations and three refactorizations (wall
  s, each ending in a synchronize), the sha256 of ``store.flat`` after
  each (one value when they agree), and one more refactorization under
  ``torch.profiler`` (wall ms, device busy ms, device calls), through the
  public API only, so it runs on earlier trees too;
* ``batched`` — bbd-20k under default options with 8 value sets
  (``generic_values_csr`` seeds 0..7), the batched tier against its
  sequential loop in turns: three times the 8 ``factorize`` calls and one
  ``factorize_batch`` (wall s each), then three times the 8 (n,) solves
  on those factors and one ``solve_batch`` (wall s each), and each of
  the four once more under ``torch.profiler`` (wall ms, device busy ms,
  device calls); only for trees that have ``factorize_batch``.

Prints one JSON line, then the card's name and power limit.  Run the trees
in turns (parent, change, change, parent): host-bound stages move between
calls and within one.
"""
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def decode_attention_host_us(torch, cfg, params, n=300):
    """Host microseconds to enqueue one decode step of layer 0's attention
    (projections, rope, cache write, K5, output projection) for 8 requests
    at cache slot 512, the median of 5 runs of ``n`` calls with no
    synchronisation inside a run."""
    from repro_torch.models import attention as attn

    mixer = params["groups"][0]["l0"]["mixer"]
    cache = attn.init_gqa_cache(cfg, 8, 544, device="cuda")
    cache["idx"] = 512
    x = torch.randn(8, 1, cfg.d_model, device="cuda")
    runs = []
    with torch.inference_mode():
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                attn.gqa_decode(mixer, x, dict(cache), cfg)
            runs.append((time.perf_counter() - t0) / n * 1e6)
            torch.cuda.synchronize()
    return statistics.median(runs[1:])


def lu_times(torch, repro_torch, a, opts) -> dict:
    """bbd-20k's factorize / refactorize wall times under ``opts`` and the
    factors' sha256."""
    from repro_torch.sparse.numeric import generic_values_csr

    values = generic_values_csr(a)
    digests = set()

    def timed(fn):
        t0 = time.perf_counter()
        factor = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        digests.add(hashlib.sha256(
            factor.store.flat.cpu().numpy().tobytes()).hexdigest())
        return factor, dt

    plan = repro_torch.analyze(a, opts)
    factor, first = timed(lambda: plan.factorize(values))
    out = {"first_factorize_s": first, "factorize_s": [],
           "refactorize_s": []}
    for _ in range(3):
        factor, dt = timed(lambda: plan.factorize(values))
        out["factorize_s"].append(dt)
    for _ in range(3):
        factor, dt = timed(lambda: factor.refactorize(values))
        out["refactorize_s"].append(dt)
    out["flat_sha256"] = sorted(digests)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        factor, dt = timed(lambda: factor.refactorize(values))
    evs = [ev for ev in prof.key_averages()
           if ev.device_type == DeviceType.CUDA
           and not getattr(ev, "is_user_annotation", False)]
    out["profiled_refactorize"] = {
        "wall_ms": dt * 1e3,
        "device_busy_ms": sum(ev.device_time_total for ev in evs) / 1e3,
        "device_calls": sum(ev.count for ev in evs)}
    return out


def profiled(torch, fn) -> dict:
    """Wall ms, device busy ms and device calls of ``fn`` under
    torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    evs = [ev for ev in prof.key_averages()
           if ev.device_type == DeviceType.CUDA
           and not getattr(ev, "is_user_annotation", False)]
    return {"wall_ms": wall,
            "device_busy_ms": sum(ev.device_time_total for ev in evs) / 1e3,
            "device_calls": sum(ev.count for ev in evs)}


def batched_times(torch, repro_torch, a) -> dict:
    """The ``batched`` section (module docstring)."""
    import numpy as np
    from repro_torch.sparse.numeric import generic_values_csr

    plan = repro_torch.analyze(a, repro_torch.LUOptions(concurrency=512))
    vb = np.stack([generic_values_csr(a, seed=s) for s in range(8)])
    rhs = np.random.default_rng(5).standard_normal((8, a.n))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, time.perf_counter() - t0

    def sequential():
        return [plan.factorize(v) for v in vb]

    def batched():
        return plan.factorize_batch(vb)

    factors, batch = sequential(), batched()        # warm-up

    def seq_solves():
        return [f.solve(b) for f, b in zip(factors, rhs)]

    def batch_solve():
        return batch.solve_batch(rhs)

    seq_solves(), batch_solve()
    out = {"factorize_seq_s": [], "factorize_batch_s": [],
           "solve_seq_s": [], "solve_batch_s": []}
    for _ in range(3):
        for key, fn in (("factorize_seq_s", sequential),
                        ("factorize_batch_s", batched)):
            out[key].append(timed(fn)[1])
    for _ in range(3):
        for key, fn in (("solve_seq_s", seq_solves),
                        ("solve_batch_s", batch_solve)):
            out[key].append(timed(fn)[1])
    for key, fn in (("factorize_seq", sequential),
                    ("factorize_batch", batched),
                    ("solve_seq", seq_solves), ("solve_batch", batch_solve)):
        out[f"profiled_{key}"] = profiled(torch, fn)
    return out


def main(tree: str, sections=("serve", "analyze", "lu")) -> int:
    tree = str(Path(tree).resolve())
    sys.path[:0] = [tree + "/src", tree]
    import torch

    if not torch.cuda.is_available():
        print("ab_trees: needs a CUDA card", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch import sparse
    from repro_torch.kernels import _build

    _build.build()
    out = {"tree": tree}
    a = sparse.bordered_block_diagonal(20_000, block=16, border=64, seed=3)
    kopts = repro_torch.LUOptions(concurrency=512, backend="kernel",
                                  numeric_backend="kernel")
    if "lu" in sections:
        for tag, opts in (("default", repro_torch.LUOptions(
                concurrency=512)), ("kernel", kopts)):
            out[f"lu_{tag}"] = lu_times(torch, repro_torch, a, opts)
    if "batched" in sections:
        out["batched"] = batched_times(torch, repro_torch, a)
    if "serve" in sections:
        out.update(serve_sample(torch))
    if "analyze" in sections:
        repro_torch.analyze(a, kopts)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            repro_torch.analyze(a, kopts)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out["kernel_analyze_s"] = times
    print(json.dumps(out), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


def serve_sample(torch) -> dict:
    """The ``serve`` section (module docstring)."""
    import chip_smoke
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops

    out = {}
    cfg = get_config("smollm-135m")
    runs = []
    for _ in range(3):
        params, line = chip_smoke.serve_run(torch, ops, cfg)
        runs.append((line["prefill_ms"], line["decode_ms_per_step"]))
    out["serve_prefill_ms"] = statistics.median(r[0] for r in runs)
    out["serve_decode_ms_per_step"] = statistics.median(r[1] for r in runs)
    out["serve_runs"] = runs
    bd = chip_smoke.breakdown_serve(torch, cfg, params)
    out["decode_attention_host_us"] = decode_attention_host_us(torch, cfg,
                                                              params)
    out["breakdown"] = {
        stage: {k: v[k] for k in ("wall_ms", "device_busy_ms", "idle_share",
                                  "device_calls", "top")}
        for stage, v in bd.items()}
    del params
    return out


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], tuple(sys.argv[2:]) or ("serve", "analyze",
                                                      "lu")))
