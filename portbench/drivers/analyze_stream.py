"""A stream of fresh patterns through ``repro_torch.analyze``, one at a time.

Set-up: one warm-up analysis at the cell's own shape (it loads, or in a
fresh checkout builds, the kernels and grows the allocator).  Window: whole
analyses back to back, each on a pattern not analyzed before in this run
and each ending in ``torch.cuda.synchronize()``, until ``--seconds`` have
passed.  Each pattern is drawn from the seed just before its analysis,
with the clock stopped, so ``analyze_s`` is the time inside the analyses
over the analyses completed, whatever the program's speed.  After the
window every analysis it ran is compared with the plain reference.

With ``--trace 1`` the window's analyses run with ``LUOptions(trace=True)``
and its first one under ``torch.profiler`` (device activities only).  The
driver hands the per-layer metrics' readers what the program and the
profiler recorded, as they recorded it (``obs``):

* ``analyses``: per traced analysis, its input (``input``, the
  ``CSRMatrix``), the program's span tree (``stats``, ``plan.stats``) and
  symbolic result (``sym``, ``plan.sym``);
* ``profile``: of the first one, the device activities (``events``:
  (name, start_ns, end_ns)), the program's host spans on the same clock
  (``spans``: (name, start_ns, end_ns, depth)), its counters and
  histograms (``counters``: ``{"counters": {...}, "histograms": {name:
  [values]}}``), its wall (``wall_s``) and the allocator's peak
  (``peak_bytes``).

A new per-layer metric is a reader of these: nothing here changes for it.
Each analysis's wall, page faults, garbage collections and CPU time go to
standard error, so that the spread of ``analyze_s`` can be traced to its
cause.
"""
from __future__ import annotations

import gc
import resource
import time

import numpy as np

from portbench import compare, devtrace, layout
from portbench.reference import structure as reference


def pattern_seed(seed: int, index: int) -> int:
    """The generator seed of the run's ``index``-th pattern (0: warm-up)."""
    ss = np.random.SeedSequence([seed % 2**64, index])
    return int(ss.generate_state(1, np.uint32)[0])


def pattern_maker(cfg: dict, seed: int):
    """``index -> CSRMatrix``: the run's ``index``-th pattern, as the
    program receives it."""
    from repro_torch.sparse.csr import CSRMatrix

    gen = layout.module("generators", cfg["generator"])

    def pattern(index):
        n, indptr, indices = gen.generate(pattern_seed(seed, index),
                                          **cfg["params"])
        return CSRMatrix(n=n, indptr=indptr, indices=indices)
    return pattern


def extract(plan) -> dict:
    """What the comparison needs of a plan (its arrays, not copies)."""
    return {"indptr": plan.pattern.indptr, "rowind": plan.pattern.rowind,
            "supernodes": plan.schedule.supernodes,
            "level": plan.schedule.level}


def _host_load():
    """(minor faults, major faults, collections, user s, system s) of this
    process so far."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return (ru.ru_minflt, ru.ru_majflt,
            sum(g["collections"] for g in gc.get_stats()),
            ru.ru_utime, ru.ru_stime)


def run(ctx) -> dict:
    torch, rt = ctx.torch, ctx.program
    pattern = pattern_maker(ctx.cfg, ctx.args.seed)
    opts = rt.LUOptions(**ctx.cfg["options"], **ctx.mix["options"])
    if ctx.args.trace:
        opts = opts.replace(trace=True)
    on_card = ctx.device != "cpu"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def analyze(a):
        plan = rt.analyze(a, opts, device=ctx.device)
        sync()
        return plan

    # -- set-up
    t = time.perf_counter()
    analyze(pattern(0))
    ctx.log(f"set-up: warm-up analysis {time.perf_counter() - t:.3f} s")

    # -- window
    done, failed, obs, walls = [], 0, {"analyses": []}, []
    t_window = time.perf_counter()
    setup_s = t_window - ctx.t_start
    while time.perf_counter() - t_window < ctx.args.seconds:
        a = pattern(len(done) + 1)
        load = _host_load()
        t = time.perf_counter()
        try:
            if ctx.args.trace and not done:
                plan = _profiled(ctx, a, analyze, obs)
            else:
                plan = analyze(a)
        except Exception as exc:            # the window's failure is reported
            failed += 1
            ctx.log(f"analysis {len(done)} failed: {exc!r}")
            break
        walls.append(time.perf_counter() - t)
        moved = [y - x for x, y in zip(load, _host_load())]
        ctx.log(f"analysis {len(done)}: {walls[-1]:.3f} s, minor faults "
                f"{moved[0]}, major {moved[1]}, collections {moved[2]}, "
                f"user {moved[3]:.3f} s, system {moved[4]:.3f} s")
        done.append((a, extract(plan)))
        if ctx.args.trace:
            obs["analyses"].append({"input": a, "stats": plan.stats,
                                    "sym": plan.sym})
        del plan
    ctx.log(f"window: {len(done)} analyses in "
            f"{time.perf_counter() - t_window:.3f} s")
    attempted = len(done) + failed
    peak = (max(torch.cuda.max_memory_allocated(),
                obs.get("profile", {}).get("peak_before", 0))
            if on_card else 0)
    if on_card:
        torch.cuda.empty_cache()

    # -- the comparison with the plain reference, every analysis
    counts = []
    t = time.perf_counter()
    for a, prog in done:
        ref = reference.analysis(
            a.n, a.indptr, a.indices,
            max_size=ctx.cfg["options"].get("supernode_max_size", 64))
        counts.append(compare.mismatches(a.n, prog, ref))
    ctx.log(f"reference: {len(done)} analyses in "
            f"{time.perf_counter() - t:.3f} s")
    return {"attempted": attempted, "failed": failed, "compared": len(done),
            "checks": compare.total(counts), "memory_peak_bytes": peak,
            "e2e": {"analyze_s": sum(walls) / max(1, len(done)),
                    "setup_s": setup_s},
            "obs": obs}


def _profiled(ctx, a, analyze, obs):
    """One analysis under the profiler, with the program's spans and
    counters on; records ``obs["profile"]`` and the run's breakdown."""
    torch = ctx.torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import metrics as om
    from repro_torch.obs import trace as ot

    om.registry().reset()
    tracer = ot.enable()
    on_card = ctx.device != "cpu"
    peak_before = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    marker = torch.zeros(1, device=ctx.device)
    if on_card:
        torch.cuda.synchronize()
    try:
        # on the CPU (the harness's own tests) the profiler records host
        # activities and the device events stay empty
        with profile(activities=[ProfilerActivity.CUDA if on_card
                                 else ProfilerActivity.CPU]) as prof:
            t0 = time.perf_counter()
            marker.fill_(1.0)       # the first device event: clock alignment
            plan = analyze(a)
            t1 = time.perf_counter()
    finally:
        ot.disable()
    reg = om.registry()
    counters = {"counters": dict(reg.counters), "gauges": dict(reg.gauges),
                "histograms": {k: (list(h.values) if len(h.values) == h.count
                                   else None)
                               for k, h in reg.histograms.items()}}
    events = devtrace.device_events(prof) if on_card else []
    # host perf_counter ns -> the device events' clock, by the marker
    shift = events[0][1] - int(t0 * 1e9) if events else 0
    lo, hi = int(t0 * 1e9) + shift, int(t1 * 1e9) + shift
    spans = [(ev.name, int((tracer.epoch + ev.start) * 1e9) + shift,
              int((tracer.epoch + ev.start + ev.dur) * 1e9) + shift,
              ev.depth) for ev in tracer.events]
    events = events[1:]
    obs["profile"] = {
        "events": events, "spans": spans, "counters": counters,
        "wall_s": t1 - t0, "busy_s": devtrace.busy_seconds(events),
        "peak_bytes": (torch.cuda.max_memory_allocated() if on_card
                       else None),
        "peak_before": peak_before}
    obs["breakdown"] = {"device_ops": devtrace.top_ops(events),
                        "idle_gaps": devtrace.idle_gaps(events, lo, hi,
                                                        spans)}
    return plan
