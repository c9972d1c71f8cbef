"""The control and the planted faults of the comparison that decides
``correct``, read at a cell's own size::

    python3 portbench/control.py --workload hpcg-32x32x24.ell --seeds 11 12 13

For each seed it analyzes the first pattern a run of that seed would time
(the program as configured, and once under each of the breaks below),
compares each result with the plain reference and prints the counts; the
whole table also goes to ``.portbench/control_<workload>.json``.  The
benchmark's own runs never run this.

* ``relaxed`` (the control): the program's own relaxed-supernode path
  (``supernode_relax=1``, the T3 merge), which breaks the exact T2
  partition the configuration states: the step a later change would be
  tempted to take for wider panels.
* ``stale``: a step that returns its state unchanged: every analysis after
  the first hands back the first one's plan.
* ``half``: half of the batch left out: every other source chunk of the
  fixpoint is left unrelaxed, its rows keeping only their own entries.
* ``altered``: an answer altered where it is produced: each plan's pattern
  loses one entry.

The exchange between chips has no counterpart: every cell takes one card.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def _patched(owner, name, replacement):
    original = getattr(owner, name)
    setattr(owner, name, replacement(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def relaxed(rt):
    def wrap(analyze):
        def call(a, options=None, **kw):
            return analyze(a, options.replace(supernode_relax=1), **kw)
        return call
    return _patched(rt, "analyze", wrap)


def stale(rt):
    def wrap(analyze):
        first = []

        def call(a, options=None, **kw):
            if not first:
                first.append(analyze(a, options, **kw))
            return first[0]
        return call
    return _patched(rt, "analyze", wrap)


def half(rt):
    from repro_torch.core import gsofa

    def wrap(batch):
        calls = [0]

        def call(graph, srcs, **kw):
            calls[0] += 1
            if calls[0] % 2 == 0:
                kw["max_iters"] = 0
            return batch(graph, srcs, **kw)
        return call
    return _patched(gsofa, "gsofa_batch", wrap)


def altered(rt):
    def wrap(analyze):
        def call(a, options=None, **kw):
            plan = analyze(a, options, **kw)
            pat = plan.pattern
            counts = pat.indptr[1:] - pat.indptr[:-1]
            j = int(counts.argmax())            # its last row lies off the
            drop = int(pat.indptr[j + 1]) - 1   # diagonal (rows ascend)
            indptr = pat.indptr.copy()
            indptr[j + 1:] -= 1
            plan.pattern = dataclasses.replace(
                pat, indptr=indptr, rowind=np.delete(pat.rowind, drop))
            return plan
        return call
    return _patched(rt, "analyze", wrap)


FAULTS = {"relaxed": relaxed, "stale": stale, "half": half,
          "altered": altered}


def readings(rt, cfg: dict, mix: dict, seed: int, kind: str,
             device: str = "cuda") -> dict:
    """The comparison's counts for the first timed pattern of ``seed``
    (``kind``: ``sound`` or a key of ``FAULTS``)."""
    from portbench import compare
    from portbench.drivers.analyze_stream import extract, pattern_maker
    from portbench.reference import structure as reference

    opts = rt.LUOptions(**cfg["options"], **mix["options"])
    pattern = pattern_maker(cfg, seed)
    a = pattern(1)
    with (FAULTS[kind](rt) if kind != "sound" else contextlib.nullcontext()):
        if kind == "stale":
            rt.analyze(pattern(0), opts, device=device)
        prog = extract(rt.analyze(a, opts, device=device))
    ref = reference.analysis(
        a.n, a.indptr, a.indices,
        max_size=cfg["options"].get("supernode_max_size", 64))
    return compare.mismatches(a.n, prog, ref)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--kinds", nargs="+",
                   default=["sound", "relaxed", "stale", "half", "altered"])
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    if not torch.cuda.is_available():
        sys.exit("portbench: no CUDA card; the control is read on the card")
    import repro_torch

    from portbench import layout

    bench = layout.benchmark()
    cell = layout.workload(bench, args.workload)
    cfg, mix = layout.config(bench, cell["config"]), layout.traffic(
        cell["traffic"])
    table = []
    for seed in args.seeds:
        for kind in args.kinds:
            t = time.perf_counter()
            counts = readings(repro_torch, cfg, mix, seed, kind)
            torch.cuda.empty_cache()
            row = {"seed": seed, "kind": kind, **counts,
                   "seconds": time.perf_counter() - t}
            table.append(row)
            print(json.dumps(row), flush=True)
    out = ROOT / ".portbench"
    out.mkdir(exist_ok=True)
    (out / f"control_{args.workload}.json").write_text(
        json.dumps({"card": torch.cuda.get_device_name(0), "rows": table},
                   indent=1))


if __name__ == "__main__":
    main()
