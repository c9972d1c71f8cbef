"""A dry run's planned memory against the card's, op by op, for one train
step or one serve run.

    python tools/dryrun_vs_card.py --arch smollm-135m whisper-tiny \\
        --reduced --batch 2 --seq 128 [--out chiprun_out/dryrun_vs_card.json]
    python tools/dryrun_vs_card.py --arch smollm-135m --batch 8 \\
        --seq 512 --serve 32

Runs the step (or the serve run: a prefill of ``--seq`` and ``--serve`` -
1 decode steps) under ``launch/costs.py::Trace`` on ``meta`` (the plan)
and on the card (after a first run, which makes the libraries'
workspaces).
On the card it reads the caching allocator's peak of allocated bytes
(blocks, as ``max_memory_allocated``) and of requested bytes (the sizes
asked for, before the allocator rounds them or hands out a larger cached
block whole), and each op reads the peak of
``max_memory_allocated`` during the op and ``memory_allocated`` after it,
both above what was allocated before the step.  Prints the plan's and the
card's peaks, what the first run left allocated, where the two op
sequences first part, and the ops where the allocator's peak passes the
trace's live bytes (and the op's charged temporary) by the most: what the
trace does not see.  With ``--modes`` it
prints instead the step's peak on the card under no dispatch mode, under
one that only runs each op, and under ``Trace``: whether the trace itself
changes what the card holds (an op it runs through its decomposition
where the card runs the op's own kernel).  Needs a card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.base import ShapeConfig, get_config  # noqa: E402
from repro_torch.data import make_batch_for  # noqa: E402
from repro_torch.launch import costs as C  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.train import device_batch  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.train.optimizer import init_adamw  # noqa: E402
from repro_torch.train.steps import (  # noqa: E402
    make_decode_step, make_prefill_step, make_train_step,
)


class _Rows(C.Trace):
    """A ``Trace`` that keeps a row per op: [op, live bytes above the base
    after it, the temporary it was charged], and on the card [..., the
    allocator's peak during the op, its bytes after it], above ``held``."""

    def __init__(self, base=(), held=None):
        super().__init__(base)
        self.held, self.rows = held, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        card = self.held is not None
        if card:
            torch.cuda.reset_peak_memory_stats()
        out = super().__torch_dispatch__(func, types, args, kwargs)
        self._purge()
        kind = C._KINDS.get(func)
        hidden = (C._alloc(C._nbytes(C._flat(args)[0]))
                  if kind is not None and kind.hidden else 0)
        row = [str(func), self.live_bytes - self.base_bytes, hidden]
        if card:
            row += [torch.cuda.max_memory_allocated() - self.held,
                    torch.cuda.memory_allocated() - self.held]
        self.rows.append(row)
        return out


def _step(cfg, shape, dev, gen=None):
    """(state, run) of a train step, or with ``gen`` of a serve run: a
    prefill of ``shape`` and ``gen - 1`` greedy decode steps against
    caches of ``seq_len + gen`` slots (``launch/dryrun.py``'s)."""
    params = tf.init_params(cfg, device=dev)
    if gen is None:
        opt = init_adamw(params)
        batch = device_batch(make_batch_for(cfg, shape), torch.float32, dev)
        step = make_train_step(cfg, micro_steps=1)
        return (params, opt, batch), lambda: step(params, opt, batch)
    batch = dryrun.meta_batch(cfg, shape.global_batch, shape.seq_len,
                              train=False)
    batch = {k: (torch.zeros(v.shape, dtype=v.dtype, device=dev))
             for k, v in batch.items()}
    prefill = make_prefill_step(cfg, cache_len=shape.seq_len + gen)
    decode = make_decode_step(cfg)

    def run():
        tok, caches, _ = prefill(params, batch)
        for _ in range(gen - 1):
            tok, caches, _ = decode(params, caches, tok[:, None])
    return (params, batch), run


def compare(cfg, shape, gen=None) -> dict:
    state, run = _step(cfg, shape, torch.device("meta"), gen)
    with _Rows(state) as plan:
        run()
    state, run = _step(cfg, shape, torch.device("cuda"), gen)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    run()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    asked = torch.cuda.memory_stats()["requested_bytes.all.current"]
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - held
    requested = torch.cuda.memory_stats()["requested_bytes.all.peak"] - asked
    with _Rows(state, held) as card:
        run()
        torch.cuda.synchronize()
    names = [r[0] for r in plan.rows], [r[0] for r in card.rows]
    part = next((i for i, (a, b) in enumerate(zip(*names)) if a != b),
                None if len(names[0]) == len(names[1])
                else min(map(len, names)))
    unseen = sorted(((r[3] - r[1] - r[2], i, r) for i, r in
                     enumerate(card.rows)), reverse=True)[:12]
    probed = max(r[3] for r in card.rows)
    return {"plan_peak": plan.peak_bytes - plan.base_bytes,
            "card_trace_peak": card.peak_bytes - card.base_bytes,
            "card_measured": measured, "card_requested": requested,
            "card_probed": probed,
            "first_run_left": held - before,
            "ops": [len(n) for n in names], "first_difference": part,
            "around_difference": None if part is None else
            [plan.rows[max(part - 2, 0):part + 3],
             card.rows[max(part - 2, 0):part + 3]],
            "unseen": unseen,
            "plan_peak_ops": [(i, r) for i, r in enumerate(plan.rows)
                              if r[1] + r[2] == plan.peak_bytes
                              - plan.base_bytes][:3],
            "card_peak_ops": [(i, r) for i, r in enumerate(card.rows)
                              if r[3] == probed][:3],
            "device": torch.cuda.get_device_name(0)}


class _Bare(TorchDispatchMode):
    """A dispatch mode that only runs each op."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


def _peak(run, mode) -> int:
    """The peak of ``run()`` under ``mode`` (or none) above the bytes
    allocated before it."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with mode if mode is not None else contextlib.nullcontext():
        run()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - held


def modes(cfg, shape) -> dict:
    """The step's peak on the card with no dispatch mode, under one that
    only runs each op, and under ``Trace``: whether tracing changes what
    the card holds."""
    state, run = _step(cfg, shape, torch.device("cuda"))
    run()
    return {"none": _peak(run, None), "bare_mode": _peak(run, _Bare()),
            "trace": _peak(run, C.Trace(state))}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=["smollm-135m"])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--modes", action="store_true",
                    help="the peak with no mode, a bare mode and Trace")
    ap.add_argument("--serve", type=int, metavar="GEN",
                    help="a serve run of GEN tokens instead of a train step")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    shape = ShapeConfig("s", args.seq, args.batch,
                        "prefill" if args.serve else "train")
    out = {}
    for arch in args.arch:
        cfg = get_config(arch)
        if args.modes:
            out[arch] = rec = modes(cfg.reduced() if args.reduced else cfg,
                                    shape)
            print(arch, json.dumps(rec))
            continue
        out[arch] = rec = compare(cfg.reduced() if args.reduced else cfg,
                                  shape, args.serve)
        print(arch, json.dumps({k: v for k, v in rec.items()
                                if k not in ("unseen",)}))
        for diff, i, row in rec["unseen"]:
            print(f"  unseen {diff:>9} at op {i}: {row}")
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
