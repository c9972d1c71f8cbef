"""Analyze-time knob selection from retained column fingerprints.

``autotune_partition`` sweeps a small grid of ``supernode_relax`` /
``supernode_max_size`` candidates — each re-detected from the O(n)
:class:`~repro_torch.supernodes.fingerprint.ColumnFingerprints` the symbolic
fixpoint already produced, so no fixpoint re-run — runs every candidate
through the structure-aware blocking merge pass, scores the resulting
partitions with the roofline cost model, and returns the winner plus a
picklable :class:`TuneReport`.  ``analyze(LUOptions(autotune=True))``
freezes the chosen knob values onto the plan's options, so tuning cost
amortizes with the rest of the symbolic work and a pickled plan replays
bitwise without re-tuning.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.obs import metrics as _om
from repro_torch.obs import trace as _ot
from repro_torch.supernodes.blocking import merge_supernodes, partition_stats
from repro_torch.supernodes.detect import detect_from_fingerprints
from repro_torch.tune.model import RooflineCostModel, cost_model_for

# Candidate grids.  Small on purpose: detection from fingerprints is O(n)
# and the merge pass O(nnz), so the sweep costs a few percent of analyze,
# but the grid still brackets the regimes that matter (exact T2 partitions,
# mild/aggressive T3 relaxation, panel width caps around the GEMM
# sweet spot).  The options' own values are always included so autotune
# can only match or beat the hand-set configuration under the model.
RELAX_GRID = (0, 1, 2, 4)
MAX_SIZE_GRID = (32, 64, 128)

# Byte budget for the fixpoint's (concurrency, n) int32 label matrix when
# choosing ``concurrency``; keeps the working set cache-friendly without
# starving the fixpoint of sources per superstep.
_LABEL_BYTES_BUDGET = 64 << 20
_MIN_CONCURRENCY = 64
_MAX_CONCURRENCY = 1024


@dataclasses.dataclass(frozen=True)
class TuneReport:
    """Picklable record of one autotune sweep (``LUPlan.tuned``)."""

    chosen: dict
    modeled_s: float
    baseline_s: float
    n_panels: int
    candidates: Tuple[dict, ...]


def choose_concurrency(n: int, *, budget_bytes: Optional[int] = None) -> int:
    """Power-of-two source-chunk width for an n-column matrix.

    Sized so the fixpoint's ``(concurrency, n)`` int32 label matrix fits
    ``budget_bytes`` (default 64 MiB), clamped to [64, 1024] and never more
    than ``n``.  Deterministic — pure arithmetic in ``n``.
    """
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    budget = _LABEL_BYTES_BUDGET if budget_bytes is None else budget_bytes
    c = max(1, budget // max(1, 4 * n))
    c = 1 << (int(c).bit_length() - 1)  # round down to a power of two
    c = max(_MIN_CONCURRENCY, min(_MAX_CONCURRENCY, c))
    return min(c, max(1, n))


def autotune_partition(pattern, fingerprints, options, *,
                       peaks: Optional[dict] = None,
                       model: Optional[RooflineCostModel] = None,
                       ) -> Tuple[np.ndarray, TuneReport]:
    """Pick the best (relax, max_size, merge) partition under the model.

    Returns ``(supernodes, report)`` where ``supernodes`` is the winning
    merged partition and ``report.chosen`` maps ``LUOptions`` field names to
    the frozen values (``supernode_relax``, ``supernode_max_size``,
    ``blocking``, ``block_merge_threshold``, ``block_max_width``,
    ``concurrency``).  The baseline score is the options' own
    (relax, max_size) partition *without* merging — what the pipeline would
    have run untuned.
    """
    if fingerprints is None:
        raise ValueError(
            "autotune requires the symbolic result to retain column "
            "fingerprints (SymbolicResult.fingerprints); re-run analyze()")
    if model is None:
        model = cost_model_for(options, peaks)
    threshold = (1.0 if options.block_merge_threshold is None
                 else float(options.block_merge_threshold))
    max_width = int(options.block_max_width)
    with _ot.span("autotune"):
        base = detect_from_fingerprints(
            fingerprints, relax=options.supernode_relax,
            max_size=options.supernode_max_size)
        bstats = partition_stats(pattern, base)
        baseline_s = model.partition_time(bstats["m"], bstats["k"],
                                          bstats["w"])

        relaxes = sorted(set(RELAX_GRID) | {int(options.supernode_relax)})
        max_sizes = sorted(set(MAX_SIZE_GRID)
                           | {int(options.supernode_max_size)})
        best = None
        candidates = []
        for relax in relaxes:
            for max_size in max_sizes:
                ranges = detect_from_fingerprints(fingerprints, relax=relax,
                                                  max_size=max_size)
                merged, mstats = merge_supernodes(
                    pattern, ranges, model, threshold=threshold,
                    max_width=max_width)
                modeled = mstats.modeled_after_s
                candidates.append({
                    "supernode_relax": relax,
                    "supernode_max_size": max_size,
                    "modeled_s": modeled,
                    "n_panels": mstats.n_after,
                    "merges": mstats.merges,
                })
                # Strict < keeps ties on the earliest (smallest-knob)
                # candidate, so the pick is deterministic across runs.
                if best is None or modeled < best[0]:
                    best = (modeled, relax, max_size, merged)
        modeled_s, relax, max_size, supernodes = best
        chosen = {
            "supernode_relax": int(relax),
            "supernode_max_size": int(max_size),
            "blocking": True,
            "block_merge_threshold": threshold,
            "block_max_width": max_width,
            "concurrency": choose_concurrency(pattern.n),
        }
        report = TuneReport(
            chosen=chosen,
            modeled_s=float(modeled_s),
            baseline_s=float(baseline_s),
            n_panels=int(len(supernodes)),
            candidates=tuple(candidates),
        )
        if _ot.ENABLED:
            reg = _om.registry()
            reg.count("tune.candidates", len(candidates))
            reg.gauge("tune.modeled_s", report.modeled_s)
            reg.gauge("tune.baseline_s", report.baseline_s)
    return supernodes, report
