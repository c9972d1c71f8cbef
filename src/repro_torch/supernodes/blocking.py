"""Structure-aware irregular blocking: post-detection supernode merging
(host numpy, a copy of the reference's pass).

T2/T3 detection only fuses columns with (near-)identical structure, so
sparse factors still emit thousands of narrow panels (bbd-20k: 9372
supernodes at n=20000) and the one-GEMM-per-panel sweep pays a dispatch
overhead per panel that dwarfs the math.  Following "A Structure-Aware
Irregular Blocking Method for Sparse LU Factorization" (PAPERS.md), this
pass greedily coalesces *adjacent* supernodes whose row structures nearly
overlap into one padded dense block whenever the roofline cost model says
the flop/byte gain (one bigger GEMM at higher arithmetic intensity, one
dispatch instead of two) beats the explicit-zero padding cost.

Correctness rides on the existing packed-panel contract: ``PanelStore``
builds each panel over the *union* of its columns' row patterns with an
``in_pattern`` mask that keeps out-of-pattern slots exactly zero
(``zero_padding`` after the sweep, escape-checked against
``pattern_tol``), and ``build_schedule`` accepts any contiguous partition —
so a merged partition is numerically valid by construction, exactly like
T3 relaxed merges, just driven by a cost model instead of a subdiagonal
coupling test.  Merging changes the float-op grouping (one wide diagonal
LU / trailing GEMM instead of several), so blocked factors get
dense-oracle parity, while the default (``blocking=False``) path never
runs this code and stays bitwise-identical.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.obs import metrics as _om
from repro_torch.obs import trace as _ot


@dataclasses.dataclass(frozen=True)
class BlockingStats:
    """What the merge pass did, for ``plan.stats`` / bench reporting."""

    n_before: int
    n_after: int
    merges: int
    pad_entries_before: int
    pad_entries_after: int
    modeled_before_s: float
    modeled_after_s: float

    @property
    def modeled_gain_s(self) -> float:
        return self.modeled_before_s - self.modeled_after_s


def _panel_rows(pattern, s: int, e: int) -> np.ndarray:
    """Sorted union row set of columns ``[s, e)`` incl. the diagonal block
    rows — the exact set ``PanelStore`` packs for this panel."""
    seg = pattern.rowind[pattern.indptr[s]:pattern.indptr[e]]
    return np.unique(np.concatenate([seg, np.arange(s, e, dtype=seg.dtype)]))


def _panel_shape(rows: np.ndarray, s: int, e: int) -> Tuple[int, int, int]:
    """(m, k, w) of the panel over ``rows``: ``m`` rows at/below the
    diagonal, ``k`` ancestor rows above it, ``w`` columns."""
    k = int(np.searchsorted(rows, s))
    return len(rows) - k, k, e - s


def partition_stats(pattern, supernodes) -> dict:
    """Per-panel shape arrays for a contiguous partition.

    Returns ``{"m", "k", "w", "entries", "pad_entries"}`` numpy arrays (one
    element per panel) where ``entries`` is the packed block size
    ``n_rows * w`` and ``pad_entries`` the explicit zeros it carries beyond
    the column patterns.  Feeds ``RooflineCostModel.partition_time`` and the
    autotune sweep.
    """
    sup = np.asarray(supernodes)
    n_panels = len(sup)
    m = np.zeros(n_panels, dtype=np.int64)
    k = np.zeros(n_panels, dtype=np.int64)
    w = np.zeros(n_panels, dtype=np.int64)
    entries = np.zeros(n_panels, dtype=np.int64)
    pad = np.zeros(n_panels, dtype=np.int64)
    indptr = pattern.indptr
    for i, (s, e) in enumerate(sup):
        rows = _panel_rows(pattern, int(s), int(e))
        m[i], k[i], w[i] = _panel_shape(rows, int(s), int(e))
        entries[i] = len(rows) * (int(e) - int(s))
        pad[i] = entries[i] - int(indptr[int(e)] - indptr[int(s)])
    pad = np.maximum(pad, 0)
    return {"m": m, "k": k, "w": w, "entries": entries, "pad_entries": pad}


def merge_supernodes(pattern, supernodes, model, *, threshold: float = 1.0,
                     max_width: int = 256,
                     ) -> Tuple[np.ndarray, BlockingStats]:
    """Greedy left-to-right merge of adjacent supernodes under ``model``.

    Walks the detected partition keeping a current group; the next panel is
    absorbed when the merged block stays within ``max_width`` columns and
    the modeled time of the merged panel is at most ``threshold`` times the
    sum of the two separate panels (``threshold=1.0`` accepts exactly the
    merges the roofline model predicts as wins; ``>1`` trades modeled time
    for fewer panels, ``<1`` demands a strict margin).  Returns the merged
    ``(n_panels, 2)`` contiguous ranges plus a :class:`BlockingStats`.

    Cost per candidate is one sorted-union of row sets, so the whole pass is
    ``O(sum panel entries)`` — cheap enough for the autotune sweep to call
    it once per candidate partition.
    """
    sup = np.asarray(supernodes)
    if max_width < 1:
        raise ValueError(f"max_width must be >= 1, got {max_width}")
    if threshold <= 0:
        raise ValueError(f"threshold must be > 0, got {threshold}")
    with _ot.span("blocking_merge"):
        before = partition_stats(pattern, sup)
        modeled_before = model.partition_time(before["m"], before["k"],
                                              before["w"])
        merged: list[tuple[int, int]] = []
        merges = 0
        if len(sup):
            cur_s, cur_e = int(sup[0][0]), int(sup[0][1])
            cur_rows = _panel_rows(pattern, cur_s, cur_e)
            cur_t = model.panel_time(*_panel_shape(cur_rows, cur_s, cur_e))
            for s2, e2 in sup[1:]:
                s2, e2 = int(s2), int(e2)
                if (e2 - cur_s) <= max_width:
                    nxt_rows = _panel_rows(pattern, s2, e2)
                    nxt_t = model.panel_time(*_panel_shape(nxt_rows, s2, e2))
                    uni = np.union1d(cur_rows, nxt_rows)
                    uni_t = model.panel_time(*_panel_shape(uni, cur_s, e2))
                    if uni_t <= threshold * (cur_t + nxt_t):
                        cur_e, cur_rows, cur_t = e2, uni, uni_t
                        merges += 1
                        continue
                merged.append((cur_s, cur_e))
                cur_s, cur_e = s2, e2
                cur_rows = _panel_rows(pattern, cur_s, cur_e)
                cur_t = model.panel_time(*_panel_shape(cur_rows, cur_s,
                                                       cur_e))
            merged.append((cur_s, cur_e))
        out = np.asarray(merged, dtype=np.int64).reshape(-1, 2)
        after = partition_stats(pattern, out)
        modeled_after = model.partition_time(after["m"], after["k"],
                                             after["w"])
        stats = BlockingStats(
            n_before=int(len(sup)),
            n_after=int(len(out)),
            merges=merges,
            pad_entries_before=int(before["pad_entries"].sum()),
            pad_entries_after=int(after["pad_entries"].sum()),
            modeled_before_s=float(modeled_before),
            modeled_after_s=float(modeled_after),
        )
        if _ot.ENABLED:
            reg = _om.registry()
            reg.count("blocking.merges", merges)
            reg.gauge("blocking.panels_before", stats.n_before)
            reg.gauge("blocking.panels_after", stats.n_after)
            reg.gauge("blocking.pad_entries", stats.pad_entries_after)
            reg.gauge("blocking.modeled_gain_s", stats.modeled_gain_s)
    return out, stats
