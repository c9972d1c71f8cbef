"""Multi-source concurrent symbolic factorization (paper §V).

* **Combined traversal** — a chunk of #C sources runs as ONE batched fixpoint
  on the device: the dense-batch equivalent of the paper's shared frontier
  queue + tracker[] (the tracker is the batch index, free).
  ``combined=False`` runs the same chunk one source at a time (the paper's
  "#C = 1" baseline in Fig 12).

* **Chunk planning with bubble removal** — sources are processed in
  ascending chunks of #C, padded to full width by repeating the last source
  (idempotent — duplicate sources converge to identical labels; the extras
  are sliced off).  Since a source ``src`` never *expands* vertices >= src,
  the label matrix of a chunk only needs width ``max(src in chunk) + 1``
  (rounded up to a multiple of 256).  U-part fills beyond the window are
  pure reachability (any discovered path has intermediates < src < v, so
  Theorem 1 collapses — paper §VI "bubble removal"); one full-width
  relaxation pass at convergence recovers them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.core import gsofa
from repro_torch.core.gsofa import (
    INF, SymbolicGraph, compute_prop, fill_masks, init_labels, relax_ell,
    row_counts,
)
from repro_torch.core.spaceopt import LabelArena, auto_concurrency
from repro_torch.obs import metrics as _om
from repro_torch.obs import trace as _ot


@dataclasses.dataclass(frozen=True)
class Chunk:
    srcs: np.ndarray     # (S,) int32, padded to full concurrency with repeats
    n_real: int          # how many leading entries are real sources
    width: int           # label width (bubble removal), <= graph.n


def _chunk(srcs: np.ndarray, concurrency: int, width: int) -> Chunk:
    n_real = len(srcs)
    if n_real < concurrency:
        srcs = np.concatenate(
            [srcs, np.full(concurrency - n_real, srcs[-1], dtype=np.int32)])
    return Chunk(srcs=srcs, n_real=n_real, width=width)


def plan_chunks(n: int, concurrency: int, *, bubble: bool = False,
                round_to: int = 256) -> List[Chunk]:
    """Ascending source chunks of ``concurrency`` sources.  With
    ``bubble`` a chunk's label width is ``max(src) + 1`` rounded up to a
    multiple of ``round_to`` and capped at n; otherwise n."""
    chunks = []
    for start in range(0, n, concurrency):
        srcs = np.arange(start, min(start + concurrency, n), dtype=np.int32)
        width = (min(n, math.ceil((int(srcs.max()) + 1) / round_to)
                     * round_to) if bubble else n)
        chunks.append(_chunk(srcs, concurrency, width))
    return chunks


def _chunk_view(graph: SymbolicGraph, width: int) -> SymbolicGraph:
    """Truncated view for bubble-removal chunks: only vertices < width can
    be relaxed or expanded; in-neighbor ids >= width are clipped to the INF
    pad slot.  No dense adjacency: a narrowed chunk relaxes by ELL."""
    if width >= graph.n:
        return graph
    return SymbolicGraph(
        n=width,
        in_ell=graph.in_ell[:width].clamp(max=width),
        out_ell=graph.out_ell,  # init's out-neighbours; ids >= width drop
        out_deg=graph.out_deg[:width],
        adj_dense=None,
    )


def _finalize_bubble(graph: SymbolicGraph, labels_w: torch.Tensor,
                     srcs: torch.Tensor, offset: int,
                     width: int) -> torch.Tensor:
    """(S, n) bool fill mask from a truncated-label fixpoint.

    v < width: the Theorem-1 test on the converged labels.  v >= width
    (> src): reachability — one full-width ELL relaxation of the converged
    props, plus the direct edges of each source."""
    n = graph.n
    prop = compute_prop(labels_w, srcs, offset)
    prop_full = torch.cat([prop, torch.full((prop.shape[0], n - width), INF,
                                            dtype=torch.int32,
                                            device=prop.device)], dim=1)
    cand_full = relax_ell(prop_full, graph)                 # (S, n)
    v_ids = torch.arange(n, dtype=torch.int32, device=prop.device)
    low = fill_masks(labels_w, srcs, offset)                # (S, width)
    direct = init_labels(graph, srcs) < INF                 # original edges
    high = (cand_full < INF) | direct
    mask = torch.cat([low, high[:, width:]], dim=1) if width < n else low
    return mask & (v_ids[None, :] != srcs[:, None])


@dataclasses.dataclass
class MultiSourceResult:
    l_counts: np.ndarray        # (n,) structural L counts per row (no diag)
    u_counts: np.ndarray        # (n,)
    edge_checks: np.ndarray     # (n,) paper workload metric per source
    conv_iters: np.ndarray      # (n,) supersteps each source stayed active
    supersteps: int             # total supersteps across chunks
    n_chunks: int
    concurrency: int
    reinits: int                # real label re-initializations (window trick)
    windows: int

    @property
    def total_nnz(self) -> int:
        return int(self.l_counts.sum() + self.u_counts.sum() + len(self.l_counts))


def run_multisource(graph: SymbolicGraph, *, concurrency: int = 64,
                    backend: str = "ell", combined: bool = True,
                    bubble: bool = False, use_arena: bool = True,
                    budget_bytes: Optional[int] = None,
                    sources: Optional[np.ndarray] = None,
                    on_chunk: Optional[Callable] = None,
                    on_mask: Optional[Callable] = None,
                    on_progress: Optional[Callable] = None
                    ) -> MultiSourceResult:
    """Single-device multi-source driver: plan chunks, run fixpoints on the
    graph's device, aggregate the per-row counts on the host.

    ``on_chunk(labels, srcs, offset)`` is invoked with every converged label
    matrix before it is recycled — labels is the (G, W) device tensor (W < n
    for bubble chunks), srcs the matching source ids (repeats possible from
    padding), offset the label-window base.  This is how supernode
    fingerprinting (repro_torch.supernodes) overlaps detection with the
    symbolic chunks.

    ``on_mask(mask, srcs)`` receives the *full-width* (G, n) bool device
    fill mask of each converged chunk (bubble chunks are finalized to full
    width first) — how the sparse CSC pattern streams out of the fixpoint
    (core.symbolic.PatternCollector) without a dense (n, n) pattern.

    With ``bubble`` a chunk narrower than n relaxes by ELL whatever
    ``backend`` is, over the truncated view, and no ``LabelArena`` is used.

    ``on_progress(done, total, eta_s)`` fires once per completed chunk with
    a rolling-rate ETA (``repro_torch.obs.metrics.ProgressMeter``).
    """
    n = graph.n
    dev = graph.device
    concurrency = auto_concurrency(graph, budget_bytes, concurrency, backend)
    if sources is None:
        chunks = plan_chunks(n, concurrency, bubble=bubble)
    else:
        # explicit source set (checkpoint restart re-runs its pending rows)
        chunks = [_chunk(np.asarray(sources[start:start + concurrency],
                                    dtype=np.int32), concurrency, n)
                  for start in range(0, len(sources), concurrency)]

    arena = LabelArena(capacity=concurrency, n=n, device=dev) \
        if use_arena and not bubble else None

    l_counts = np.zeros(n, dtype=np.int64)
    u_counts = np.zeros(n, dtype=np.int64)
    edge_checks = np.zeros(n, dtype=np.int64)
    conv_iters = np.zeros(n, dtype=np.int64)
    supersteps = 0

    meter = _om.ProgressMeter(on_progress) if on_progress is not None else None
    for ci, chunk in enumerate(chunks):
        if combined:
            groups = [np.arange(len(chunk.srcs))]
        else:
            groups = [np.array([i]) for i in range(chunk.n_real)]
        for g in groups:
            with _ot.span("fixpoint_chunk"):
                g_srcs = chunk.srcs[g]
                gs = torch.as_tensor(g_srcs, device=dev)
                offset = 0
                if bubble and chunk.width < n:
                    view = _chunk_view(graph, chunk.width)
                    res = gsofa.gsofa_batch(view, gs, backend="ell",
                                            max_iters=chunk.width + 2)
                    mask = _finalize_bubble(graph, res.labels, gs, 0,
                                            chunk.width)
                    v_ids = torch.arange(n, dtype=torch.int32, device=dev)
                    l_cnt = (mask & (v_ids[None, :] < gs[:, None])).sum(1)
                    u_cnt = (mask & (v_ids[None, :] > gs[:, None])).sum(1)
                else:
                    labels0 = None
                    if arena is not None and combined:
                        offset = arena.next_window()
                        labels0 = init_labels(graph, gs, offset=offset,
                                              stale_buf=arena.buf)
                    res = gsofa.gsofa_batch(graph, gs, backend=backend,
                                            labels0=labels0, offset=offset)
                    if arena is not None and combined:
                        arena.buf = res.labels
                    mask = (fill_masks(res.labels, gs, offset)
                            if on_mask is not None else None)
                    l_cnt, u_cnt = row_counts(res.labels, gs, offset)

                if on_chunk is not None:
                    on_chunk(res.labels, g_srcs, offset)
                if on_mask is not None:
                    on_mask(mask, g_srcs)
                real = g < chunk.n_real
                real_idx = g_srcs[real]
                l_counts[real_idx] = l_cnt.cpu().numpy()[real]
                u_counts[real_idx] = u_cnt.cpu().numpy()[real]
                edge_checks[real_idx] = res.edge_checks.cpu().numpy()[real]
                conv_iters[real_idx] = res.conv_iter.cpu().numpy()[real]
                supersteps += res.iters
                if _ot.ENABLED:
                    _om.registry().observe("fixpoint.iterations", res.iters)
                    _om.registry().count("fixpoint.chunks")
        if meter is not None:
            meter.update(ci + 1, len(chunks))

    return MultiSourceResult(
        l_counts=l_counts, u_counts=u_counts, edge_checks=edge_checks,
        conv_iters=conv_iters, supersteps=supersteps, n_chunks=len(chunks),
        concurrency=concurrency,
        reinits=arena.reinits if arena else len(chunks),
        windows=arena.windows if arena else len(chunks),
    )
