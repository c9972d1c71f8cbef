"""Multi-source concurrent symbolic factorization (paper §V).

* **Combined traversal** — a chunk of #C sources runs as ONE batched fixpoint
  on the device: the dense-batch equivalent of the paper's shared frontier
  queue + tracker[] (the tracker is the batch index, free).
  ``combined=False`` runs the same chunk one source at a time (the paper's
  "#C = 1" baseline in Fig 12).

* **Chunk planning** — sources are processed in ascending chunks of #C,
  padded to full width by repeating the last source (idempotent — duplicate
  sources converge to identical labels; the extras are sliced off).

Bubble removal (label windows narrower than n) is a later slice of the port
(``ROADMAP.md`` Queue A); every chunk here is full-width.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.core import gsofa
from repro_torch.core.gsofa import (
    SymbolicGraph, fill_masks, init_labels, row_counts,
)
from repro_torch.core.spaceopt import LabelArena, auto_concurrency
from repro_torch.obs import metrics as _om
from repro_torch.obs import trace as _ot


@dataclasses.dataclass(frozen=True)
class Chunk:
    srcs: np.ndarray     # (S,) int32, padded to full concurrency with repeats
    n_real: int          # how many leading entries are real sources
    width: int           # label width (= graph.n on the full-width path)


def _chunk(srcs: np.ndarray, concurrency: int, width: int) -> Chunk:
    n_real = len(srcs)
    if n_real < concurrency:
        srcs = np.concatenate(
            [srcs, np.full(concurrency - n_real, srcs[-1], dtype=np.int32)])
    return Chunk(srcs=srcs, n_real=n_real, width=width)


def plan_chunks(n: int, concurrency: int) -> List[Chunk]:
    """Ascending full-width source chunks of ``concurrency`` sources."""
    return [_chunk(np.arange(start, min(start + concurrency, n),
                             dtype=np.int32), concurrency, n)
            for start in range(0, n, concurrency)]


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
                    use_arena: bool = True,
                    budget_bytes: Optional[int] = None,
                    sources: Optional[np.ndarray] = None,
                    on_chunk: Optional[Callable] = None,
                    on_mask: Optional[Callable] = None,
                    on_progress: Optional[Callable] = None
                    ) -> MultiSourceResult:
    """Single-device multi-source driver: plan chunks, run fixpoints on the
    graph's device, aggregate the per-row counts on the host.

    ``on_chunk(labels, srcs, offset)`` is invoked with every converged label
    matrix before it is recycled — labels is the (G, n) device tensor, srcs
    the matching source ids (repeats possible from padding), offset the
    label-window base.  This is how supernode fingerprinting
    (repro_torch.supernodes) overlaps detection with the symbolic chunks.

    ``on_mask(mask, srcs)`` receives the (G, n) bool device fill mask of each
    converged chunk — how the sparse CSC pattern streams out of the fixpoint
    (core.symbolic.PatternCollector) without a dense (n, n) pattern.

    ``on_progress(done, total, eta_s)`` fires once per completed chunk with
    a rolling-rate ETA (``repro_torch.obs.metrics.ProgressMeter``).
    """
    n = graph.n
    dev = graph.device
    concurrency = auto_concurrency(graph, budget_bytes, concurrency, backend)
    if sources is None:
        chunks = plan_chunks(n, concurrency)
    else:
        # explicit source set (checkpoint restart re-runs its pending rows)
        chunks = [_chunk(np.asarray(sources[start:start + concurrency],
                                    dtype=np.int32), concurrency, n)
                  for start in range(0, len(sources), concurrency)]

    arena = LabelArena(capacity=concurrency, n=n, device=dev) \
        if use_arena else None

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
                labels0 = None
                if arena is not None and combined:
                    offset = arena.next_window()
                    labels0 = init_labels(graph, gs, offset=offset,
                                          stale_buf=arena.buf)
                res = gsofa.gsofa_batch(graph, gs, backend=backend,
                                        labels0=labels0, offset=offset)
                if arena is not None and combined:
                    arena.buf = res.labels
                l_cnt, u_cnt = row_counts(res.labels, gs, offset)

                if on_chunk is not None:
                    on_chunk(res.labels, g_srcs, offset)
                if on_mask is not None:
                    on_mask(fill_masks(res.labels, gs, offset), g_srcs)
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
