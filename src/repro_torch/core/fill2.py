"""Sequential fill2 (Rose & Tarjan 1978), per the paper's Figure 4(a).

This is the CPU baseline GSoFa compares against (SuperLU_DIST's parallel
symbolic factorization is a distributed fill2-family algorithm).  It is also
the second correctness reference for the parallel fixpoint.

The threshold loop ascends and every vertex is visited at most once per
source — the serialization the paper's Challenge #1 identifies.
"""
from __future__ import annotations

from collections import deque
from typing import List, Tuple

import numpy as np

from repro_torch.sparse.csr import CSRMatrix


def fill2_row(a: CSRMatrix, src: int, fill: np.ndarray, *, count_edges: bool = False
              ) -> Tuple[np.ndarray, int]:
    """Filled-structure column ids of row ``src`` (originals + fill-ins, no diagonal).

    ``fill`` is the reusable |V| visitation array (init to -1); entry == src
    marks "visited for this source" (paper lines 3-5, with -1 instead of 0 so
    source 0 needs no special case).
    Returns (sorted column ids, #edge checks) — the edge-check counter is the
    workload metric used in the paper's Figs 7/8.
    """
    edge_checks = 0
    fill[src] = src
    out: List[int] = []
    adj0 = a.row(src)
    for v in adj0:
        if v != src:
            fill[v] = src
            out.append(int(v))
    # Threshold loop: strictly ascending, dynamically gated on fill[t] == src.
    for threshold in range(src):
        if fill[threshold] != src:
            continue
        queue: deque[int] = deque([threshold])
        while queue:
            frontier = queue.popleft()
            row = a.row(frontier)
            edge_checks += len(row)
            for nbr in row:
                nbr = int(nbr)
                if nbr == src or fill[nbr] == src:
                    continue
                fill[nbr] = src
                if nbr > threshold:
                    out.append(nbr)       # fill-in (src, nbr): Theorem 1 holds
                else:
                    queue.append(nbr)     # keep expanding below the threshold
    return np.array(sorted(out), dtype=np.int64), edge_checks


def fill2_all(a: CSRMatrix, sources: np.ndarray | None = None,
              *, count_edges: bool = False):
    """Run fill2 for every source row. Returns (list of row structures, edge counts)."""
    if sources is None:
        sources = np.arange(a.n)
    fill = np.full(a.n, -1, dtype=np.int64)
    rows = []
    edges = np.zeros(len(sources), dtype=np.int64)
    for i, src in enumerate(sources):
        r, ec = fill2_row(a, int(src), fill)
        rows.append(r)
        edges[i] = ec
    return rows, edges


def fill2_dense(a: CSRMatrix) -> np.ndarray:
    """Dense L+U boolean pattern from fill2 (diagonal set True)."""
    rows, _ = fill2_all(a)
    out = np.zeros((a.n, a.n), dtype=bool)
    for i, r in enumerate(rows):
        out[i, r] = True
    np.fill_diagonal(out, True)
    return out
