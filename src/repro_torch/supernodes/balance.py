"""Balanced panel packing of detected supernodes (DESIGN.md §3.4).

Downstream consumers of the supernode partition — supernodal numeric
factorization batching dense panel updates (GLU3.0-style level batching), and
multi-device pipelines assigning panels across the mesh alongside
core/distributed.py's interleaved source sharding — want *near-equal-nnz*
panels, not near-equal column counts: panel cost is dominated by the L-panel
nnz it touches, and supernode sizes after fill are heavily skewed (the dense
trailing block dwarfs early singletons).

Two packers:

* ``lpt``        — longest-processing-time greedy: sort supernodes by weight,
  assign each to the currently-lightest panel.  Classic bound: max load
  <= total/p + max single weight (tests assert it); panels are *sets* of
  supernodes, fine for independent panel updates / device assignment.
* ``contiguous`` — order-preserving prefix splitter for consumers that need
  each panel to be a contiguous column block (e.g. a blocked triangular
  solve); greedy target-crossing split, same worst-case bound.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np


@dataclasses.dataclass
class PanelPartition:
    """Assignment of supernodes to near-equal-weight panels."""

    assignment: np.ndarray     # (n_supernodes,) panel id
    loads: np.ndarray          # (n_panels,) packed weight per panel
    n_panels: int

    @property
    def balance_ratio(self) -> float:
        """max / mean panel load (1.0 = perfect)."""
        if self.n_panels == 0 or len(self.loads) == 0 or self.loads.sum() == 0:
            return 1.0      # nothing packed: trivially balanced
        return float(self.loads.max()) / float(self.loads.mean())

    def panels(self) -> list:
        return [np.flatnonzero(self.assignment == p)
                for p in range(self.n_panels)]


def supernode_weights(ranges: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """(k,) estimated L-panel nnz per supernode: each column j carries its
    below-diagonal count plus the diagonal; computed from the O(n) fingerprint
    counts, no pattern needed."""
    per_col = np.concatenate([[0], np.cumsum(counts.astype(np.int64) + 1)])
    return per_col[ranges[:, 1]] - per_col[ranges[:, 0]]


def pack_panels(ranges: np.ndarray, counts: np.ndarray, n_panels: int, *,
                policy: str = "lpt") -> PanelPartition:
    """Bin-pack supernodes into ``n_panels`` near-equal-nnz panels."""
    k = len(ranges)
    if n_panels <= 0 and k > 0:
        # an assignment into an empty partition would silently point every
        # supernode at panel 0 of a zero-length loads array
        raise ValueError(
            f"pack_panels: n_panels must be positive to pack {k} supernodes, "
            f"got {n_panels}")
    weights = supernode_weights(ranges, counts)
    assignment = np.zeros(k, dtype=np.int64)
    loads = np.zeros(max(0, n_panels), dtype=np.int64)
    if k == 0:
        return PanelPartition(assignment=assignment, loads=loads,
                              n_panels=max(0, n_panels))
    if policy == "lpt":
        heap = [(0, p) for p in range(n_panels)]
        heapq.heapify(heap)
        for i in np.argsort(weights)[::-1]:
            load, p = heapq.heappop(heap)
            assignment[i] = p
            load += int(weights[i])
            loads[p] = load
            heapq.heappush(heap, (load, p))
    elif policy == "contiguous":
        target = weights.sum() / n_panels
        p, acc = 0, 0
        for i in range(k):
            # keep panels contiguous; advance when the running load crosses
            # the ideal prefix boundary (never past the last panel)
            if acc >= target * (p + 1) and p < n_panels - 1:
                p += 1
            assignment[i] = p
            acc += int(weights[i])
        for p in range(n_panels):
            loads[p] = int(weights[assignment == p].sum())
    else:
        raise ValueError(f"unknown packing policy: {policy!r}")
    return PanelPartition(assignment=assignment, loads=loads,
                          n_panels=n_panels)
