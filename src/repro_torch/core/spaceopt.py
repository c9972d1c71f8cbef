"""Space-complexity management (paper §VI, DESIGN.md §2).

1. **LabelArena / window trick** — the paper slides the "valid value range" of
   maxId[] down the int32 range so the array is re-initialized only once every
   ``maxVal/|V|`` sources.  Labels are stored as ``offset_k + maxId`` with
   ``offset_k = top - k*(n+2)``; anything above ``offset_k + n`` reads as
   uninitialized, so the previous chunk's garbage is inert and the buffer is
   reused without clearing.  Offsets are Python ints kept inside int32, so
   the device labels never promote to int64.

2. **Memory envelope / auto-#C** — if the configured budget cannot host the
   requested concurrency, #C is reduced (the paper's final fallback, §VI
   "space configurability").  ``bytes_per_source`` accounts for the real
   resident set of the chosen backend.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.gsofa import INF, SymbolicGraph
from repro_torch.kernels import ops as kops

_I32_TOP = int(np.iinfo(np.int32).max) - 4


@dataclasses.dataclass
class LabelArena:
    """Reusable (C, V) label buffer with sliding-window re-initialization."""

    capacity: int            # max concurrent sources (#C)
    n: int                   # label width
    device: object = None    # None: the card (``kops.resolve_device``)
    reinits: int = 0         # how many real re-initializations happened
    windows: int = 0         # how many windows were consumed

    def __post_init__(self):
        self.device = kops.resolve_device(self.device)
        self._range = self.n + 2
        # leave headroom so offset + n never overflows int32
        self._top = _I32_TOP - self._range
        self._floor = self._range + 1
        self._offset = None   # set on first window
        self.buf = self._fresh()
        self.reinits = 1      # the initial fill is a real initialization

    def _fresh(self) -> torch.Tensor:
        return torch.full((self.capacity, self.n), INF, dtype=torch.int32,
                          device=self.device)

    def next_window(self) -> int:
        """Advance to a fresh value window; re-initialize only on wraparound."""
        if self._offset is None:
            self._offset = self._top
        else:
            self._offset -= self._range
            if self._offset < self._floor:
                # wraparound: one real re-init every ~2^31/|V| windows
                self.buf = self._fresh()
                self.reinits += 1
                self._offset = self._top
        self.windows += 1
        return self._offset

    @property
    def offset(self) -> int:
        if self._offset is None:
            raise RuntimeError("call next_window() first")
        return self._offset


def bytes_per_source(graph: SymbolicGraph, backend: str = "ell",
                     label_width: Optional[int] = None) -> int:
    """Resident bytes one concurrent source costs during the fixpoint:
    labels (V), prev_prop (V), cur_prop (V), and the relaxation scratch —
    (V * K_in) for the ELL gather or the (V) accumulator for the blocked
    kernel (the reference's accounting, kept so ``budget_bytes`` picks the
    same #C)."""
    v = label_width if label_width is not None else graph.n
    base = 3 * v * 4
    if backend == "ell":
        k = int(graph.in_ell.shape[1])
        return base + v * k * 4
    return base + v * 4


def auto_concurrency(graph: SymbolicGraph, budget_bytes: Optional[int],
                     requested: int, backend: str = "ell",
                     label_width: Optional[int] = None) -> int:
    """Paper §VI fallback: shrink #C until the resident set fits the envelope."""
    if budget_bytes is None:
        return requested
    per_src = bytes_per_source(graph, backend, label_width)
    fixed = (graph.in_ell.numel() * 4 + graph.out_ell.numel() * 4
             + graph.out_deg.numel() * 4)
    if graph.adj_dense is not None:
        fixed += graph.adj_dense.numel()
    avail = budget_bytes - fixed
    if avail <= 0:
        return 1
    return max(1, min(requested, avail // per_src))


def aux_memory_report(graph: SymbolicGraph, concurrency: int,
                      backend: str = "ell") -> dict:
    """Fig 16 analogue: auxiliary-structure bytes vs matrix bytes."""
    matrix_bytes = graph.in_ell.numel() * 4 + graph.out_ell.numel() * 4
    aux = bytes_per_source(graph, backend) * concurrency
    return {
        "matrix_bytes": int(matrix_bytes),
        "aux_bytes": int(aux),
        "ratio": float(aux) / max(1, matrix_bytes),
        "concurrency": concurrency,
    }
