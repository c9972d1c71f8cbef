"""Fingerprint-keyed LRU plan cache (host Python, a copy of the reference's
cache).

A solver service amortizes symbolic analysis across every request that
shares a sparsity pattern, so the cache key must be a *content* hash of the
structure — never object identity (requests arrive as fresh ``CSRMatrix``
objects, often deserialized).  ``pattern_fingerprint`` reuses the supernode
detector's two independent 32-bit row hashes (``supernodes/fingerprint.py``:
Knuth-multiplicative ``mix1`` summed mod 2^32, murmur3-fmix32 ``mix2``
xor-folded) over the linearized (row, col) structural keys, alongside the
exact (n, nnz): two distinct patterns colliding is a < 2^-64-ish event.

The key is a plain frozen dataclass of Python ints, so it is stable across
pickle round-trips, processes and sessions, and equals the reference's key
of the same pattern.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np

from repro_torch.supernodes.fingerprint import mix1, mix2


@dataclasses.dataclass(frozen=True)
class PatternKey:
    """Content hash of one CSR sparsity pattern: exact (n, nnz) + two
    independent 32-bit structure hashes.  Hashable / comparable /
    picklable — the plan-cache key."""

    n: int
    nnz: int
    h1: int          # sum of mix1(row*n + col) mod 2^32
    h2: int          # xor of mix2(row*n + col)


def pattern_fingerprint(a) -> PatternKey:
    """Content-hash ``a``'s structure (values are irrelevant — one plan
    serves every value set on the pattern).

    The linear key ``row * n + col`` of every structural entry feeds both
    row-hash families; sum and xor are associative/commutative reductions,
    so the fingerprint is independent of entry order within the CSR arrays.
    """
    rows = np.repeat(np.arange(a.n, dtype=np.int64), np.diff(a.indptr))
    lin = rows * np.int64(a.n) + a.indices.astype(np.int64)
    h1 = int(np.sum(mix1(lin), dtype=np.uint64) & np.uint64(0xFFFFFFFF))
    h2 = int(np.bitwise_xor.reduce(mix2(lin))) if lin.size else 0
    return PatternKey(n=int(a.n), nnz=int(a.nnz), h1=h1, h2=h2)


class PlanCache:
    """LRU cache of ``LUPlan`` objects keyed by ``PatternKey``.

    ``get`` refreshes recency; ``put`` evicts the least-recently-used
    entry beyond ``capacity``.  Pure container — hit/miss/evict counters
    live on the ``SolverEngine`` so the cache stays trivially testable.

    Thread-safe: a serving engine sees concurrent ``submit``/``flush`` from
    request threads, and the recency bookkeeping is a read-modify-write on
    the underlying ``OrderedDict``.  Every public method holds one internal
    lock; the lock never wraps plan construction, only the O(1) dict
    transitions, so analyze-scale work stays outside it.
    """

    def __init__(self, capacity: int = 8):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self._entries: "OrderedDict[PatternKey, object]" = OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: PatternKey) -> bool:
        with self._lock:
            return key in self._entries

    def keys(self) -> Tuple[PatternKey, ...]:
        """Keys in eviction order (least recently used first)."""
        with self._lock:
            return tuple(self._entries.keys())

    def get(self, key: PatternKey) -> Optional[object]:
        """The cached plan for ``key`` (refreshing its recency), or None."""
        with self._lock:
            plan = self._entries.get(key)
            if plan is not None:
                self._entries.move_to_end(key)
            return plan

    def put(self, key: PatternKey, plan) -> Optional[PatternKey]:
        """Insert/refresh ``key``; returns the evicted key if the insert
        pushed an LRU entry out, else None."""
        with self._lock:
            self._entries[key] = plan
            self._entries.move_to_end(key)
            if len(self._entries) > self.capacity:
                evicted, _ = self._entries.popitem(last=False)
                return evicted
            return None
