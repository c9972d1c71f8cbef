"""Vectorized supernode detection from column fingerprints (DESIGN.md §3).

The serial reference (``repro.core.symbolic.detect_supernodes``) walks
columns left to right comparing whole dense columns — O(n^2) compares on a
gathered pattern.  Here the per-boundary test is a pure vectorized
predicate over the O(n) fingerprint arrays:

**T2 (exact-match) test.**  Columns j-1, j share a supernode iff
``L(j:, j)`` and ``L(j:, j-1)`` have identical structure and L(j, j-1) != 0.
Since L(j, j) is structurally nonzero, that is equivalent to::

    subdiag[j]                                (L(j, j-1) != 0)
    counts[j]  == counts[j-1] - 1             (sets differ exactly by row j)
    hsum[j]    == hsum[j-1] - mix1(j)         (mod 2^32)
    hxor[j]    == hxor[j-1] ^ mix2(j)

The count is exact; the two independent 32-bit row-hash relations make a
false merge a hash-collision event (two distinct equal-size row sets agreeing
under both mix1-sum and mix2-xor), negligible in practice — and the serial
routine is kept as the test oracle precisely to police this contract.

**T3 (relaxed) test.**  With ``relax > 0``, boundary j may also merge when
L(j, j-1) != 0 and the below-diagonal counts of the two columns differ by at
most ``relax`` beyond the mandatory row j (``|counts[j-1] - 1 - counts[j]|
<= relax``).  This is a *count-proximity heuristic*, in the spirit of
SuperLU's structure-oblivious relaxed snodes: it is gated on the
subdiagonal coupling and count closeness only, and does NOT bound the
explicit-zero padding a numeric consumer must add (two size-matched but
disjoint column structures pass it) — fingerprints summarize columns, they
cannot measure set differences.  Consumers that need a padding guarantee
should verify candidate T3 merges against the CSR structure.  ``relax=0``
degenerates to exactly T2.

Boundary flags then become ``(n_supernodes, 2)`` [start, end) ranges — the
same contract the serial routine returns and downstream supernodal numeric
factorization consumes — with maximal merge runs split every ``max_size``
columns, matching the serial size-reset semantics.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.obs import metrics as _om
from repro_torch.obs import trace as _ot
from repro_torch.supernodes.fingerprint import ColumnFingerprints, mix1, mix2


def merge_flags(fp: ColumnFingerprints, *, relax: int = 0) -> np.ndarray:
    """(n,) bool; flags[j] = columns j-1 and j may share a supernode
    (flags[0] is always False: column 0 starts the first supernode)."""
    if not fp.complete:
        missing = np.flatnonzero(~fp.seen)
        raise ValueError(f"fingerprints incomplete: rows {missing[:8].tolist()}"
                         f"... of {fp.n} were never accumulated")
    n = fp.n
    flags = np.zeros(n, dtype=bool)
    if n < 2:
        return flags
    j = np.arange(1, n)
    cnt_ok = fp.counts[1:] == fp.counts[:-1] - 1
    hs_ok = (fp.hsum[:-1] - fp.hsum[1:]) == mix1(j)     # uint32 wraparound
    hx_ok = (fp.hxor[:-1] ^ fp.hxor[1:]) == mix2(j)
    t2 = fp.subdiag[1:] & cnt_ok & hs_ok & hx_ok
    if relax > 0:
        extra = np.abs(fp.counts[:-1] - 1 - fp.counts[1:])
        t2 = t2 | (fp.subdiag[1:] & (extra <= relax))
    flags[1:] = t2
    return flags


def ranges_from_flags(flags: np.ndarray, *, max_size: int = 64) -> np.ndarray:
    """Merge flags -> (n_supernodes, 2) [start, end) ranges, splitting every
    maximal merge run into ``max_size``-column pieces (vectorized; identical
    to the serial scan's size-counter reset)."""
    if max_size < 1:
        raise ValueError(f"max_size must be >= 1, got {max_size}")
    n = len(flags)
    if n == 0:
        return np.zeros((0, 2), dtype=np.int64)
    starts = np.flatnonzero(~flags)            # flags[0] is False -> starts[0]=0
    ends = np.append(starts[1:], n)
    reps = -(-(ends - starts) // max_size)     # pieces per run (ceil)
    total = int(reps.sum())
    # piece index within its run: 0,1,...,reps[r]-1 concatenated
    piece = np.arange(total) - np.repeat(np.cumsum(reps) - reps, reps)
    s = np.repeat(starts, reps) + piece * max_size
    e = np.minimum(s + max_size, np.repeat(ends, reps))
    return np.stack([s, e], axis=1)


def detect_from_fingerprints(fp: ColumnFingerprints, *, relax: int = 0,
                             max_size: int = 64) -> np.ndarray:
    """Full detection: fingerprint state -> (n_supernodes, 2) ranges."""
    with _ot.span("supernode_detect"):
        ranges = ranges_from_flags(merge_flags(fp, relax=relax),
                                   max_size=max_size)
        if _ot.ENABLED:
            reg = _om.registry()
            reg.gauge("supernodes.count", len(ranges))
            for w in (ranges[:, 1] - ranges[:, 0]).tolist():
                reg.observe("supernodes.size", w)
        return ranges


def detect_supernodes_batched(a, *, relax: int = 0, max_size: int = 64,
                              concurrency: int = 128, backend: str = "ell",
                              bubble: bool = False,
                              fp: Optional[ColumnFingerprints] = None,
                              device=None) -> np.ndarray:
    """CSR (or a prepared ``SymbolicGraph``) in, supernode ranges out,
    never materializing the dense pattern.  Pass ``fp`` to reuse the
    fingerprints of a symbolic run; otherwise one multi-source fixpoint
    pass on ``device`` (default: the card) collects them."""
    if fp is None:
        from repro_torch.core.gsofa import prepare_graph
        from repro_torch.supernodes.fingerprint import fingerprints_from_graph

        graph = (a if not hasattr(a, "indptr")
                 else prepare_graph(a, device=device))
        fp = fingerprints_from_graph(graph, concurrency=concurrency,
                                     backend=backend, bubble=bubble)
    return detect_from_fingerprints(fp, relax=relax, max_size=max_size)


def supernode_stats(ranges: np.ndarray) -> dict:
    """Summary the pipeline reports (SymbolicResult / bench_supernode)."""
    sizes = ranges[:, 1] - ranges[:, 0]
    return {
        "n_supernodes": int(len(ranges)),
        "mean_size": float(sizes.mean()) if len(sizes) else 0.0,
        "max_size": int(sizes.max()) if len(sizes) else 0,
        "multi_column_fraction": float((sizes > 1).mean()) if len(sizes) else 0.0,
    }
