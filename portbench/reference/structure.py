"""The plain reference of a symbolic analysis: what ``analyze`` must derive
from a pattern, worked out again from the pattern's CSR arrays alone.

It imports nothing of the program (neither ``repro_torch`` nor the JAX
package) and takes nothing the program made.  Three results:

* ``filled_structure``: the rows of L+U under no-pivot Gaussian elimination
  with no numerical cancellation, by row-wise symbolic elimination (the
  IKJ order): row i starts as A's row i and, for each column j < i of its
  L part in increasing order (fill included as it appears), takes in U's
  row j.  This is the fill path theorem computed one row at a time, not
  the program's multi-source label fixpoint.  A symmetric pattern takes
  the elimination tree instead (George and Liu): column j of L is A's
  column j below the diagonal joined with the columns of its children in
  the tree, each cut to the rows below j, and U is L's transpose; the
  same structure in time linear in its size.
* ``supernodes``: the exact T2 partition the configuration states: columns
  j-1 and j share a supernode iff L(j, j-1) != 0 and L(j:, j-1) and
  L(j:, j) have the same rows; maximal runs are cut every ``max_size``
  columns from their start.
* ``levels``: panel J depends on every panel holding a row r < start(J)
  with a nonzero U(r, c), c in J; its level is one more than the highest
  level it depends on (0 with none).
"""
from __future__ import annotations

import heapq

import numpy as np


def filled_structure(n: int, indptr: np.ndarray, indices: np.ndarray):
    """(L rows, U rows): per row, the sorted int64 column ids of its strictly
    lower and strictly upper part in L+U."""
    indptr = np.asarray(indptr, dtype=np.int64)
    cols_all = np.asarray(indices, dtype=np.int64).tolist()
    upper = [None] * n          # frozenset of U's row j, columns > j
    lower_rows = [None] * n
    upper_rows = [None] * n
    push, pop = heapq.heappush, heapq.heappop
    for i in range(n):
        row = set(cols_all[indptr[i]:indptr[i + 1]])
        row.discard(i)
        heap = [j for j in row if j < i]
        heapq.heapify(heap)
        while heap:
            new = upper[pop(heap)] - row
            if new:
                row |= new
                for c in new:
                    if c < i:
                        push(heap, c)
        row.discard(i)                  # U's rows j < i may hold column i
        ordered = np.fromiter(row, dtype=np.int64, count=len(row))
        ordered.sort()
        cut = int(np.searchsorted(ordered, i))
        lower_rows[i] = ordered[:cut]
        upper_rows[i] = ordered[cut:]
        upper[i] = frozenset(upper_rows[i].tolist())
    return lower_rows, upper_rows


def symmetric_columns(n: int, indptr: np.ndarray, indices: np.ndarray):
    """Per column j, the sorted int64 rows below j of L, for a pattern equal
    to its transpose: the elimination tree's column merge."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    cols = [None] * n
    children = [[] for _ in range(n)]
    for j in range(n):
        a = indices[indptr[j]:indptr[j + 1]]
        parts = [a[a > j]] + [cols[c][1:] for c in children[j]]
        cols[j] = np.unique(np.concatenate(parts))
        if len(cols[j]):
            children[int(cols[j][0])].append(j)    # the parent: first row
    return cols


def symmetric_csc_pattern(n: int, cols):
    """(indptr, rowind) of L+U with the diagonal from L's columns, U being
    L's transpose."""
    lens = np.fromiter(map(len, cols), dtype=np.int64, count=n)
    below = (np.concatenate(cols) if n else np.zeros(0, np.int64))
    owner = np.repeat(np.arange(n, dtype=np.int64), lens)
    diag = np.arange(n, dtype=np.int64)
    keys = np.concatenate([owner * n + below,         # L(below, owner)
                           below * n + owner,         # U(owner, below)
                           diag * n + diag])
    keys.sort()
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, keys // n + 1, 1)
    return np.cumsum(indptr), keys % n


def is_symmetric(n: int, indptr: np.ndarray, indices: np.ndarray) -> bool:
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    cols = np.asarray(indices, dtype=np.int64)
    return np.array_equal(np.sort(rows * n + cols), np.sort(cols * n + rows))


def csc_pattern(n: int, lower_rows, upper_rows):
    """(indptr, rowind) of L+U with the diagonal, rows sorted in each
    column — the layout of the plan's ``pattern``."""
    counts = np.array([len(lo) + len(up) + 1
                       for lo, up in zip(lower_rows, upper_rows)],
                      dtype=np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), counts)
    cols = np.concatenate([np.concatenate([lo, [i], up])
                           for i, (lo, up) in enumerate(zip(lower_rows,
                                                            upper_rows))]
                          ) if n else np.zeros(0, np.int64)
    order = np.lexsort((rows, cols))
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, cols + 1, 1)
    return np.cumsum(indptr), rows[order].astype(np.int64)


def supernodes(n: int, indptr: np.ndarray, rowind: np.ndarray, *,
               max_size: int = 64) -> np.ndarray:
    """(k, 2) [start, end) column ranges of the exact T2 partition of the
    CSC pattern (indptr, rowind), runs cut every ``max_size`` columns."""
    merge = np.zeros(n, dtype=bool)
    below = []
    for j in range(n):
        col = rowind[indptr[j]:indptr[j + 1]]
        below.append(col[np.searchsorted(col, j, side="right"):])
    for j in range(1, n):
        prev, cur = below[j - 1], below[j]
        merge[j] = (len(prev) == len(cur) + 1 and prev[0] == j
                    and np.array_equal(prev[1:], cur))
    ranges = []
    start = 0
    for j in range(1, n + 1):
        if j == n or not merge[j] or j - start == max_size:
            ranges.append((start, j))
            start = j
    return np.array(ranges, dtype=np.int64).reshape(-1, 2)


def levels(n: int, indptr: np.ndarray, rowind: np.ndarray,
           ranges: np.ndarray) -> np.ndarray:
    """(k,) dependency level of each panel of ``ranges``."""
    k = len(ranges)
    sup_of_col = np.repeat(np.arange(k, dtype=np.int64),
                           ranges[:, 1] - ranges[:, 0])
    level = np.zeros(k, dtype=np.int64)
    for p, (s, e) in enumerate(ranges):
        rows = rowind[indptr[s]:indptr[e]]
        deps = sup_of_col[rows[rows < s]]
        if len(deps):
            level[p] = level[deps].max() + 1
    return level


def analysis(n: int, indptr: np.ndarray, indices: np.ndarray, *,
             max_size: int = 64) -> dict:
    """Everything the comparison needs, from the input arrays alone."""
    if is_symmetric(n, indptr, indices):
        cp, ri = symmetric_csc_pattern(
            n, symmetric_columns(n, indptr, indices))
    else:
        cp, ri = csc_pattern(n, *filled_structure(n, indptr, indices))
    ranges = supernodes(n, cp, ri, max_size=max_size)
    return {"indptr": cp, "rowind": ri, "supernodes": ranges,
            "level": levels(n, cp, ri, ranges)}
