"""The comparison that decides ``correct``: what the timed ``analyze``
produced against the plain reference (``portbench/reference``), for every
analysis of the window.

Three counts, each summed over the analyses compared, each with the limit
0 (an exact comparison):

* ``pattern_mismatch``: entries in one L+U pattern and not the other;
* ``supernode_mismatch``: supernode start columns in one partition and not
  the other;
* ``level_mismatch``: columns whose panel sits at another dependency level.
"""
from __future__ import annotations

import numpy as np

LIMITS = {"pattern_mismatch": 0, "supernode_mismatch": 0,
          "level_mismatch": 0}


def _keys(n, indptr, rowind):
    cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    return np.asarray(rowind, dtype=np.int64) * n + cols


def _column_levels(n, ranges, level):
    ranges = np.asarray(ranges, dtype=np.int64).reshape(-1, 2)
    widths = ranges[:, 1] - ranges[:, 0]
    level = np.asarray(level, dtype=np.int64)
    if (len(level) != len(ranges) or widths.sum() != n or (widths < 1).any()
            or ranges[0, 0] != 0
            or (ranges[1:, 0] != ranges[:-1, 1]).any()):
        return None                      # not a partition of the columns
    return np.repeat(level, widths)


def mismatches(n: int, prog: dict, ref: dict) -> dict:
    """Counts of one analysis.  ``prog`` and ``ref`` hold ``indptr`` and
    ``rowind`` (CSC pattern of L+U, diagonal included), ``supernodes``
    ((k, 2) [start, end) ranges) and ``level`` ((k,) per panel)."""
    if (np.array_equal(prog["indptr"], ref["indptr"])
            and np.array_equal(prog["rowind"], ref["rowind"])):
        pattern = 0
    else:
        pattern = len(np.setxor1d(_keys(n, prog["indptr"], prog["rowind"]),
                                  _keys(n, ref["indptr"], ref["rowind"])))
    supern = len(np.setxor1d(np.asarray(prog["supernodes"])[:, 0],
                             np.asarray(ref["supernodes"])[:, 0]))
    lp = _column_levels(n, prog["supernodes"], prog["level"])
    lr = _column_levels(n, ref["supernodes"], ref["level"])
    level = n if lp is None else int(np.count_nonzero(lp != lr))
    return {"pattern_mismatch": int(pattern), "supernode_mismatch": supern,
            "level_mismatch": level}


def total(counts: list) -> dict:
    return {k: sum(c[k] for c in counts) for k in LIMITS}


def passed(totals: dict) -> bool:
    return all(totals[k] <= lim for k, lim in LIMITS.items())
