"""The yardstick of the kernels' roofline shares: peaks of one H100 and the
work each kernel's job needs, counted from the pattern, not from how the
program happens to implement it.

* K1 (``kernels/csrc/minmax_relax.cu``) does one relaxation superstep of a
  chunk of the fixpoint.  What the relaxation needs, whatever implements
  it: the chunk's (S, n) int32 propagation values read once, the pattern's
  off-diagonal edges read once as CSR (4 bytes an edge and 4 bytes a row
  pointer), the (S, n) int32 candidates written once, and one min per
  (source, edge).  The dense (n_pad, n_pad) adjacency today's kernel reads
  is not counted: a kernel that skips empty tiles must not read above 100 %
  of this bound.
* K2 (``kernels/csrc/column_fingerprints.cu``) folds a converged chunk into
  the column fingerprints: a frozen copy of
  ``repro_torch.kernels.work.column_fingerprints_work``, whose count does
  not depend on the implementation.

S counts the chunk's real sources: the padding the driver repeats to fill
the last chunk is not work the analysis needs.
"""
from __future__ import annotations

import numpy as np

# NVIDIA's data sheet, H100 SXM (80 GB HBM3) at its 700 W limit
PEAK_BYTES_PER_S = 3.35e12
# the operation rate PERF.md's kernel table takes for integer work: the
# card's 67 TFLOP/s float32 outside the tensor cores (its int32 rate is no
# higher, so a share against it is never overstated)
PEAK_OPS_PER_S = 67e12


def k1_relax_work(s: int, n: int, edges: int):
    """(bytes, int ops) of one relaxation superstep over ``s`` sources of an
    n-vertex pattern with ``edges`` off-diagonal entries."""
    return 4 * s * n + (4 * edges + 4 * (n + 1)) + 4 * s * n, s * edges


def k2_fingerprint_work(s: int, v: int):
    """(bytes, int ops) of one fingerprint fold: rel (S, V) and the four
    (S,) lanes read, the (3, V) fingerprints written; two compares per
    (row, column)."""
    return 4 * s * v + 4 * 4 * s + 3 * v * 4, 2 * s * v


def least_seconds(nbytes: float, ops: float) -> float:
    """The least time the card could take: bytes at peak bandwidth or
    operations at peak rate, whichever is longer."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S)


def offdiag_edges(a) -> int:
    """Off-diagonal entries of a CSR pattern (``n``, ``indptr``,
    ``indices``): the edges a relaxation walks."""
    rows = np.repeat(np.arange(a.n), np.diff(a.indptr))
    return int(np.count_nonzero(np.asarray(a.indices) != rows))


def chunk_sources(n: int, concurrency: int):
    """Real sources of each chunk of the fixpoint: ``concurrency`` each, the
    remainder in the last."""
    full, rest = divmod(n, concurrency)
    return [concurrency] * full + ([rest] if rest else [])
