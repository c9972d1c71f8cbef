"""The HPCG benchmark's matrix, in nested-dissection order.

HPCG (Heroux, Dongarra, Luszczek, "HPCG Technical Specification", Sandia
report SAND2013-8752, 2013; ``GenerateProblem_ref.cpp``) discretizes a 3-D
diffusion problem with a 27-point stencil on an ``nx`` x ``ny`` x ``nz``
grid: point (ix, iy, iz) is row ``iz*nx*ny + iy*nx + ix`` and is coupled to
every grid point whose coordinates differ by at most 1 in each direction
(itself included).  The structure is symmetric.

A direct solver orders such a matrix by nested dissection before its
symbolic analysis (George, "Nested dissection of a regular finite element
mesh", SIAM J. Numer. Anal. 10, 1973): a box of the grid is cut through the
middle of its longest side by one plane of points (the separator; one plane
separates a 27-point stencil), the two halves are ordered the same way, one
after the other, and the separator comes last.  The seed picks which half
comes first and, between sides of equal length, which is cut: choices that
leave the fill as it is, up to the few entries an uneven cut moves, but give
different arrays, so every pattern is one the program has not seen before.
"""
from __future__ import annotations

import numpy as np

from portbench.csr import csr_from_coo


def stencil27(nx: int, ny: int, nz: int):
    """(rows, cols) of HPCG's 27-point couplings, diagonal included, in its
    lexicographic numbering."""
    idx = np.arange(nx * ny * nz, dtype=np.int64).reshape(nz, ny, nx)
    rows, cols = [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                lo = (max(0, -dz), max(0, -dy), max(0, -dx))
                hi = (nz - max(0, dz), ny - max(0, dy), nx - max(0, dx))
                here = idx[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
                there = idx[lo[0] + dz:hi[0] + dz, lo[1] + dy:hi[1] + dy,
                            lo[2] + dx:hi[2] + dx]
                rows.append(here.ravel())
                cols.append(there.ravel())
    return np.concatenate(rows), np.concatenate(cols)


def nested_dissection(nx: int, ny: int, nz: int, rng) -> np.ndarray:
    """``order[k]``: the lexicographic label of the point placed k-th."""
    out = []
    boxes = [np.arange(nx * ny * nz, dtype=np.int64).reshape(nz, ny, nx)]
    # depth first, each box's first half, second half, then its separator:
    # a stack of boxes still to order and separators already cut
    while boxes:
        box = boxes.pop()
        if isinstance(box, tuple):          # a separator, placed now
            out.append(box[0])
            continue
        if box.size <= 1:
            out.append(box.ravel())
            continue
        longest = np.flatnonzero(np.array(box.shape) == max(box.shape))
        axis = int(rng.choice(longest))
        mid = box.shape[axis] // 2
        halves = [np.take(box, np.arange(mid), axis=axis),
                  np.take(box, np.arange(mid + 1, box.shape[axis]),
                          axis=axis)]
        if rng.random() < 0.5:
            halves.reverse()
        sep = np.take(box, [mid], axis=axis).ravel()
        boxes.extend([(sep,), halves[1], halves[0]])
    return np.concatenate(out)


def generate(seed: int, *, nx: int, ny: int, nz: int):
    n = nx * ny * nz
    rows, cols = stencil27(nx, ny, nz)
    order = nested_dissection(nx, ny, nz, np.random.default_rng(seed))
    new = np.empty(n, dtype=np.int64)
    new[order] = np.arange(n, dtype=np.int64)
    return (n, *csr_from_coo(n, new[rows], new[cols]))
