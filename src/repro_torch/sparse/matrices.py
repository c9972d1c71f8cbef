"""Synthetic sparse-matrix generators.

The paper evaluates on 14 SuiteSparse matrices (Table I).  This container has no
network access, so we synthesize *analogues* that match the application domains
and the structural statistics that matter to the algorithm under test:
order, nnz/row, structural symmetry, and fill-heaviness.  `PAPER_DATASETS`
maps the paper's dataset codes to scaled-down analogues with the same character.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.sparse.csr import CSRMatrix, csr_from_coo


def _with_diagonal(n: int, rows, cols):
    rows = np.concatenate([np.asarray(rows, dtype=np.int64),
                           np.arange(n, dtype=np.int64)])
    cols = np.concatenate([np.asarray(cols, dtype=np.int64),
                           np.arange(n, dtype=np.int64)])
    return rows, cols


def grid2d_laplacian(nx: int, ny: int | None = None) -> CSRMatrix:
    """5-point stencil on an nx × ny grid — structural-problem analogue (BC, AU)."""
    ny = ny or nx
    idx = np.arange(nx * ny).reshape(nx, ny)
    rows, cols = [], []
    for di, dj in ((0, 1), (1, 0)):
        a = idx[: nx - di, : ny - dj].ravel()
        b = idx[di:, dj:].ravel()
        rows += [a, b]
        cols += [b, a]
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    rows, cols = _with_diagonal(nx * ny, rows, cols)
    return csr_from_coo(nx * ny, rows, cols)


def grid3d_laplacian(nx: int, ny: int | None = None,
                     nz: int | None = None) -> CSRMatrix:
    """7-point stencil — CFD/electromagnetics analogue (RM, DI)."""
    ny = ny or nx
    nz = nz or nx
    idx = np.arange(nx * ny * nz).reshape(nx, ny, nz)
    rows, cols = [], []
    for d in ((0, 0, 1), (0, 1, 0), (1, 0, 0)):
        a = idx[: nx - d[0], : ny - d[1], : nz - d[2]].ravel()
        b = idx[d[0]:, d[1]:, d[2]:].ravel()
        rows += [a, b]
        cols += [b, a]
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    rows, cols = _with_diagonal(nx * ny * nz, rows, cols)
    return csr_from_coo(nx * ny * nz, rows, cols)


def circuit_like(n: int, *, avg_deg: float = 4.0, hub_fraction: float = 0.002,
                 hub_deg: int = 64, seed: int = 0) -> CSRMatrix:
    """Circuit-simulation analogue (G3, HM, PR, TT): sparse, a few high-degree
    rails (power/ground nets), low-ish structural symmetry."""
    rng = np.random.default_rng(seed)
    m = int(n * avg_deg)
    rows = rng.integers(0, n, size=m)
    cols = rng.integers(0, n, size=m)
    # local coupling: most connections are near-diagonal (placement locality)
    local = rng.integers(0, n, size=m)
    off = rng.integers(1, max(2, n // 100), size=m)
    rows = np.concatenate([rows, local])
    cols = np.concatenate([cols, np.minimum(n - 1, local + off)])
    n_hubs = max(1, int(n * hub_fraction))
    hubs = rng.choice(n, size=n_hubs, replace=False)
    hub_deg = min(hub_deg, n // 2)
    for h in hubs:
        tied = rng.choice(n, size=hub_deg, replace=False)
        rows = np.concatenate([rows, np.full(hub_deg, h), tied])
        cols = np.concatenate([cols, tied, np.full(hub_deg, h)])
    rows, cols = _with_diagonal(n, rows, cols)
    return csr_from_coo(n, rows, cols)


def economic_like(n: int, *, block: int = 32, coupling: float = 3.0,
                  seed: int = 0) -> CSRMatrix:
    """Economic-modelling analogue (G7, MK): highly *asymmetric* block couplings
    (struct. symm ~0.03-0.07 in Table I)."""
    rng = np.random.default_rng(seed)
    m = int(n * coupling)
    # directed inter-block flows: i in block b reads from block b' (one-way)
    rows = rng.integers(0, n, size=m)
    shift = (rng.integers(1, max(2, n // block), size=m) * block)
    cols = (rows + shift) % n
    # sparse intra-block (bidirectional, small)
    r2 = rng.integers(0, n, size=m // 4)
    c2 = (r2 // block) * block + rng.integers(0, block, size=m // 4)
    c2 = np.minimum(c2, n - 1)
    rows = np.concatenate([rows, r2, c2])
    cols = np.concatenate([cols, c2, r2])
    rows, cols = _with_diagonal(n, rows, cols)
    return csr_from_coo(n, rows, cols)


def chemical_like(n: int, *, stage: int = 24, seed: int = 0) -> CSRMatrix:
    """Chemical-engineering analogue (LH): cascaded stages, near-zero symmetry."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for s in range(0, n - stage, stage):
        # each stage couples forward into the next stage only (flowsheet)
        r = np.repeat(np.arange(s, s + stage), 3)
        c = s + stage + rng.integers(0, stage, size=3 * stage)
        c = np.minimum(c, n - 1)
        rows.append(r)
        cols.append(c)
        # dense-ish lower stage block
        r2 = s + rng.integers(0, stage, size=4 * stage)
        c2 = s + rng.integers(0, stage, size=4 * stage)
        rows.append(r2)
        cols.append(c2)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    rows, cols = _with_diagonal(n, rows, cols)
    return csr_from_coo(n, rows, cols)


def random_pattern(n: int, *, density: float = 0.01, symmetric: bool = False,
                   seed: int = 0) -> CSRMatrix:
    rng = np.random.default_rng(seed)
    m = max(n, int(n * n * density))
    rows = rng.integers(0, n, size=m)
    cols = rng.integers(0, n, size=m)
    if symmetric:
        rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
    rows, cols = _with_diagonal(n, rows, cols)
    return csr_from_coo(n, rows, cols)


def banded_full(n: int, *, band: int = 8) -> CSRMatrix:
    """Full band of half-width ``band`` (every |i-j| <= band present).

    No-pivot LU of a dense band fills nothing outside it, so the filled
    L+U pattern is the matrix's own pattern
    (``numeric.storage.CSCPattern.banded`` is the exact prediction) — the
    large-n generator for exercising the packed O(nnz(L+U)) numeric path
    without a dense symbolic pass."""
    offs = np.arange(-band, band + 1)
    rows = np.repeat(np.arange(n), len(offs))
    cols = rows + np.tile(offs, n)
    keep = (cols >= 0) & (cols < n)
    return csr_from_coo(n, rows[keep], cols[keep])


def bordered_block_diagonal(n: int, *, block: int = 16, border: int = 64,
                            couple: int = 4, seed: int = 0) -> CSRMatrix:
    """Bordered block-diagonal (BBD) matrix: independent dense-ish diagonal
    blocks plus ``border`` global rail rows/columns at the *end* of the
    index space, each coupled to ``couple`` random interior positions.

    This is the canonical partitioned-circuit structure (SPICE-style BBD
    ordering): fill stays O(nnz) — confined to the blocks, the rail
    rows/columns, and the border corner — and the graph diameter is tiny
    (any interior vertex reaches anything else only through the rails), so
    the symbolic fixpoint converges in a handful of supersteps at any n.
    The large-n generator for driving the full analyze -> refactorize
    pipeline end to end."""
    rng = np.random.default_rng(seed)
    interior = n - border
    if interior <= 0:
        raise ValueError(f"need n > border, got n={n} border={border}")
    # dense-ish random blocks: ~3 entries per row inside each block
    b_rows = rng.integers(0, interior, size=3 * interior)
    b_cols = ((b_rows // block) * block
              + rng.integers(0, block, size=3 * interior))
    b_cols = np.minimum(b_cols, interior - 1)
    # rails: border row h couples symmetrically to `couple` interior spots
    rails = np.repeat(np.arange(interior, n), couple)
    tied = rng.integers(0, interior, size=border * couple)
    rows = np.concatenate([b_rows, b_cols, rails, tied])
    cols = np.concatenate([b_cols, b_rows, tied, rails])
    rows, cols = _with_diagonal(n, rows, cols)
    return csr_from_coo(n, rows, cols)


def banded_random(n: int, *, band: int = 8, fill: float = 0.5,
                  seed: int = 0) -> CSRMatrix:
    rng = np.random.default_rng(seed)
    m = int(n * band * fill)
    rows = rng.integers(0, n, size=m)
    off = rng.integers(-band, band + 1, size=m)
    cols = np.clip(rows + off, 0, n - 1)
    rows, cols = _with_diagonal(n, rows, cols)
    return csr_from_coo(n, rows, cols)


def indefinite(n: int, *, band: int = 8, fill: float = 0.7,
               seed: int = 0) -> CSRMatrix:
    """Symmetric-structure banded pattern for *indefinite* systems
    (saddle-point / KKT character).  The pattern alone is unremarkable —
    pair it with ``indefinite_values_csr``, which mixes signs and zeroes
    out periodic diagonal entries so the pivot-free sweep fails without
    the robust tier (``LUOptions(pivot="static", perturb=True)``)."""
    rng = np.random.default_rng(seed)
    m = int(n * band * fill)
    rows = rng.integers(0, n, size=m)
    off = rng.integers(1, band + 1, size=m) * rng.choice([-1, 1], size=m)
    cols = np.clip(rows + off, 0, n - 1)
    rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
    rows, cols = _with_diagonal(n, rows, cols)
    return csr_from_coo(n, rows, cols)


def indefinite_values_csr(a: CSRMatrix, *, zero_diag_period: int = 7,
                          seed: int = 0) -> np.ndarray:
    """CSR-aligned values that make ``indefinite`` live up to its name:
    sign-mixed off-diagonals, small non-dominant diagonals, and every
    ``zero_diag_period``-th diagonal entry (including column 0) exactly
    zero — so plain no-pivot elimination hits an exact zero pivot at
    column 0 while the matrix itself stays generically nonsingular."""
    rng = np.random.default_rng(seed)
    vals = np.empty(a.nnz, dtype=np.float64)
    for i in range(a.n):
        lo, hi = int(a.indptr[i]), int(a.indptr[i + 1])
        cols = a.row(i)
        v = (rng.uniform(0.5, 1.5, size=len(cols))
             * rng.choice([-1.0, 1.0], size=len(cols)))
        d = np.searchsorted(cols, i)
        if d >= len(cols) or cols[d] != i:
            raise ValueError(f"indefinite_values_csr needs a structural "
                             f"diagonal; row {i} has none")
        if i % zero_diag_period == 0:
            v[d] = 0.0
        else:
            v[d] = float(rng.uniform(0.05, 0.2)) * (1.0 if v[d] >= 0 else -1.0)
        vals[lo:hi] = v
    return vals


def _shuffled_dominant_system(n: int, band: int, shift: int | None,
                              seed: int):
    """Shared builder: a diagonally dominant banded system whose rows are
    rotated by ``shift`` — dominance lands on an off-diagonal stripe, and
    any row whose original diagonal fell outside the band after rotation
    gets a *structural* diagonal entry holding an exact 0.0 (so the seed
    no-pivot path dies on an exact zero pivot, not just a tiny one)."""
    from repro_torch.sparse.numeric import generic_values_csr
    if shift is None:
        shift = band + 3
    base = banded_random(n, band=band, fill=0.9, seed=seed)
    vals = generic_values_csr(base, seed=seed)
    row_of = np.repeat(np.arange(n, dtype=np.int64), np.diff(base.indptr))
    new_rows = (row_of - shift) % n
    cols = base.indices.astype(np.int64)
    have_diag = np.zeros(n, dtype=bool)
    have_diag[new_rows[new_rows == cols]] = True
    miss = np.flatnonzero(~have_diag)
    rows_all = np.concatenate([new_rows, miss])
    cols_all = np.concatenate([cols, miss])
    vals_all = np.concatenate([vals, np.zeros(len(miss))])
    order = np.lexsort((cols_all, rows_all))
    rows_all, cols_all, vals_all = (rows_all[order], cols_all[order],
                                    vals_all[order])
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, rows_all + 1, 1)
    a = CSRMatrix(n=n, indptr=np.cumsum(indptr),
                  indices=cols_all.astype(np.int32))
    return a, vals_all


def shuffled_dominant(n: int, *, band: int = 6, shift: int | None = None,
                      seed: int = 0) -> CSRMatrix:
    """Row-rotated diagonally dominant band: structurally every diagonal is
    present, but with ``shuffled_dominant_values_csr`` the dominant entries
    sit ``shift`` positions off the diagonal and several diagonal values
    are exact zeros.  The max-product transversal recovers the rotation
    exactly, making this the canonical static-pivoting rescue case."""
    return _shuffled_dominant_system(n, band, shift, seed)[0]


def shuffled_dominant_values_csr(a: CSRMatrix, *, band: int = 6,
                                 shift: int | None = None,
                                 seed: int = 0) -> np.ndarray:
    """Values matching ``shuffled_dominant`` called with the same
    (n, band, shift, seed) — the two are views of one rotated system."""
    mat, vals = _shuffled_dominant_system(a.n, band, shift, seed)
    if mat.nnz != a.nnz or not np.array_equal(mat.indices, a.indices):
        raise ValueError("pattern was not produced by shuffled_dominant with "
                         "the same (n, band, shift, seed)")
    return vals


# ---------------------------------------------------------------------------
# Paper Table I analogues (scaled to CPU-tractable sizes, same character).
# key: (generator, kwargs, description)
# ---------------------------------------------------------------------------
PAPER_DATASETS: Dict[str, tuple] = {
    "BB": (grid3d_laplacian, dict(nx=12), "CFD analogue of BBMAT"),
    "BC": (grid2d_laplacian, dict(nx=40), "structural analogue of BCSSTK18"),
    "EP": (grid2d_laplacian, dict(nx=36, ny=28), "thermal analogue of EPB2"),
    "G7": (economic_like, dict(n=1536, seed=7), "economic analogue of G7JAC200SC"),
    "LH": (chemical_like, dict(n=1800, seed=3), "chem-eng analogue of LHR71C"),
    "MK": (economic_like, dict(n=1280, block=16, seed=11),
           "economic analogue of MARK3JAC140SC"),
    "RM": (grid3d_laplacian, dict(nx=11), "CFD analogue of RMA10"),
    "AU": (grid3d_laplacian, dict(nx=13), "structural analogue of AUDIKW_1"),
    "DI": (grid3d_laplacian, dict(nx=12, ny=12, nz=10),
           "EM analogue of DIELFILTERV2REAL"),
    "G3": (circuit_like, dict(n=2048, seed=5), "circuit analogue of G3_CIRCUIT"),
    "HM": (circuit_like, dict(n=2048, avg_deg=2.0, seed=9),
           "circuit analogue of HAMRLE3"),
    "PR": (circuit_like, dict(n=1600, hub_deg=96, seed=13), "circuit analogue of PRE2"),
    "ST": (grid3d_laplacian, dict(nx=12, ny=11, nz=11),
           "bioengineering analogue of STOMACH"),
    "TT": (circuit_like, dict(n=1200, avg_deg=5.0, seed=17),
           "circuit analogue of TWOTONE"),
}


def paper_dataset_analogue(code: str) -> CSRMatrix:
    gen, kwargs, _ = PAPER_DATASETS[code]
    return gen(**kwargs)
