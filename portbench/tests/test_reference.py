"""The plain reference against a brute-force oracle, and the port (on the
CPU) against the reference."""
import numpy as np
import pytest

from portbench import compare, layout
from portbench.csr import csr_from_coo, with_diagonal
from portbench.reference import structure as reference


def dense_fill(n, indptr, indices):
    """The elimination game on a dense bool matrix: eliminating k joins
    every row below k holding column k to every column right of k that
    row k holds."""
    m = np.zeros((n, n), dtype=bool)
    m[np.repeat(np.arange(n), np.diff(indptr)), indices] = True
    for k in range(n):
        r = np.flatnonzero(m[k + 1:, k]) + k + 1
        c = np.flatnonzero(m[k, k + 1:]) + k + 1
        m[np.ix_(r, c)] = True
    return m


def random_pattern(n, density, seed):
    rng = np.random.default_rng(seed)
    m = rng.random((n, n)) < density
    np.fill_diagonal(m, True)
    rows, cols = np.nonzero(m)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    return np.cumsum(indptr), cols.astype(np.int32)


def banded(n, seed, band=6, per_row=3):
    """A nonsymmetric pattern: each row ``per_row`` random entries within
    ``band`` of the diagonal, and the diagonal."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    cols = np.clip(rows + rng.integers(-band, band + 1, size=len(rows)), 0,
                   n - 1)
    indptr, indices = csr_from_coo(n, *with_diagonal(n, rows, cols))
    return n, indptr, indices


def small(name, n, seed):
    if name == "banded":
        return banded(n, seed)
    side = round(n ** (1 / 3))
    return layout.module("generators", name).generate(
        seed, nx=side, ny=side + 1, nz=side - 1)


def symmetric_random(n, density, seed):
    indptr, indices = random_pattern(n, density, seed)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    keys = np.unique(np.r_[rows * n + indices, indices * n + rows])
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, keys // n + 1, 1)
    return np.cumsum(indptr), (keys % n).astype(np.int32)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("density", [0.02, 0.05])
def test_symmetric_path_matches_elimination_game(seed, density):
    n = 80
    indptr, indices = symmetric_random(n, density, seed)
    assert reference.is_symmetric(n, indptr, indices)
    cp, ri = reference.symmetric_csc_pattern(
        n, reference.symmetric_columns(n, indptr, indices))
    m = dense_fill(n, indptr, indices)
    assert len(ri) == int(m.sum())
    rows_of = np.split(ri, cp[1:-1])
    for j in range(n):
        assert rows_of[j].tolist() == np.flatnonzero(m[:, j]).tolist()


@pytest.mark.parametrize("seed", [3, 2**31 + 9])
def test_symmetric_path_matches_the_row_wise_one(seed):
    n, indptr, indices = small("hpcg27", 343, seed)
    assert reference.is_symmetric(n, indptr, indices)
    want = reference.csc_pattern(
        n, *reference.filled_structure(n, indptr, indices))
    got = reference.symmetric_csc_pattern(
        n, reference.symmetric_columns(n, indptr, indices))
    assert all(np.array_equal(w, g) for w, g in zip(want, got))
    assert not reference.is_symmetric(*small("banded", 120, seed))


def test_hpcg27_stencil_and_order():
    gen = layout.module("generators", "hpcg27")
    rows, cols = gen.stencil27(3, 4, 5)
    # interior points couple to 27, corners to 8
    per_row = np.bincount(rows, minlength=60)
    assert per_row.max() == 27 and per_row.min() == 8
    assert len(rows) == len(set(zip(rows.tolist(), cols.tolist())))
    order = gen.nested_dissection(6, 5, 7, np.random.default_rng(1))
    assert sorted(order.tolist()) == list(range(210))
    # two seeds: the same couplings, renumbered, in different arrays
    a = gen.generate(4, nx=6, ny=5, nz=7)
    b = gen.generate(5, nx=6, ny=5, nz=7)
    assert a[0] == b[0] == 210
    assert len(a[2]) == len(b[2]) == len(gen.stencil27(6, 5, 7)[0])
    assert not (np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2]))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("density", [0.02, 0.06])
def test_structure_matches_elimination_game(seed, density):
    n = 70
    indptr, indices = random_pattern(n, density, seed)
    lower, upper = reference.filled_structure(n, indptr, indices)
    m = dense_fill(n, indptr, indices)
    for i in range(n):
        want = np.flatnonzero(m[i])
        want = want[want != i]
        got = np.concatenate([lower[i], upper[i]])
        assert got.tolist() == want.tolist(), i
    cp, ri = reference.csc_pattern(n, lower, upper)
    assert len(ri) == int(m.sum())
    rows_of = np.split(ri, cp[1:-1])
    for j in range(n):
        assert rows_of[j].tolist() == np.flatnonzero(m[:, j]).tolist()


@pytest.mark.parametrize("name", ["banded", "hpcg27"])
def test_generated_structure_matches_elimination_game(name):
    n, indptr, indices = small(name, 120, 5)
    lower, upper = reference.filled_structure(n, indptr, indices)
    m = dense_fill(n, indptr, indices)
    np.fill_diagonal(m, False)
    assert sum(len(x) for x in lower) == int(np.tril(m).sum())
    assert sum(len(x) for x in upper) == int(np.triu(m).sum())


def test_supernodes_and_levels_by_hand():
    # eliminating 0 fills (1, 2); then column 0 holds rows {1, 2} below
    # it, column 1 {2}, column 2 none, each with its subdiagonal entry:
    # one supernode (0, 3); column 3 has no L(3, 2), so (3, 4) alone
    dense = np.array([[1, 0, 1, 0],
                      [1, 1, 0, 0],
                      [1, 1, 1, 1],
                      [0, 0, 0, 1]], dtype=bool)
    n = 4
    rows, cols = np.nonzero(dense)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    ref = reference.analysis(n, np.cumsum(indptr), cols.astype(np.int32))
    assert ref["supernodes"].tolist() == [[0, 3], [3, 4]]
    # panel (3, 4) holds U(2, 3), a row of panel 0
    assert ref["level"].tolist() == [0, 1]
    cut = reference.supernodes(n, ref["indptr"], ref["rowind"], max_size=2)
    assert cut.tolist() == [[0, 2], [2, 3], [3, 4]]
    assert reference.levels(n, ref["indptr"], ref["rowind"],
                            cut).tolist() == [0, 1, 2]


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 5])
@pytest.mark.parametrize("name,backend", [
    ("banded", "ell"), ("banded", "kernel"), ("hpcg27", "ell"),
    ("hpcg27", "kernel")])
def test_port_matches_reference(name, backend, seed):
    import repro_torch
    from repro_torch.sparse.csr import CSRMatrix

    from portbench.drivers.analyze_stream import extract, pattern_seed

    n = 300 if backend == "kernel" or name == "hpcg27" else 1100
    n, indptr, indices = small(name, n, pattern_seed(seed, 1))
    plan = repro_torch.analyze(
        CSRMatrix(n=n, indptr=indptr, indices=indices),
        repro_torch.LUOptions(concurrency=512, backend=backend),
        device="cpu")
    ref = reference.analysis(n, indptr, indices)
    assert compare.mismatches(n, extract(plan), ref) == {
        "pattern_mismatch": 0, "supernode_mismatch": 0, "level_mismatch": 0}
    assert plan.lu_nnz == len(ref["rowind"])


def test_reference_imports_nothing_of_the_program():
    import ast
    from pathlib import Path

    for path in Path(reference.__file__).parent.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                assert name.split(".")[0] in ("numpy", "heapq",
                                              "__future__"), (path, name)
