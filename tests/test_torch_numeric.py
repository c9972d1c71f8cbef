"""repro_torch numeric path against repro: float64 factors, the float32
kernel backend, zero-pivot attribution, in-place refactorization, segment
batching, and substitution with refinement — all on the CPU."""
import dataclasses

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.sparse import matrices as M
from repro.sparse.numeric import generic_values_csr, lu_nopivot
from repro_torch.sparse.csr import CSRMatrix

# tiny shapes, several pytest workers: one intra-op thread each keeps
# torch's pool from oversubscribing the CPU
torch.set_num_threads(1)

GENERATORS = {
    "grid2d": lambda: M.grid2d_laplacian(10),
    "circuit": lambda: M.circuit_like(120, seed=1),
    "bbd": lambda: M.bordered_block_diagonal(140, block=8, border=12, seed=3),
    "banded": lambda: M.banded_random(120, band=6, seed=2),
    "economic": lambda: M.economic_like(128, block=16, seed=4),
}
_PLANS = {}


def to_port(a):
    return CSRMatrix(n=a.n, indptr=a.indptr.copy(), indices=a.indices.copy())


def plans(gen, **opts):
    """(matrix, repro plan, repro_torch plan) for one generator, cached."""
    key = (gen, tuple(sorted(opts.items())))
    if key not in _PLANS:
        a = GENERATORS[gen]()
        kw = dict(concurrency=64, supernode_relax=1, **opts)
        # the symbolic backend does not change the plan; "dense" compiles
        # fastest in the reference
        ref = repro.analyze(a, repro.LUOptions(backend="dense", **kw))
        port = repro_torch.analyze(to_port(a), repro_torch.LUOptions(**kw),
                                   device="cpu")
        _PLANS[key] = (a, ref, port)
    return _PLANS[key]


def rel(x, y):
    return np.abs(x - y).max() / np.abs(y).max()


def dense_of(a, values):
    out = np.zeros((a.n, a.n))
    rows = np.repeat(np.arange(a.n), np.diff(a.indptr))
    out[rows, a.indices] = values
    return out


@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_float64_factors_match_reference(gen):
    a, ref, port = plans(gen)
    values = generic_values_csr(a)
    fr, fp = ref.factorize(values), port.factorize(values)
    assert port.schedule.n_levels == ref.schedule.n_levels
    assert rel(fp.l, fr.l) <= 1e-12 and rel(fp.u, fr.u) <= 1e-12
    assert fp.num.n_updates == fr.num.n_updates
    assert fp.num.gemm_flops == fr.num.gemm_flops
    assert fp.store.total_entries == fr.store.total_entries


@pytest.mark.parametrize("gen", ["circuit", "economic", "grid2d"])
def test_kernel_backend_within_float32(gen):
    a, _, port = plans(gen, numeric_backend="kernel")
    values = generic_values_csr(a)
    fp = port.factorize(values)
    l0, u0 = lu_nopivot(dense_of(a, values))
    assert rel(fp.l, l0) <= 1e-4 and rel(fp.u, u0) <= 1e-4


@pytest.mark.parametrize("gen", ["circuit", "bbd"])
def test_zero_pivot_names_column_panel_level(gen):
    a, ref, port = plans(gen)
    values = generic_values_csr(a)
    col = a.n // 2
    diag = a.indptr[col] + np.searchsorted(a.row(col), col)
    values[diag] = np.nan
    errs = []
    for plan, exc in ((ref, repro.sparse.numeric.ZeroPivotError),
                      (port, repro_torch.ZeroPivotError)):
        with pytest.raises(exc) as info:
            plan.factorize(values)
        errs.append((info.value.k, info.value.panel, info.value.level))
    assert errs[0] == errs[1]
    assert errs[1][0] == col


def test_zero_pivot_exact_zero_at_column_zero():
    a = M.indefinite(60, seed=1)
    values = M.indefinite_values_csr(a)
    port = repro_torch.analyze(to_port(a), repro_torch.LUOptions(
        concurrency=64), device="cpu")
    with pytest.raises(repro_torch.ZeroPivotError) as info:
        port.factorize(values)
    assert (info.value.k, info.value.panel, info.value.level) == (0, 0, 0)
    assert "column 0" in str(info.value)


def test_refactorize_reuses_buffers_in_place():
    a, _, port = plans("bbd")
    f1 = port.factorize(generic_values_csr(a, seed=1))
    flat = f1.store.flat
    ptr = flat.data_ptr()
    f2 = f1.refactorize(generic_values_csr(a, seed=2))
    assert f2.store.flat.data_ptr() == ptr and f2.store is f1.store
    fresh = port.factorize(generic_values_csr(a, seed=2))
    assert torch.equal(f2.store.flat, fresh.store.flat)


@pytest.mark.parametrize("gen", ["bbd", "grid2d"])
@pytest.mark.parametrize("backend", ["numpy", "kernel"])
def test_segment_batch_matches_per_panel(backend, gen):
    """Stacking same-shape panel GEMMs of a level changes nothing, bitwise,
    on both backends, as in the reference: K4 slices are K3 (float32 and
    float64), and on the CPU the plain K4 loops over the slices with the
    per-panel ``acc - lp @ b``."""
    a, _, port = plans(gen, numeric_backend=backend)
    values = generic_values_csr(a)
    batched = port.factorize(values)
    off = dataclasses.replace(
        port, options=port.options.replace(segment_batch=False))
    single = off.factorize(values)
    assert torch.equal(batched.store.flat, single.store.flat)


@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_solve_residual_and_history(gen):
    a, _, port = plans(gen)
    values = generic_values_csr(a)
    factor = port.factorize(values)
    dense = dense_of(a, values)
    rng = np.random.default_rng(5)
    b1 = rng.standard_normal(a.n)
    bk = rng.standard_normal((a.n, 3))
    for b in (b1, bk):
        for batched in (None, True, False):
            res = factor.solve(b, batched=batched)
            assert res.x.shape == b.shape and res.x.dtype == torch.float64
            assert res.residual <= 1e-10
            assert all(x >= y for x, y in zip(res.residuals,
                                              res.residuals[1:]))
            x_ref = np.linalg.solve(dense, b)
            assert rel(res.x.numpy(), x_ref) <= 1e-10


def test_refinement_accepts_only_improvements():
    """With a perturbed factor the first solve is poor; refinement must
    improve it and keep the history non-increasing."""
    a, _, port = plans("circuit", numeric_backend="kernel")
    values = generic_values_csr(a)
    factor = port.factorize(values)
    b = np.random.default_rng(0).standard_normal((a.n, 2))
    res = factor.solve(b, refine_tol=0.0, refine_iters=3)
    assert res.residuals[0] > 1e-10 >= res.residual
    assert res.refine_accepted >= 1
    assert all(x >= y for x, y in zip(res.residuals, res.residuals[1:]))
