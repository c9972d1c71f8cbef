"""repro_torch's batched tier (many value sets on one plan) on the CPU.

Contract: ``plan.factorize_batch`` / ``BatchedLUFactorization.solve_batch``
give every system the factors, solution, residual history and accepted
count of the port's sequential ``plan.factorize(values[i])`` /
``.solve(b[i])``, bitwise, on both numeric backends and with segment
batching on and off; the factors agree with the reference's batched sweep
(float64 within 1e-10, the float32 kernel backend within 1e-4 relative,
the port's stated float32 tolerance); errors name the failing system as
the reference's do.  The reference's sweep runs on the port plan's
pattern and supernodes (``ref_factor_batch``): the two plans' structures
are bitwise equal (``test_torch_symbolic.py``), and skipping the
reference's fixpoint keeps this file fast."""
import dataclasses

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.sparse import matrices as M
from repro.sparse import permute_csr, rcm_order
from repro.sparse.numeric import generic_values_csr
from repro_torch.kernels import ops as kops
from repro_torch.kernels import plain as kplain
from repro_torch.sparse.csr import CSRMatrix

# tiny shapes, several pytest workers: one intra-op thread each keeps
# torch's pool from oversubscribing the CPU
torch.set_num_threads(1)

# every generator in sparse/matrices.py, at n <= 400
GENERATORS = {
    "grid2d": lambda: M.grid2d_laplacian(14),
    "grid3d": lambda: M.grid3d_laplacian(6),
    "circuit": lambda: M.circuit_like(300, seed=7),
    "economic": lambda: M.economic_like(256, block=16, seed=2),
    "chemical": lambda: M.chemical_like(320, stage=16, seed=3),
    "banded": lambda: M.banded_random(240, band=6, seed=4),
    "banded_full": lambda: M.banded_full(200, band=5),
    "random": lambda: M.random_pattern(160, density=0.02, seed=5),
    "bbd": lambda: M.bordered_block_diagonal(384, block=16, border=32,
                                             seed=6),
    "indefinite": lambda: M.indefinite(160, band=6, seed=1),
    "shuffled": lambda: M.shuffled_dominant(160, band=5, seed=2),
}
OPTS = dict(concurrency=64, supernode_relax=2)
BATCH = 3
_PLANS = {}


def to_port(a):
    return CSRMatrix(n=a.n, indptr=a.indptr.copy(), indices=a.indices.copy())


def plans(name):
    """(matrix, repro_torch plan) for one generator, cached."""
    if name not in _PLANS:
        a = GENERATORS[name]()
        a = permute_csr(a, rcm_order(a))
        port = repro_torch.analyze(to_port(a), repro_torch.LUOptions(**OPTS),
                                   device="cpu")
        _PLANS[name] = (a, port)
    return _PLANS[name]


def ref_plan(name):
    """The reference's own plan of one generator (its fixpoint; the
    "dense" backend compiles fastest and does not change the plan)."""
    key = ("ref", name)
    if key not in _PLANS:
        a, _ = plans(name)
        _PLANS[key] = repro.analyze(a, repro.LUOptions(backend="dense",
                                                       **OPTS))
    return _PLANS[key]


def ref_factor_batch(name, vb, **kw):
    """The reference's batched sweep (``repro.numeric.supernodal
    .factor_batch_on_store``) on the port plan's pattern and supernodes,
    with the reference's own schedule, store and maps."""
    from repro.numeric.schedule import build_schedule
    from repro.numeric.storage import BatchedPanelStore, CSCPattern, PanelStore
    from repro.numeric.supernodal import factor_batch_on_store

    a, port = plans(name)
    pattern = CSCPattern(n=port.pattern.n, indptr=port.pattern.indptr,
                         rowind=port.pattern.rowind)
    sched = build_schedule(pattern, port.schedule.supernodes)
    bstore = BatchedPanelStore(PanelStore(pattern, sched.supernodes),
                               len(vb))
    return factor_batch_on_store(a, vb, bstore, sched, store_is_zeroed=True,
                                 **kw)


def with_options(plan, **changes):
    """The same analysis under other numeric options."""
    return dataclasses.replace(plan, options=plan.options.replace(**changes))


def values_batch(a, batch=BATCH):
    return np.stack([generic_values_csr(a, seed=s) for s in range(batch)])


def ref_flat(ref_store, i):
    """System i of a reference ``BatchedPanelStore`` in the port's flat
    layout (the blocks' values, panel after panel)."""
    return np.concatenate([b[i].ravel() for b in ref_store.blocks])


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_factorize_batch_bitwise_matches_sequential(name):
    a, port = plans(name)
    vb = values_batch(a)
    ref_bf = ref_factor_batch(name, vb)
    scale = np.abs(vb).max()
    for backend, tol in (("numpy", 1e-10), ("kernel", 1e-4)):
        for segment_batch in (True, False):
            plan = with_options(port, numeric_backend=backend,
                                segment_batch=segment_batch)
            bf = plan.factorize_batch(vb)
            assert isinstance(bf, repro_torch.BatchedLUFactorization)
            assert (bf.batch, bf.n) == (BATCH, plan.n)
            assert bf.num.n_updates == ref_bf.n_updates
            assert bf.num.gemm_flops == ref_bf.gemm_flops
            for i in range(BATCH):
                seq = plan.factorize(vb[i])
                assert torch.equal(seq.store.flat, bf.store.flat[i])
                want = ref_flat(ref_bf.store, i)
                err = np.abs(bf.store.flat[i].numpy() - want).max()
                assert err <= tol * max(scale, np.abs(want).max())


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_solve_batch_vector_bitwise_matches_sequential(name):
    a, port = plans(name)
    vb = values_batch(a)
    bf = port.factorize_batch(vb)
    rhs = np.random.default_rng(1).standard_normal((BATCH, port.n))
    solved = bf.solve_batch(rhs)
    assert tuple(solved.x.shape) == (BATCH, port.n)
    for i in range(BATCH):
        seq = port.factorize(vb[i]).solve(rhs[i])
        assert torch.equal(seq.x, solved.x[i])
        assert seq.residuals == solved.residuals[i]
        assert seq.refine_accepted == int(solved.refine_accepted[i])
    assert solved.residual.shape == (BATCH,)
    assert float(solved.residual.max()) < 1e-10


@pytest.mark.parametrize("shape", [(), (3,)])
@pytest.mark.parametrize("name", ["circuit", "bbd"])
def test_solve_batch_matches_reference(name, shape):
    """The port's ``solve_batch`` against the reference's masked batched
    refinement on the same (B, n) / (B, n, k) inputs: x within 1e-10 and
    the same accepted counts per system."""
    from repro.numeric.solve import solve_batch as ref_solve_batch

    a, port = plans(name)
    vb = values_batch(a)
    rhs = np.random.default_rng(9).standard_normal((BATCH, port.n) + shape)
    solved = port.factorize_batch(vb).solve_batch(rhs)
    ref = ref_solve_batch(a, rhs, vb, ref_factor_batch(name, vb))
    err = np.abs(solved.x.numpy() - ref.x).max()
    assert err <= 1e-10 * max(1.0, np.abs(ref.x).max())
    assert np.array_equal(solved.refine_accepted, ref.refine_accepted)
    assert solved.residual.max() < 1e-10 and ref.residual.max() < 1e-10


@pytest.mark.parametrize("shape", [(), (2,)])
def test_factored_substitution_batch_is_per_system(shape):
    """``solve_factored_batch`` and its two sweeps give each system the
    sequential ``solve_factored`` / sweeps on that system's factors."""
    from repro_torch.numeric import (
        backward_substitute, backward_substitute_batch, forward_substitute,
        forward_substitute_batch, solve_factored, solve_factored_batch,
    )

    a, port = plans("bbd")
    vb = values_batch(a)
    bf = port.factorize_batch(vb)
    rhs = torch.as_tensor(np.random.default_rng(8).standard_normal(
        (BATCH, port.n) + shape))
    x = solve_factored_batch(bf.num, rhs)
    y = forward_substitute_batch(bf.store, rhs)
    assert torch.equal(backward_substitute_batch(bf.store, y), x)
    for i in range(BATCH):
        seq = port.factorize(vb[i])
        assert torch.equal(forward_substitute(seq.store, rhs[i]), y[i])
        assert torch.equal(backward_substitute(seq.store, y[i]), x[i])
        assert torch.equal(solve_factored(seq.num, rhs[i]), x[i])


@pytest.mark.parametrize("name", ["grid2d", "circuit", "bbd", "chemical"])
@pytest.mark.parametrize("backend", ["numpy", "kernel"])
def test_solve_batch_multirhs_bitwise_matches_sequential(name, backend):
    a, port = plans(name)
    plan = with_options(port, numeric_backend=backend)
    vb = values_batch(a)
    bf = plan.factorize_batch(vb)
    rhs = np.random.default_rng(2).standard_normal((BATCH, plan.n, 3))
    solved = bf.solve_batch(rhs)
    assert tuple(solved.x.shape) == (BATCH, plan.n, 3)
    for i in range(BATCH):
        seq = plan.factorize(vb[i]).solve(rhs[i])
        assert torch.equal(seq.x, solved.x[i])
        assert seq.residuals == solved.residuals[i]
        assert seq.refine_accepted == int(solved.refine_accepted[i])
        assert solved.system(i).residual == seq.residual


@pytest.mark.parametrize("refine_iters,refine_tol", [(0, None), (3, 0.0)])
def test_refinement_parity(refine_iters, refine_tol):
    """No refinement at all, and refinement that never stops early: the
    histories and accepted counts agree per system."""
    a, port = plans("circuit")
    plan = with_options(port, numeric_backend="kernel")
    vb = values_batch(a)
    bf = plan.factorize_batch(vb)
    rhs = np.random.default_rng(3).standard_normal((BATCH, plan.n))
    solved = bf.solve_batch(rhs, refine_iters=refine_iters,
                            refine_tol=refine_tol)
    for i in range(BATCH):
        seq = plan.factorize(vb[i]).solve(rhs[i], refine_iters=refine_iters,
                                          refine_tol=refine_tol)
        assert torch.equal(seq.x, solved.x[i])
        assert seq.residuals == solved.residuals[i]
        assert seq.refine_accepted == int(solved.refine_accepted[i])
    if refine_iters == 0:
        assert all(len(h) == 1 for h in solved.residuals)
        assert not solved.refine_accepted.any()
    else:
        assert solved.refine_accepted.min() >= 1


def test_stopped_systems_are_never_touched():
    """A system whose first solve is already at the tolerance stops while
    the others refine: its x stays the first solve's."""
    a, port = plans("circuit")
    plan = with_options(port, numeric_backend="kernel")
    vb = values_batch(a)
    bf = plan.factorize_batch(vb)
    rhs = np.random.default_rng(4).standard_normal((BATCH, plan.n))
    rhs[1] = 0.0                       # x = 0 solves it exactly
    solved = bf.solve_batch(rhs, refine_iters=3, refine_tol=1e-30)
    assert solved.residuals[1] == [0.0]
    assert int(solved.refine_accepted[1]) == 0
    assert not solved.x[1].any()
    assert solved.refine_accepted[[0, 2]].min() >= 1


def test_system_views_are_zero_copy_and_solve():
    a, port = plans("grid2d")
    vb = values_batch(a)
    bf = port.factorize_batch(vb)
    rhs = np.random.default_rng(5).standard_normal(port.n)
    for i in range(BATCH):
        sys_i = bf.system(i)
        flat = sys_i.store.flat
        assert flat.data_ptr() == bf.store.flat[i].data_ptr()
        assert flat.untyped_storage().data_ptr() == \
            bf.store.flat.untyped_storage().data_ptr()
        for blk_view, blk_bat in zip(sys_i.store.blocks, bf.store.blocks):
            assert blk_view.data_ptr() == blk_bat[i].data_ptr()
        seq = port.factorize(vb[i])
        assert torch.equal(seq.solve(rhs).x, sys_i.solve(rhs).x)
        assert np.array_equal(seq.l, sys_i.l)
    # writing through the batch shows in the view
    bf.store.flat[1, 0] = 12345.0
    assert float(bf.system(1).store.flat[0]) == 12345.0


def test_system_rows_keep_fresh_alignment():
    """Each system's values start 512 bytes apart from the batch's start,
    as a fresh store's do, whatever the store's size."""
    a, port = plans("random")
    bf = port.factorize_batch(values_batch(a))
    base = bf.store.flat.data_ptr()
    for i in range(BATCH):
        assert (bf.store.flat[i].data_ptr() - base) % 512 == 0


def test_factorize_batch_rejects_bad_shapes_like_reference():
    a, port = plans("grid2d")
    ref = ref_plan("grid2d")
    for bad in (generic_values_csr(a), np.zeros((2, a.nnz + 1)),
                np.zeros((0, a.nnz))):
        with pytest.raises(ValueError) as want:
            ref.factorize_batch(bad)
        with pytest.raises(ValueError) as got:
            port.factorize_batch(bad)
        assert str(got.value) == str(want.value)


def test_solve_batch_rejects_bad_shapes_like_reference():
    a, port = plans("grid2d")
    ref = ref_plan("grid2d")
    vb = values_batch(a)
    ref_bf, port_bf = ref.factorize_batch(vb), port.factorize_batch(vb)
    for bad in (np.zeros(a.n), np.zeros((BATCH + 1, a.n)),
                np.zeros((BATCH, a.n, 0))):
        with pytest.raises(ValueError) as want:
            ref_bf.solve_batch(bad)
        with pytest.raises(ValueError) as got:
            port_bf.solve_batch(bad)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["circuit", "bbd"])
def test_zero_pivot_names_failing_system(name):
    """System 1 of 3 gets a NaN pivot at column n // 2: the batched sweep
    raises at that column naming system 1, as the reference's does and at
    the column the port's sequential factorization of system 1 names."""
    a, port = plans(name)
    vb = values_batch(a)
    col = a.n // 2
    vb[1, a.indptr[col] + np.searchsorted(a.row(col), col)] = np.nan
    with pytest.raises(repro.sparse.numeric.ZeroPivotError) as want:
        ref_factor_batch(name, vb)
    with pytest.raises(repro_torch.ZeroPivotError) as got:
        port.factorize_batch(vb)
    with pytest.raises(repro_torch.ZeroPivotError) as seq:
        port.factorize(vb[1])
    e = got.value
    assert (e.k, e.system) == (want.value.k, want.value.system) == (col, 1)
    assert (e.k, e.panel, e.level) == (seq.value.k, seq.value.panel,
                                       seq.value.level)
    assert "system 1" in str(e) and f"column {col}" in str(e)


def test_zero_pivot_lowest_system_at_first_column():
    """Systems 2 and 0 singular at the same column: the lowest one is
    named; a system singular only later does not win."""
    a, port = plans("circuit")
    vb = values_batch(a)
    col = a.n // 3
    for i in (2, 0):
        vb[i, a.indptr[col]:a.indptr[col + 1]] = 0.0      # row col is zero
    with pytest.raises(repro_torch.ZeroPivotError) as got:
        port.factorize_batch(vb)
    assert (got.value.k, got.value.system) == (col, 0)
    assert got.value.piv == 0.0


def test_gemm_batched_counters_match_reference():
    """``gemm.batched.*`` and ``gemm.flops`` of a traced factorize_batch
    equal the reference's (flops and bytes times B)."""
    from repro.obs import metrics as ref_metrics
    from repro.obs import trace as ref_trace
    from repro_torch.obs import metrics as port_metrics
    from repro_torch.obs import trace as port_trace

    a, port = plans("bbd")
    vb = values_batch(a)
    got = {}
    for name, run, trace, metrics in (
            ("ref", lambda: ref_factor_batch("bbd", vb), ref_trace,
             ref_metrics),
            ("port", lambda: port.factorize_batch(vb), port_trace,
             port_metrics)):
        trace.disable()
        metrics.registry().reset()
        try:
            trace.enable()
            run()
            got[name] = {key: value for key, value in
                         metrics.registry().snapshot()["counters"].items()
                         if key.startswith("gemm.batched.")
                         or key == "gemm.flops"}
        finally:
            trace.disable()
            metrics.registry().reset()
    assert got["port"] == got["ref"]
    assert got["port"]["gemm.batched.panels"] > \
        got["port"]["gemm.batched.calls"] >= 1


@pytest.mark.parametrize("f32", [False, True])
def test_plain_mapped_update_over_systems(f32):
    """``panel_update_mapped`` (its plain version, on the CPU) over 3
    systems of a plan's store and U rows equals, system by system, the
    one-system call on that system alone; bad system arguments raise."""
    a, port = plans("bbd")
    upd = port._device_state(torch.device("cpu"))[2]
    rng = np.random.default_rng(6)
    total = port.store_template.total_entries
    lo, hi = int(upd.level_tiles[1]), int(upd.level_tiles[2])
    recs = upd.tiles[lo:hi].long()
    k_u = int((recs[:, 2] + recs[:, 5] * recs[:, 4]).max())
    flat = torch.as_tensor(rng.standard_normal((BATCH, total)))
    u = torch.as_tensor(rng.standard_normal((BATCH, k_u)))
    got = flat.clone()
    kops.panel_update_mapped(got.view(-1), u.view(-1), upd.lmap,
                             upd.tiles[lo:hi], f32=f32, systems=BATCH)
    for i in range(BATCH):
        want = flat[i].clone()
        kops.panel_update_mapped(want, u[i].clone(), upd.lmap,
                                 upd.tiles[lo:hi], f32=f32)
        assert torch.equal(got[i], want)
        assert not torch.equal(want, flat[i])
    # explicit strides: systems in the middle of padded rows
    padded = torch.zeros((BATCH, total + 7), dtype=torch.float64)
    padded[:, :total] = flat
    kplain.panel_update_mapped_plain(padded.view(-1), u.view(-1), upd.lmap,
                                     upd.tiles[lo:hi], f32=f32,
                                     systems=BATCH, flat_stride=total + 7,
                                     u_stride=k_u)
    assert torch.equal(padded[:, :total], got)
    for bad in (dict(systems=0), dict(systems=kops.PANEL_MAX_SYSTEMS + 1),
                dict(systems=BATCH, flat_stride=total + 1)):
        with pytest.raises(ValueError):
            kops.panel_update_mapped(flat.view(-1), u.view(-1), upd.lmap,
                                     upd.tiles[lo:hi], **bad)


def test_mapped_update_int32_limit_is_per_system():
    """Offsets are int32 within a system: a batch of 2^32 entries in all
    passes the size check when each system holds fewer than 2^31, and one
    system of 2^31 entries does not."""
    flat = torch.empty(2 ** 32, dtype=torch.float64, device="meta")
    u = torch.empty(16, dtype=torch.float64, device="meta")
    assert kops._system_strides(flat, u, 4, None, None) == (2 ** 30, 4)
    with pytest.raises(ValueError, match="int32 offsets"):
        kops._system_strides(flat, u, 2, None, None)
    with pytest.raises(ValueError, match="int32 offsets"):
        kops._system_strides(flat[:2 ** 31], u, 1, None, None)
