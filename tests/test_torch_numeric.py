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
from repro_torch.kernels import ops as kops
from repro_torch.kernels import plain as kplain
from repro_torch.numeric.storage import RowGather
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


def _update_tables(gen, backend="numpy"):
    """(plan, factored CPU store, update tables) of one generator."""
    a, _, port = plans(gen, numeric_backend=backend)
    store = port.factorize(generic_values_csr(a)).store
    return port, store, port._device_state(torch.device("cpu"))[2]


def _slices(tiles):
    """Tile records that stand for whole slices (m0 = n0 = 0)."""
    t = tiles.numpy()
    return t[(t[:, 6] == 0) & (t[:, 7] == 0)]


@pytest.mark.parametrize("gen", ["bbd", "grid2d"])
def test_update_map_reads_the_gathered_l(gen):
    """For every panel with a trailing update, L read through ``lmap`` is
    bitwise the concatenated below-row gathers of its ancestors."""
    port, store, upd = _update_tables(gen)
    sched = port.schedule
    n_slices = 0
    for j, pm in enumerate(port.gather_maps):
        if pm is None:
            assert tuple(upd.panel_tiles[j]) == (0, 0)
            continue
        lo, hi = upd.panel_tiles[j]
        acc_off, map_off, _, m, n, k = upd.tiles[lo, :6].tolist()
        d = int(store.diag[j])
        assert acc_off == store.offsets[j] + d * n
        assert (m, n, k) == (len(store.rows[j]) - d,
                             int(np.diff(sched.supernodes[j])[0]),
                             len(pm.anc_rows))
        want = torch.cat([store.gather_rows_mapped(
            int(anc), RowGather.build(idx, hit, "cpu"))
            for anc, (idx, hit) in zip(sched.ancestors[j], pm.below_maps)],
            dim=1)
        lm = upd.lmap[map_off:map_off + m * k].view(m, k).long()
        got = torch.where(lm >= 0, store.flat[lm.clamp(min=0)], 0.0)
        assert torch.equal(got, want)
        n_slices += 1
    assert n_slices == len(_slices(upd.tiles)) > 0


@pytest.mark.parametrize("gen", ["bbd", "grid2d"])
@pytest.mark.parametrize("f32", [False, True])
def test_mapped_plain_update_is_the_gathered_update(gen, f32):
    """The plain mapped update of a level in place is, slice by slice,
    bitwise ``panel_update_plain`` on the gathered operands (float32 mode:
    on ``.float()`` operands, widened)."""
    port, store, upd = _update_tables(gen)
    rng = np.random.default_rng(3)
    for li in range(port.schedule.n_levels):
        lo, hi = int(upd.level_tiles[li]), int(upd.level_tiles[li + 1])
        if lo == hi:
            continue
        tiles = upd.tiles[lo:hi]
        recs = _slices(tiles)
        u_len = int((recs[:, 5] * recs[:, 4]).sum())
        u = torch.as_tensor(rng.standard_normal(u_len))
        flat = store.flat.clone()
        kplain.panel_update_mapped_plain(flat, u, upd.lmap, tiles, f32=f32)
        for acc_off, map_off, u_off, m, n, k, *_ in recs.tolist():
            acc = store.flat[acc_off:acc_off + m * n].view(m, n)
            lm = upd.lmap[map_off:map_off + m * k].view(m, k).long()
            lp = torch.where(lm >= 0, store.flat[lm.clamp(min=0)], 0.0)
            b = u[u_off:u_off + k * n].view(k, n)
            if f32:
                want = kplain.panel_update_plain(
                    acc.float(), lp.float(), b.float()).double()
            else:
                want = kplain.panel_update_plain(acc, lp, b)
            assert torch.equal(flat[acc_off:acc_off + m * n].view(m, n),
                               want)


@pytest.mark.parametrize("gen", ["bbd", "grid2d"])
@pytest.mark.parametrize("segment_batch", [True, False])
def test_sweep_calls_mapped_update_per_level(gen, segment_batch,
                                             monkeypatch):
    """The sweep makes one mapped update per level with trailing updates
    under ``segment_batch``, one per such panel without; each call covers
    exactly the tile records of its level or panel."""
    a, _, port = plans(gen)
    upd = port._device_state(torch.device("cpu"))[2]
    calls = []
    real = kops.panel_update_mapped

    def spy(flat, u, lmap, tiles, **kw):
        calls.append(tiles[:, 0].tolist())
        return real(flat, u, lmap, tiles, **kw)

    monkeypatch.setattr(kops, "panel_update_mapped", spy)
    plan = dataclasses.replace(
        port, options=port.options.replace(segment_batch=segment_batch))
    plan.factorize(generic_values_csr(a))
    t = upd.tiles[:, 0].tolist()
    if segment_batch:
        want = [t[lo:hi] for lo, hi in zip(upd.level_tiles[:-1],
                                           upd.level_tiles[1:]) if hi > lo]
    else:
        want = [t[lo:hi] for lv in port.schedule.levels for lo, hi in
                (upd.panel_tiles[j] for j in lv) if hi > lo]
    assert calls == want
    levels = sum(any(port.gather_maps[j] is not None for j in lv)
                 for lv in port.schedule.levels)
    panels = sum(m is not None for m in port.gather_maps)
    assert len(calls) == (levels if segment_batch else panels) > 1


@pytest.mark.parametrize("segment_batch", [True, False])
def test_batched_gemm_counters_match_reference(segment_batch):
    """``gemm.batched.{calls, panels, flops, bytes}`` under tracing equal
    the reference's: its stacked same-shape groups of more than one panel
    with segment batching on, nothing with it off."""
    from repro.obs import metrics as ref_metrics
    from repro.obs import trace as ref_trace
    from repro_torch.obs import metrics as port_metrics
    from repro_torch.obs import trace as port_trace

    a = M.bordered_block_diagonal(320, block=16, border=32, seed=6)
    kw = dict(concurrency=48, supernode_relax=2, segment_batch=segment_batch)
    ref = repro.analyze(a, repro.LUOptions(backend="dense", **kw))
    port = repro_torch.analyze(to_port(a), repro_torch.LUOptions(**kw),
                               device="cpu")
    values = generic_values_csr(a)
    got = {}
    for name, plan, trace, metrics in (
            ("ref", ref, ref_trace, ref_metrics),
            ("port", port, port_trace, port_metrics)):
        trace.disable()
        metrics.registry().reset()
        try:
            trace.enable()
            plan.factorize(values)
            got[name] = {key: value for key, value in
                         metrics.registry().snapshot()["counters"].items()
                         if key.startswith("gemm.batched.")}
        finally:
            trace.disable()
            metrics.registry().reset()
    keys = {f"gemm.batched.{k}" for k in ("calls", "panels", "flops",
                                          "bytes")}
    assert got["port"] == got["ref"]
    if segment_batch:
        assert set(got["port"]) == keys
        assert (got["port"]["gemm.batched.panels"]
                > got["port"]["gemm.batched.calls"] >= 1)
    else:
        assert got["port"] == {}
