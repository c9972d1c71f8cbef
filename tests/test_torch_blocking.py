"""repro_torch's structure-aware blocking, roofline autotune and replan on
the CPU against repro's.

Contract: on the same pattern and fingerprints the port's merge pass gives
the reference's ranges and ``BlockingStats`` bitwise, and its autotune the
reference's ``TuneReport`` (chosen knobs, every candidate's ``modeled_s``)
bitwise under ``numeric_backend="numpy"``; under ``"kernel"`` the cost
model charges the port's own tile padding (``padded_gemm_shape``, from
``panel_tile``), and with the reference's padding rule put in its place the
partition is the reference's bitwise — the tile rule is the only
difference.  Blocked and autotuned factors hold the dense oracle within
1e-10; ``replan`` with the plan's own knobs factorizes bitwise like the
plan and needs the fingerprints; merged panels keep their padding exactly
zero; the ``blocking.*`` / ``tune.*`` metrics equal the reference's.  The
reference's passes run on the port plan's pattern and fingerprints (the
two analyses are bitwise equal, ``test_torch_symbolic.py``), so no
reference fixpoint runs here."""
import dataclasses
import pickle

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.sparse import matrices as M
from repro.sparse import permute_csr, rcm_order
from repro.sparse.numeric import generic_values_csr, lu_nopivot
from repro.supernodes import blocking as ref_blocking
from repro.tune import autotune as ref_autotune
from repro.tune import model as ref_model
from repro_torch.kernels import ops as kops
from repro_torch.sparse.csr import CSRMatrix
from repro_torch.supernodes.blocking import (
    BlockingStats, merge_supernodes, partition_stats,
)
from repro_torch.tune import (
    RooflineCostModel, autotune_partition, choose_concurrency, cost_model_for,
)

# tiny shapes, several pytest workers: one intra-op thread each keeps
# torch's pool from oversubscribing the CPU
torch.set_num_threads(1)

GENERATORS = {
    "grid2d": lambda: M.grid2d_laplacian(14),
    "circuit": lambda: M.circuit_like(300, seed=7),
    "bbd": lambda: M.bordered_block_diagonal(512, block=16, border=32,
                                             seed=6),
}
KW = dict(concurrency=64, supernode_relax=2)
OPTS = repro_torch.LUOptions(**KW)
REF_OPTS = repro.LUOptions(**KW)


def to_port(a):
    return CSRMatrix(n=a.n, indptr=a.indptr.copy(), indices=a.indices.copy())


def _dense(a, values):
    out = np.zeros((a.n, a.n))
    rows = np.repeat(np.arange(a.n), np.diff(a.indptr))
    out[rows, a.indices] = values
    return out


def _rel_err(got, ref):
    return np.abs(got - ref).max() / max(1.0, np.abs(ref).max())


@pytest.fixture(scope="module")
def plans():
    """One default port analysis per generator; blocked / tuned variants
    replan from it (no fixpoint re-run)."""
    out = {}
    for name, make in GENERATORS.items():
        a = make()
        a = to_port(permute_csr(a, rcm_order(a)))
        out[name] = repro_torch.analyze(a, OPTS, device="cpu")
    return out


# ---------------------------------------------------------------------------
# the merge pass and the tuner: bitwise the reference's on the same inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(GENERATORS))
@pytest.mark.parametrize("max_width", [64, 256])
def test_merge_bitwise_reference(name, max_width, plans):
    plan = plans[name]
    got, stats = merge_supernodes(plan.pattern, plan.sym.supernodes,
                                  RooflineCostModel(), max_width=max_width)
    want, ref_stats = ref_blocking.merge_supernodes(
        plan.pattern, plan.sym.supernodes, ref_model.RooflineCostModel(),
        max_width=max_width)
    assert np.array_equal(got, want)
    assert isinstance(stats, BlockingStats)
    assert dataclasses.asdict(stats) == dataclasses.asdict(ref_stats)
    assert stats.n_before - stats.merges == stats.n_after
    assert got[0][0] == 0 and got[-1][1] == plan.n
    assert (got[1:, 0] == got[:-1, 1]).all()
    assert (got[:, 1] - got[:, 0] <= max_width).all()
    for key, arr in partition_stats(plan.pattern, got).items():
        assert np.array_equal(arr, ref_blocking.partition_stats(
            plan.pattern, want)[key])


def _tune_pair(plan, backend):
    got = autotune_partition(plan.pattern, plan.sym.fingerprints,
                             OPTS.replace(numeric_backend=backend))
    want = ref_autotune.autotune_partition(
        plan.pattern, plan.sym.fingerprints,
        REF_OPTS.replace(numeric_backend=backend))
    return got, want


def _same_tune(got, want):
    (sn, report), (ref_sn, ref_report) = got, want
    return (np.array_equal(sn, ref_sn)
            and dataclasses.asdict(report) == dataclasses.asdict(ref_report))


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_autotune_bitwise_reference_numpy(name, plans):
    got, want = _tune_pair(plans[name], "numpy")
    assert _same_tune(got, want)
    report = got[1]
    assert report.modeled_s <= report.baseline_s + 1e-12
    assert report.chosen["concurrency"] == choose_concurrency(plans[name].n)


@pytest.mark.parametrize("m,k,n", [
    (5, 3, 7), (130, 128, 128), (1, 1, 1), (200, 17, 48), (9, 64, 256),
    (300, 33, 65), (0, 3, 7), (4, 0, 2)])
def test_padded_gemm_shape_is_the_mapped_tile(m, k, n):
    """M rounds up to the tile's rows, N to TC, K to BK — panel_tile's
    (TC, BK); a zero dimension gives (0, 0, 0); arrays as scalars."""
    got = kops.padded_gemm_shape(m, k, n)
    if 0 in (m, k, n):
        assert got == (0, 0, 0)
        return
    tc, bk = kops.panel_tile(n, k)
    rows = kops.PANEL_THREADS // tc
    assert got == (-(-m // rows) * rows, -(-k // bk) * bk, -(-n // tc) * tc)
    vec = kops.padded_gemm_shape(np.array([m, 1]), np.array([k, 1]),
                                 np.array([n, 1]))
    assert tuple(int(x[0]) for x in vec) == got
    # the kernel backend charges at least the logical shape
    logical = RooflineCostModel()
    kernel = cost_model_for(OPTS.replace(numeric_backend="kernel"))
    assert kernel.backend == "kernel"
    assert kernel.gemm_time(m, k, n) >= logical.gemm_time(m, k, n)


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_autotune_kernel_backend_differs_only_by_tile_rule(name, plans,
                                                           monkeypatch):
    """With the reference's padding rule (``repro.kernels.ops
    .padded_gemm_shape``, numpy) in place of the port's, the port's
    kernel-backend tuner is the reference's bitwise."""
    from repro.kernels import ops as ref_ops

    monkeypatch.setattr(kops, "padded_gemm_shape", ref_ops.padded_gemm_shape)
    got, want = _tune_pair(plans[name], "kernel")
    assert _same_tune(got, want)


# ---------------------------------------------------------------------------
# blocked and autotuned plans: the dense oracle, replan, padding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(GENERATORS))
@pytest.mark.parametrize("knob", ["blocking", "autotune"])
def test_blocked_factors_match_dense_oracle(name, knob, plans):
    plan = plans[name]
    values = generic_values_csr(plan.a)
    other = repro_torch.replan(plan, OPTS.replace(**{knob: True}))
    factor = other.factorize(values)
    l0, u0 = lu_nopivot(_dense(plan.a, values))
    assert _rel_err(factor.l, l0) <= 1e-10
    assert _rel_err(factor.u, u0) <= 1e-10
    b = np.random.default_rng(0).standard_normal(plan.n)
    assert factor.solve(b).residual <= 1e-10
    if knob == "autotune":
        assert other.tuned is not None and other.options.blocking is True
        assert other.options.supernode_relax == \
            other.tuned.chosen["supernode_relax"]
    else:                 # merging only ever removes panels
        assert other.tuned is None
        assert other.n_supernodes <= plan.n_supernodes


@pytest.mark.parametrize("name", sorted(GENERATORS))
@pytest.mark.parametrize("backend", ["numpy", "kernel"])
def test_replan_same_knobs_is_bitwise(name, backend, plans):
    plan = plans[name]
    if backend == "kernel":
        plan = dataclasses.replace(plan, options=plan.options.replace(
            numeric_backend="kernel"), _device_cache={})
    values = generic_values_csr(plan.a)
    ref = plan.factorize(values)
    again = repro_torch.replan(plan)
    assert np.array_equal(again.schedule.supernodes,
                          plan.schedule.supernodes)
    got = again.factorize(values)
    assert torch.equal(ref.store.flat, got.store.flat)
    b = np.random.default_rng(1).standard_normal(plan.n)
    assert torch.equal(ref.solve(b).x, got.solve(b).x)


def test_replan_without_fingerprints_raises(plans):
    plan = plans["grid2d"]
    crippled = dataclasses.replace(
        plan, sym=dataclasses.replace(plan.sym, fingerprints=None))
    with pytest.raises(ValueError, match="fingerprints"):
        repro_torch.replan(crippled)
    with pytest.raises(ValueError, match="fingerprints"):
        autotune_partition(plan.pattern, None, OPTS)


def test_blocked_padding_is_exactly_zero(plans):
    plan = plans["circuit"]
    values = generic_values_csr(plan.a)
    blocked = repro_torch.replan(plan, OPTS.replace(blocking=True))
    store = blocked.factorize(values).num.store
    assert store.pad_entries > 0          # merging did introduce padding
    for blk, mask in zip(store.blocks, store.in_pattern):
        assert not blk[torch.as_tensor(~mask)].any()


def test_blocked_plan_pickles_and_analyze_takes_the_knobs(plans):
    plan = plans["bbd"]
    values = generic_values_csr(plan.a)
    blocked = repro_torch.replan(plan, OPTS.replace(blocking=True))
    ref = blocked.factorize(values)
    got = pickle.loads(pickle.dumps(blocked)).factorize(values)
    assert torch.equal(ref.store.flat, got.store.flat)
    # analyze(blocking=True) builds the replanned partition directly
    direct = repro_torch.analyze(plan.a, OPTS.replace(blocking=True),
                                 device="cpu")
    assert np.array_equal(direct.schedule.supernodes,
                          blocked.schedule.supernodes)
    assert torch.equal(direct.factorize(values).store.flat, ref.store.flat)


def test_blocking_and_tune_metrics_equal_reference(plans):
    plan = plans["circuit"]
    names = ("blocking.", "tune.")

    def pick(snap):
        return {kind: {k: v for k, v in snap[kind].items()
                       if k.startswith(names)}
                for kind in ("counters", "gauges")}

    reg = repro_torch.obs.registry()
    reg.reset()
    with repro_torch.obs.tracing():
        repro_torch.replan(plan, OPTS.replace(autotune=True))
    got = pick(reg.snapshot())
    ref_reg = repro.obs.registry()
    ref_reg.reset()
    with repro.obs.tracing():
        ref_autotune.autotune_partition(plan.pattern, plan.sym.fingerprints,
                                        REF_OPTS)
    want = pick(ref_reg.snapshot())
    assert got["counters"]["tune.candidates"] > 0
    assert "blocking.panels_after" in got["gauges"]
    assert got == want
