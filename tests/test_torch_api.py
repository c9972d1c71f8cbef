"""repro_torch session API: end to end against repro on every generator,
pickled plans, LUOptions parity with repro.LUOptions, the later-slice
options (``distribute`` and ``runtime="dynamic"`` run on the CPU; analyze
takes a mesh, the robust tier's values and the cost model's peaks), and the
device rule (the card by default, never a silent CPU)."""
import dataclasses
import pickle

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.sparse import matrices as M
from repro.sparse.numeric import generic_values_csr
from repro_torch.sparse.csr import CSRMatrix

# tiny shapes, several pytest workers: one intra-op thread each keeps
# torch's pool from oversubscribing the CPU
torch.set_num_threads(1)

GENERATORS = {
    "grid2d": lambda: M.grid2d_laplacian(9),
    "circuit": lambda: M.circuit_like(100, seed=3),
    "bbd": lambda: M.bordered_block_diagonal(120, block=8, border=8, seed=5),
    "banded": lambda: M.banded_random(100, band=5, seed=6),
    "economic": lambda: M.economic_like(96, block=16, seed=7),
}


def to_port(a):
    return CSRMatrix(n=a.n, indptr=a.indptr.copy(), indices=a.indices.copy())


@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_end_to_end_matches_reference(gen):
    a = GENERATORS[gen]()
    values = generic_values_csr(a, seed=2)
    b = np.random.default_rng(1).standard_normal((a.n, 2))
    opts = dict(concurrency=64, supernode_relax=2)
    ref = repro.analyze(a, repro.LUOptions(backend="dense", **opts)
                        ).factorize(values).solve(b)
    plan = repro_torch.analyze(to_port(a), repro_torch.LUOptions(**opts),
                               device="cpu")
    assert plan.device == "cpu"
    got = plan.factorize(values).solve(b)
    assert got.residual <= 1e-10 and ref.residual <= 1e-10
    x = got.x.numpy()
    assert np.abs(x - ref.x).max() <= 1e-10 * np.abs(ref.x).max()
    one = plan.solve(b[:, 0], values)
    assert one.x.shape == (a.n,) and one.residual <= 1e-10
    assert one.factor_s > 0.0


def test_pickled_plan_replays_bitwise():
    a = to_port(GENERATORS["circuit"]())
    values = generic_values_csr(a)
    plan = repro_torch.analyze(a, repro_torch.LUOptions(concurrency=64),
                               device="cpu")
    factor = plan.factorize(values)                  # fills the device cache
    assert plan._device_cache
    blob = pickle.dumps(plan)
    loaded = pickle.loads(blob)
    assert loaded._device_cache == {}
    assert loaded.store_template.flat is None
    again = loaded.factorize(values)
    assert torch.equal(again.store.flat, factor.store.flat)
    b = np.arange(a.n, dtype=np.float64)
    assert torch.equal(again.solve(b).x, factor.solve(b).x)


def test_luoptions_fields_and_defaults_match_reference():
    ref = {f.name: f.default for f in dataclasses.fields(repro.LUOptions)}
    got = {f.name: f.default for f in dataclasses.fields(
        repro_torch.LUOptions)}
    assert got == ref
    assert repro_torch.LUOptions().replace(concurrency=7).concurrency == 7


@pytest.mark.parametrize("bad", [
    dict(concurrency=0), dict(supernode_max_size=0), dict(supernode_relax=-1),
    dict(n_bins=0), dict(refine_iters=-1), dict(budget_bytes=0),
    dict(block_max_width=0), dict(block_merge_threshold=0.0),
    dict(backend="bogus"), dict(numeric_backend="bogus"),
    dict(policy="bogus"), dict(runtime="bogus"), dict(pivot="bogus"),
    dict(pivot="partial"), dict(perturb_eps=-1.0),
    dict(runtime="dynamic", distribute=True),
])
def test_luoptions_validation_matches_reference(bad):
    with pytest.raises(ValueError) as ref:
        repro.LUOptions(**bad)
    with pytest.raises(ValueError) as got:
        repro_torch.LUOptions(**bad)
    assert str(got.value) == str(ref.value)


def _same_plan(got, want, values):
    """Structure, fingerprints and factors bitwise."""
    for key in ("l_counts", "u_counts", "supernodes"):
        assert np.array_equal(getattr(got.sym, key), getattr(want.sym, key))
    assert np.array_equal(got.pattern.indptr, want.pattern.indptr)
    assert np.array_equal(got.pattern.rowind, want.pattern.rowind)
    for f in ("counts", "hsum", "hxor", "subdiag", "seen"):
        assert np.array_equal(getattr(got.sym.fingerprints, f),
                              getattr(want.sym.fingerprints, f))
    assert torch.equal(got.factorize(values).store.flat,
                       want.factorize(values).store.flat)


@pytest.mark.parametrize("later", [
    dict(distribute=True), dict(runtime="dynamic"),
])
def test_later_slice_options_raise(later):
    """Item 10's options are accepted, as in the reference, and ``analyze``
    runs them on the CPU: ``distribute=True`` without a process group is
    the one-shard mesh, the dynamic runtime one CPU slot; the plan is
    bitwise the default options' and carries a one-device placement."""
    repro.LUOptions(**later)                    # valid in the reference
    opts = repro_torch.LUOptions(concurrency=32, **later)
    a = to_port(GENERATORS["bbd"]())
    values = generic_values_csr(a)
    plan = repro_torch.analyze(a, opts, device="cpu")
    assert plan.options == opts and plan.device == "cpu"
    assert plan.placement is not None and plan.n_devices == 1
    base = repro_torch.analyze(a, repro_torch.LUOptions(concurrency=32),
                               device="cpu")
    _same_plan(plan, base, values)
    if later.get("distribute"):
        assert plan.sym.dist["n_shards"] == 1
    else:
        assert plan.sym.runtime["completed"] == plan.sym.runtime["chunks"]


def test_analyze_takes_values_and_peaks():
    """``analyze(values=, peaks=)`` as the reference's: the values seed
    the static-pivoting transversal, the peaks feed the blocking cost
    model; item 9's options are accepted."""
    a = to_port(GENERATORS["bbd"]())
    values = generic_values_csr(a, seed=1)
    peaks = {"mem_bw_gbs": 100.0, "flops_gflops": 1000.0}
    opts = repro_torch.LUOptions(concurrency=64, pivot="static",
                                 perturb=True, blocking=True)
    plan = repro_torch.analyze(a, opts, values=values, peaks=peaks,
                               device="cpu")
    assert plan.robust is not None and plan.options == opts
    factor = plan.factorize(values)
    assert factor.solve(np.ones(a.n)).residual <= 1e-10
    auto = repro_torch.analyze(a, repro_torch.LUOptions(
        concurrency=64, autotune=True), peaks=peaks, device="cpu")
    assert auto.tuned is not None and auto.options.blocking


def test_mesh_raises_not_implemented():
    """``analyze(mesh=make_flat_mesh())`` with no process group is the
    one-shard mesh: bitwise the mesh-less plan, with ``sym.dist``."""
    from repro_torch.launch.mesh import make_flat_mesh

    a = to_port(GENERATORS["grid2d"]())
    values = generic_values_csr(a)
    opts = repro_torch.LUOptions(concurrency=32)
    plan = repro_torch.analyze(a, opts, mesh=make_flat_mesh(device="cpu"))
    assert plan.device == "cpu" and plan.n_devices == 1
    assert plan.sym.dist["n_shards"] == 1
    assert plan.sym.dist["balance_ratio"] == 1.0
    _same_plan(plan, repro_torch.analyze(a, opts, device="cpu"), values)


def test_default_device_is_the_card(monkeypatch):
    """analyze() with no device asks for CUDA and raises without it —
    never a quiet CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = to_port(GENERATORS["grid2d"]())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.analyze(a)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.analyze(a, device="cuda:0")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        repro_torch.analyze(a, device="meta")


def test_engine_entry_points_default_to_the_card(monkeypatch):
    """The symbolic engine below analyze() follows the same device rule."""
    from repro_torch.core.gsofa import prepare_graph
    from repro_torch.core.spaceopt import LabelArena
    from repro_torch.core.symbolic import symbolic_factorize

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = to_port(GENERATORS["grid2d"]())
    for call in (lambda: prepare_graph(a), lambda: symbolic_factorize(a),
                 lambda: LabelArena(capacity=4, n=a.n)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_trace_option_records_spans():
    a = to_port(GENERATORS["bbd"]())
    plan = repro_torch.analyze(a, repro_torch.LUOptions(concurrency=64,
                                                        trace=True),
                               device="cpu")
    assert plan.stats.find("fixpoint") is not None
    assert plan.stats.find("fingerprint_update") is not None
    factor = plan.factorize()
    assert factor.stats.find("factor_level") is not None
