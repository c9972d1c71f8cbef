"""repro_torch's dynamic runtime and panel placement against repro.

``runtime.scheduler.DynamicScheduler`` on CPU executor slots, mirroring the
reference's ``tests/test_runtime.py``: every chunk delivered exactly once
(counts bitwise the elimination oracle), elastic shrink and join,
checkpoint restart (with a changed concurrency too), a straggler re-issued
and retired, the ``runtime`` span and counters, and a thread stress run.
``LUOptions(runtime="dynamic")`` plans are bitwise the static plans (and
the reference's dynamic symbolic result).  ``numeric.schedule
.build_placement`` equals the reference's on the same schedule, and
``LUPlan.place(d)`` leaves factors and solves bitwise at every d, on both
numeric backends, with segment batching on and off."""
import os
import pickle
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro.sparse import matrices as M
from repro.sparse.numeric import generic_values_csr
from repro_torch.core.gsofa import prepare_graph
from repro_torch.core.symbolic import ChunkCheckpointer, symbolic_factorize
from repro_torch.core.theory import elimination_fill
from repro_torch.numeric.schedule import build_placement
from repro_torch.obs import metrics as om
from repro_torch.obs import trace as ot
from repro_torch.runtime.scheduler import DynamicScheduler
from repro_torch.sparse.csr import CSRMatrix

torch.set_num_threads(1)
CPU = torch.device("cpu")

GENERATORS = {
    "grid2d": lambda: M.grid2d_laplacian(10),
    "grid3d": lambda: M.grid3d_laplacian(5),
    "circuit": lambda: M.circuit_like(200, seed=7),
    "economic": lambda: M.economic_like(192, block=16, seed=2),
    "chemical": lambda: M.chemical_like(240, stage=16, seed=3),
    "banded": lambda: M.banded_random(160, band=6, seed=4),
    "banded_full": lambda: M.banded_full(150, band=5),
    "random": lambda: M.random_pattern(120, density=0.02, seed=5),
    "bbd": lambda: M.bordered_block_diagonal(320, block=16, border=32,
                                             seed=6),
}


def to_port(a):
    return CSRMatrix(n=a.n, indptr=a.indptr.copy(), indices=a.indices.copy())


def _refs(a):
    e = elimination_fill(a)
    np.fill_diagonal(e, False)
    ids = np.arange(a.n)
    return ((e & (ids[None, :] < ids[:, None])).sum(1),
            (e & (ids[None, :] > ids[:, None])).sum(1))


def _graph(a):
    return prepare_graph(a, device="cpu")


def _analyze(a, **kw):
    return repro_torch.analyze(a, repro_torch.LUOptions(**kw), device="cpu")


@pytest.fixture
def tracing():
    ot.disable()
    om.registry().reset()
    ot.enable()
    try:
        yield om.registry()
    finally:
        ot.disable()
        om.registry().reset()


def test_scheduler_completes_all_chunks():
    a = to_port(M.economic_like(160, block=16, seed=31))
    l_ref, u_ref = _refs(a)
    sched = DynamicScheduler(_graph(a), concurrency=48)
    assert sched.devices == [CPU]              # the graph's device
    out = sched.run()
    assert np.array_equal(out["l_counts"], l_ref)
    assert np.array_equal(out["u_counts"], u_ref)
    assert out["completed"] == out["chunks"] == 4


def test_scheduler_elastic_shrink():
    a = to_port(M.economic_like(160, block=16, seed=32))
    l_ref, _ = _refs(a)
    out = DynamicScheduler(_graph(a), devices=[CPU] * 3,
                           concurrency=32).run(drop_devices_after=1)
    assert np.array_equal(out["l_counts"], l_ref)
    assert out["completed"] == out["chunks"]


def test_scheduler_elastic_join():
    """Start on one slot, activate the rest mid-run: the queue drains and
    the late joiners' pulls count as steals."""
    a = to_port(M.economic_like(160, block=16, seed=36))
    l_ref, u_ref = _refs(a)
    sched = DynamicScheduler(_graph(a), devices=[CPU] * 4, concurrency=16)
    out = sched.run(join_devices_after=2)
    assert np.array_equal(out["l_counts"], l_ref)
    assert np.array_equal(out["u_counts"], u_ref)
    assert out["completed"] == out["chunks"]
    assert out["steals"] >= 1


def test_scheduler_restart_with_changed_concurrency(tmp_path):
    """Chunk coverage is per source: a checkpoint recorded under one
    concurrency restarts correctly under another."""
    a = to_port(M.economic_like(128, block=16, seed=34))
    l_ref, u_ref = _refs(a)
    g = _graph(a)
    path = os.path.join(tmp_path, "ckpt.jsonl")
    DynamicScheduler(g, concurrency=32,
                     checkpointer=ChunkCheckpointer(path, a.n)).run()
    with open(path) as f:
        first = f.readline()
    with open(path, "w") as f:
        f.write(first)
    out = DynamicScheduler(g, concurrency=64,
                           checkpointer=ChunkCheckpointer(path, a.n)).run()
    assert np.array_equal(out["l_counts"], l_ref)
    assert np.array_equal(out["u_counts"], u_ref)
    assert out["completed"] == 2


def test_scheduler_straggler_reissue_and_retire():
    """A flight that never reports ready is speculatively re-issued to an
    idle slot; when the copy wins, the straggler is retired — and the
    results stay bitwise-correct (exactly-once delivery)."""
    a = to_port(M.economic_like(160, block=16, seed=35))
    l_ref, u_ref = _refs(a)
    sched = DynamicScheduler(_graph(a), devices=[CPU] * 3, concurrency=32,
                             timeout_factor=0.0)
    orig_ready = DynamicScheduler._ready
    stuck = {}
    delivered = []
    sched.on_chunk = lambda labels, srcs, offset: delivered.append(
        int(srcs[0]))

    def ready(fl):
        # the FIRST flight of chunk 1 is a permanent straggler; re-issued
        # copies (fresh flights) complete normally
        if fl.chunk_id == 1 and stuck.setdefault(1, fl) is fl:
            return False
        return orig_ready(fl)

    sched._ready = ready
    out = sched.run()
    assert sched.reissues >= 1
    assert sched.retired >= 1
    assert out["completed"] == out["chunks"]
    assert sorted(delivered) == list(range(0, a.n, 32))     # exactly once
    assert np.array_equal(out["l_counts"], l_ref)
    assert np.array_equal(out["u_counts"], u_ref)


def test_scheduler_threads_under_a_short_switch_interval():
    """More slots than cores, the interpreter switching threads every
    microsecond: every chunk is still delivered exactly once and the
    counts are the oracle's."""
    a = to_port(M.economic_like(192, block=16, seed=38))
    l_ref, u_ref = _refs(a)
    delivered = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out = DynamicScheduler(
            _graph(a), devices=[CPU] * (2 * (os.cpu_count() or 1) + 1),
            concurrency=8,
            on_chunk=lambda labels, srcs, offset: delivered.extend(
                srcs.tolist())).run()
    finally:
        sys.setswitchinterval(old)
    assert sorted(delivered) == list(range(a.n))
    assert out["completed"] == out["chunks"] == 24
    assert np.array_equal(out["l_counts"], l_ref)
    assert np.array_equal(out["u_counts"], u_ref)


def test_scheduler_raises_a_failed_chunk():
    """A chunk step that raises fails the run (never a silent gap)."""
    a = to_port(M.grid2d_laplacian(6))
    sched = DynamicScheduler(_graph(a), devices=[CPU] * 2, concurrency=8)

    def boom(srcs, graph):
        raise RuntimeError("chunk step failed")

    sched._step = boom
    with pytest.raises(RuntimeError, match="chunk step failed"):
        sched.run()


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_dynamic_runtime_matches_static_analyze(name):
    """``LUOptions(runtime="dynamic")`` drives ``analyze`` through the
    scheduler; counts, pattern, supernodes and fingerprints are bitwise the
    static chunk loop's on every structure, and the plan carries a
    placement for the visible devices."""
    a = to_port(GENERATORS[name]())
    static = _analyze(a, concurrency=48, supernode_relax=2)
    dyn = _analyze(a, concurrency=48, supernode_relax=2, runtime="dynamic")
    assert np.array_equal(dyn.sym.l_counts, static.sym.l_counts)
    assert np.array_equal(dyn.sym.u_counts, static.sym.u_counts)
    assert np.array_equal(dyn.sym.supernodes, static.sym.supernodes)
    assert np.array_equal(dyn.pattern.indptr, static.pattern.indptr)
    assert np.array_equal(dyn.pattern.rowind, static.pattern.rowind)
    for f in ("counts", "hsum", "hxor", "subdiag", "seen"):
        assert np.array_equal(getattr(dyn.sym.fingerprints, f),
                              getattr(static.sym.fingerprints, f))
    assert dyn.sym.supersteps == static.sym.supersteps
    assert dyn.sym.runtime["completed"] == dyn.sym.runtime["chunks"]
    assert dyn.sym.runtime["n_devices"] == 1
    assert dyn.placement is not None and dyn.n_devices == 1


@pytest.mark.parametrize("name", ["circuit", "bbd"])
def test_dynamic_symbolic_matches_reference(name):
    """The port's dynamic symbolic result against the reference's, on one
    slot each: counts, supersteps, pattern, supernodes and the runtime
    record."""
    from repro.core.symbolic import symbolic_factorize as ref_sym

    a = GENERATORS[name]()
    kw = dict(concurrency=48, detect_supernodes=True, collect_pattern=True,
              runtime="dynamic")
    ref = ref_sym(a, **kw)
    got = symbolic_factorize(to_port(a), device="cpu", **kw)
    assert np.array_equal(got.l_counts, ref.l_counts)
    assert np.array_equal(got.u_counts, ref.u_counts)
    assert got.supersteps == ref.supersteps
    assert np.array_equal(got.supernodes, ref.supernodes)
    assert np.array_equal(got.pattern.rowind, ref.pattern.rowind)
    assert got.runtime == ref.runtime


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
def test_dynamic_runtime_factors_and_solve_match(backend):
    a = to_port(M.circuit_like(200, seed=7))
    values = generic_values_csr(a)
    b = np.random.default_rng(0).standard_normal((a.n, 3))
    f_s = _analyze(a, concurrency=32,
                   numeric_backend=backend).factorize(values)
    f_d = _analyze(a, concurrency=32, numeric_backend=backend,
                   runtime="dynamic").factorize(values)
    assert torch.equal(f_d.store.flat, f_s.store.flat)
    assert torch.equal(f_d.solve(b).x, f_s.solve(b).x)


def test_dynamic_runtime_checkpoint_restart(tmp_path):
    """A dynamic-runtime symbolic pass restarted from a truncated checkpoint
    recomputes only the pending chunks and still delivers the complete
    pattern and supernode partition."""
    a = to_port(M.economic_like(192, block=16, seed=33))
    static = symbolic_factorize(a, concurrency=64, detect_supernodes=True,
                                device="cpu")
    path = os.path.join(tmp_path, "ckpt.jsonl")
    kw = dict(concurrency=64, checkpoint_path=path, runtime="dynamic",
              detect_supernodes=True, collect_pattern=True, device="cpu")
    r1 = symbolic_factorize(a, **kw)
    assert np.array_equal(r1.l_counts, static.l_counts)
    with open(path) as f:
        first = f.readline()
    with open(path, "w") as f:
        f.write(first)
    r2 = symbolic_factorize(a, **kw)
    assert np.array_equal(r2.l_counts, static.l_counts)
    assert np.array_equal(r2.u_counts, static.u_counts)
    assert np.array_equal(r2.supernodes, static.supernodes)
    assert r2.pattern.nnz == r1.pattern.nnz
    assert r2.supersteps < r1.supersteps


def test_dynamic_runtime_obs_counters(tracing):
    """Tracing on: the dynamic analyze emits the ``runtime`` span and the
    steal/re-issue/retire/chunk counters."""
    a = to_port(M.economic_like(160, block=16, seed=37))
    plan = _analyze(a, concurrency=32, runtime="dynamic")
    snap = tracing.snapshot()
    assert snap["counters"]["runtime.chunks"] == plan.sym.runtime["chunks"]
    for key in ("runtime.steals", "runtime.reissues", "runtime.retired"):
        assert key in snap["counters"]
    assert plan.stats is not None and plan.stats.find("runtime") is not None


@pytest.mark.parametrize("bad", [
    dict(bubble=True, runtime="dynamic"), dict(runtime="bogus"),
])
def test_dynamic_argument_checks_match_reference(bad):
    """Bubble with the dynamic runtime is accepted by ``LUOptions`` and
    raises the reference's ``ValueError`` in the symbolic pass."""
    from repro.core.symbolic import symbolic_factorize as ref_sym

    a = M.grid2d_laplacian(6)
    with pytest.raises(ValueError) as ref:
        ref_sym(a, **bad)
    with pytest.raises(ValueError) as got:
        symbolic_factorize(to_port(a), device="cpu", **bad)
    assert str(got.value) == str(ref.value)


def _ref_schedule(sched):
    """The reference's ``PanelSchedule`` over the port's schedule arrays."""
    from repro.numeric.schedule import PanelSchedule as RefSchedule

    return RefSchedule(supernodes=sched.supernodes,
                       ancestors=sched.ancestors, level=sched.level,
                       levels=sched.levels, partition=sched.partition,
                       col_counts=sched.col_counts)


@pytest.mark.parametrize("name", ["bbd", "circuit", "chemical"])
@pytest.mark.parametrize("n_devices", [1, 2, 3, 8])
def test_build_placement_matches_reference(name, n_devices, tracing):
    """``device_of_panel``, ``level_loads``, segments and the
    ``placement.imbalance_modeled`` observations equal the reference's on
    the same schedule."""
    from repro.numeric.schedule import build_placement as ref_place
    from repro.obs import metrics as rom
    from repro.obs import trace as rot

    plan = _analyze(to_port(GENERATORS[name]()), concurrency=48,
                    supernode_relax=2)
    got = build_placement(plan.schedule, n_devices, axis="shards")
    rot.disable()
    rom.registry().reset()
    rot.enable()
    try:
        want = ref_place(_ref_schedule(plan.schedule), n_devices,
                         axis="shards")
        ref_obs = rom.registry().get("placement.imbalance_modeled")
        ref_obs = None if ref_obs is None else ref_obs.values
    finally:
        rot.disable()
        rom.registry().reset()
    assert got.n_devices == want.n_devices and got.axis == want.axis
    assert np.array_equal(got.device_of_panel, want.device_of_panel)
    assert np.array_equal(got.level_loads(plan.schedule),
                          want.level_loads(_ref_schedule(plan.schedule)))
    for level in plan.schedule.levels:
        for s_got, s_want in zip(got.segments(level), want.segments(level)):
            assert np.array_equal(s_got, s_want)
    got_obs = tracing.get("placement.imbalance_modeled")
    assert (None if got_obs is None else got_obs.values) == ref_obs
    assert (ref_obs is None) == (n_devices == 1)
    with pytest.raises(ValueError, match="n_devices must be >= 1"):
        build_placement(plan.schedule, 0)


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
@pytest.mark.parametrize("segment_batch", [True, False])
def test_place_is_bitwise_at_every_device_count(backend, segment_batch):
    """``plan.place(d)`` changes scheduling only: factors, (n,) and (n, k)
    solves bitwise the unplaced plan's for d in {1, 2, 4, 8}."""
    a = to_port(M.bordered_block_diagonal(320, block=16, border=32, seed=6))
    values = generic_values_csr(a)
    b1 = np.random.default_rng(1).standard_normal(a.n)
    bk = np.random.default_rng(2).standard_normal((a.n, 3))
    plan = _analyze(a, concurrency=48, supernode_relax=2,
                    numeric_backend=backend, segment_batch=segment_batch)
    assert plan.placement is None and plan.n_devices == 1
    base = plan.factorize(values)
    x1, xk = base.solve(b1).x, base.solve(bk).x
    for d in (1, 2, 4, 8):
        assert plan.place(d) is plan and plan.n_devices == d
        got = plan.factorize(values)
        assert torch.equal(got.store.flat, base.store.flat), d
        assert torch.equal(got.solve(b1).x, x1), d
        assert torch.equal(got.solve(bk, batched=False).x,
                           base.solve(bk, batched=False).x), d
        assert torch.equal(got.solve(bk).x, xk), d
        again = got.refactorize(values)
        assert torch.equal(again.store.flat, base.store.flat), d


def test_placed_plan_pickles_and_replans(tmp_path):
    """The placement travels in the pickle; a loaded plan re-places at any
    count (default: the visible devices) and factors bitwise; ``replan``
    keeps the placement's device count."""
    a = to_port(M.circuit_like(200, seed=7))
    values = generic_values_csr(a)
    plan = _analyze(a, concurrency=48).place(4)
    base = plan.factorize(values)
    loaded = pickle.loads(pickle.dumps(plan))
    assert loaded.n_devices == 4
    assert np.array_equal(loaded.placement.device_of_panel,
                          plan.placement.device_of_panel)
    assert loaded.place().n_devices == 1          # one visible device here
    assert torch.equal(loaded.factorize(values).store.flat, base.store.flat)
    re = repro_torch.replan(plan.place(3), plan.options.replace(
        supernode_relax=2))
    assert re.n_devices == 3
    assert re.placement.device_of_panel.shape == (re.n_supernodes,)


def test_placed_sweep_records_segments_and_imbalance(tracing):
    """Under tracing, a placed sweep opens a ``factor_segment`` span on
    each busy device's track and records ``factor.level_imbalance_measured``
    (max / mean segment time) for levels with several busy segments; the
    unplaced sweep records none."""
    a = to_port(M.bordered_block_diagonal(320, block=16, border=32, seed=6))
    values = generic_values_csr(a)
    plan = _analyze(a, concurrency=48)
    plan.factorize(values)
    assert "factor.level_imbalance_measured" not in (
        tracing.snapshot()["histograms"])
    plan.place(4).factorize(values)
    hist = tracing.snapshot()["histograms"]["factor.level_imbalance_measured"]
    assert hist["count"] >= 1 and hist["min"] >= 1.0
    tracks = {ev.track for ev in ot.tracer().events
              if ev.name == "factor_segment"}
    assert {"device 0", "device 1", "device 2", "device 3"} <= tracks
