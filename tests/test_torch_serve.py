"""repro_torch's serving front end (plan cache + SolverEngine) on the CPU
against repro's.

Contract: ``pattern_fingerprint`` gives the reference's ``PatternKey`` for
the same pattern (a content hash: objects, pickling and entry order do not
change it, distinct patterns of one shape differ); ``PlanCache`` is the
reference's strict, locked LRU; ``SolverEngine`` answers every request
bitwise like the port's sequential ``analyze(...).factorize(v).solve(b)``
— padded slots computed and dropped — with ``stats`` counts equal to the
reference engine's on the same request stream, the reference's messages
for bad shapes, and quality reports on request."""
import dataclasses
import pickle
import threading

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.serve import SolverEngine as RefEngine
from repro.serve import pattern_fingerprint as ref_fingerprint
from repro.sparse import matrices as M
from repro.sparse import permute_csr, rcm_order
from repro.sparse.numeric import generic_values_csr
from repro_torch.serve import (
    PatternKey, PlanCache, ServeResult, SolverEngine, pattern_fingerprint,
)
from repro_torch.sparse.csr import CSRMatrix

# tiny shapes, several pytest workers: one intra-op thread each keeps
# torch's pool from oversubscribing the CPU
torch.set_num_threads(1)

KW = dict(concurrency=64, supernode_relax=2)
OPTS = repro_torch.LUOptions(**KW)
COUNTS = ("requests", "cache_hits", "cache_misses", "cache_evictions",
          "batches", "padded_slots", "quality_rejects")


def to_port(a):
    return CSRMatrix(n=a.n, indptr=a.indptr.copy(), indices=a.indices.copy())


def _matrix(seed=7, n=200):
    a = M.circuit_like(n, seed=seed)
    return permute_csr(a, rcm_order(a))


def _engine(**kw):
    return SolverEngine(OPTS, device="cpu", **kw)


_SEQ_PLANS = {}


def _sequential(a, vals, rhs):
    """The port's sequential API on a plan of its own (one per pattern)."""
    key = pattern_fingerprint(a)
    if key not in _SEQ_PLANS:
        _SEQ_PLANS[key] = repro_torch.analyze(to_port(a), OPTS, device="cpu")
    return _SEQ_PLANS[key].factorize(vals).solve(rhs)


# ---------------------------------------------------------------------------
# fingerprint: the reference's key, a content hash
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7])
def test_pattern_key_equals_reference(seed):
    a = _matrix(seed=seed)
    key = pattern_fingerprint(to_port(a))
    assert dataclasses.astuple(key) == dataclasses.astuple(
        ref_fingerprint(a))
    assert pickle.loads(pickle.dumps(key)) == key
    copy = CSRMatrix(n=a.n, indptr=a.indptr.copy(), indices=a.indices.copy())
    assert pattern_fingerprint(copy) == key
    assert hash(pattern_fingerprint(copy)) == hash(key)


def test_distinct_patterns_do_not_collide():
    a = _matrix(seed=1)
    b = permute_csr(a, np.random.default_rng(0).permutation(a.n))
    assert (b.n, b.nnz) == (a.n, a.nnz)
    assert pattern_fingerprint(to_port(a)) != pattern_fingerprint(to_port(b))
    keys = {pattern_fingerprint(to_port(_matrix(seed=s))) for s in range(8)}
    assert len(keys) == 8
    assert pattern_fingerprint(to_port(M.grid2d_laplacian(10))) not in keys


# ---------------------------------------------------------------------------
# PlanCache: strict LRU, locked
# ---------------------------------------------------------------------------

def _keys(count):
    return [PatternKey(n=10, nnz=10, h1=i, h2=i) for i in range(count)]


def test_lru_eviction_order():
    k = _keys(4)
    cache = PlanCache(capacity=3)
    for i in range(3):
        assert cache.put(k[i], f"plan{i}") is None
    assert cache.keys() == (k[0], k[1], k[2])
    assert cache.get(k[0]) == "plan0"          # refresh 0 -> 1 is LRU now
    assert cache.keys() == (k[1], k[2], k[0])
    assert cache.put(k[3], "plan3") == k[1]
    assert k[1] not in cache and len(cache) == 3
    assert cache.get(k[1]) is None
    assert cache.put(k[0], "plan0b") is None   # refresh, not insert
    assert cache.get(k[0]) == "plan0b" and len(cache) == 3


def test_capacity_one_thrash():
    k = _keys(3)
    cache = PlanCache(capacity=1)
    assert cache.put(k[0], "a") is None
    assert cache.put(k[1], "b") == k[0]
    assert cache.put(k[2], "c") == k[1]
    assert cache.get(k[0]) is None and cache.get(k[1]) is None
    assert cache.get(k[2]) == "c" and len(cache) == 1


def test_bad_capacity_and_slots_raise_reference_messages():
    for make, ref_make in ((lambda: PlanCache(capacity=0),
                            lambda: repro.serve.PlanCache(capacity=0)),
                           (lambda: _engine(batch_slots=0),
                            lambda: RefEngine(batch_slots=0))):
        with pytest.raises(ValueError) as ref:
            ref_make()
        with pytest.raises(ValueError) as got:
            make()
        assert str(got.value) == str(ref.value)


def test_cache_is_thread_safe_under_contention():
    keys = _keys(32)
    cache = PlanCache(capacity=8)
    errors = []
    start = threading.Barrier(8)

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            start.wait()
            for _ in range(2000):
                k = keys[rng.integers(len(keys))]
                if rng.random() < 0.5:
                    cache.put(k, f"plan-{k.h1}")
                else:
                    got = cache.get(k)
                    if got is not None:
                        assert got == f"plan-{k.h1}"
        except Exception as exc:   # pragma: no cover - only on regression
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert len(cache) <= 8
    ks = cache.keys()
    assert len(ks) == len(set(ks)) == len(cache)
    for k in ks:
        assert cache.get(k) == f"plan-{k.h1}"


# ---------------------------------------------------------------------------
# SolverEngine: bitwise the sequential port API, stats the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mats():
    return [_matrix(seed=s) for s in range(3)]


@pytest.mark.parametrize("rhs_cols", [0, 2])
def test_engine_matches_sequential_api_bitwise(rhs_cols, mats):
    eng = _engine(capacity=4, batch_slots=3)
    rng = np.random.default_rng(0)
    reqs = []
    for r in range(8):                         # 4 per pattern -> pad 2 slots
        a = mats[r % 2]
        vals = generic_values_csr(a, seed=r)
        rhs = rng.standard_normal((a.n, rhs_cols) if rhs_cols else a.n)
        reqs.append((eng.submit(to_port(a), vals, rhs), a, vals, rhs))
    assert eng.pending == 8
    results = eng.flush()
    assert eng.pending == 0
    assert [r.rid for r in results] == [rid for rid, *_ in reqs]
    for res, (rid, a, vals, rhs) in zip(results, reqs):
        assert isinstance(res, ServeResult)
        seq = _sequential(a, vals, rhs)
        assert res.x.dtype == torch.float64 and res.x.device.type == "cpu"
        assert torch.equal(res.x, seq.x)
        assert res.residual == seq.residuals[-1] <= 1e-10
    # per pattern 4 requests in slots of 3: a full chunk and one padded by 2
    assert eng.stats["padded_slots"] == 4 and eng.stats["batches"] == 4


def test_padding_slots_do_not_leak_into_results(mats):
    a = to_port(mats[0])
    eng = _engine(capacity=2, batch_slots=8)
    rng = np.random.default_rng(2)
    reqs = [eng.submit(a, generic_values_csr(a, seed=r),
                       torch.as_tensor(rng.standard_normal(a.n)))
            for r in range(3)]                 # 3 real, 5 padded slots
    results = eng.flush()
    assert len(results) == 3
    assert sorted(r.rid for r in results) == sorted(reqs)
    assert {r.slot for r in results} == {0, 1, 2}
    assert eng.stats["padded_slots"] == 5
    assert eng.flush() == []


def _stream(engine, port, mats):
    """The reference tests' request streams through one engine: 6 requests
    on one pattern (slots 4: two dispatches), then a cache hit; the third
    pattern's plan_for evicts (capacity 2) and a re-asked pattern is
    analyzed again."""
    rng = np.random.default_rng(1)
    conv = to_port if port else (lambda a: a)
    a = mats[0]
    for r in range(6):
        engine.submit(conv(a), generic_values_csr(a, seed=r),
                      rng.standard_normal(a.n))
    engine.flush()
    engine.submit(conv(a), generic_values_csr(a, seed=9),
                  rng.standard_normal(a.n))
    engine.flush()
    for m in mats[1:] + mats[:1]:
        engine.plan_for(conv(m))
    return {k: engine.stats[k] for k in COUNTS}


def test_engine_stats_equal_reference(mats):
    got = _stream(_engine(capacity=2, batch_slots=4), True, mats)
    want = _stream(RefEngine(repro.LUOptions(**KW), capacity=2,
                             batch_slots=4), False, mats)
    assert got == want
    assert got["cache_misses"] == 4 and got["cache_evictions"] == 2
    assert got["batches"] == 3 and got["padded_slots"] == 5


def test_engine_eviction_reanalyzes(mats):
    eng = _engine(capacity=2, batch_slots=2)
    plans = [eng.plan_for(to_port(a)) for a in mats]
    assert eng.stats["cache_evictions"] == 1   # third insert evicts first
    assert eng.plan_for(to_port(mats[2])) is plans[2]
    again = eng.plan_for(to_port(mats[0]))     # evicted -> fresh analyze
    assert again is not plans[0]
    assert np.array_equal(again.schedule.supernodes,
                          plans[0].schedule.supernodes)
    assert eng.stats["cache_misses"] == 4 and eng.stats["cache_hits"] == 1


def test_engine_one_shot_solve(mats):
    a = mats[0]
    vals = generic_values_csr(a, seed=0)
    rhs = np.random.default_rng(3).standard_normal(a.n)
    res = _engine().solve(to_port(a), vals, rhs)
    assert torch.equal(res.x, _sequential(a, vals, rhs).x)
    assert res.batch_id == 0 and res.slot == 0 and not res.cache_hit
    assert res.quality is None


@pytest.mark.parametrize("bad", ["values", "rhs", "rhs_ndim"])
def test_engine_rejects_bad_shapes_with_reference_messages(bad, mats):
    a = mats[0]
    vals, rhs = generic_values_csr(a), np.zeros(a.n)
    if bad == "values":
        vals = np.zeros(a.nnz + 1)
    elif bad == "rhs":
        rhs = np.zeros(a.n + 1)
    else:
        rhs = np.zeros((a.n, 2, 2))
    with pytest.raises(ValueError) as ref:
        RefEngine(repro.LUOptions(**KW)).submit(a, vals, rhs)
    with pytest.raises(ValueError) as got:
        _engine().submit(to_port(a), vals, rhs)
    assert str(got.value) == str(ref.value)


def test_engine_quality_attaches_reports():
    """Robust options and ``quality=True``: every result carries its
    system's report, equal to the sequential factorization's."""
    a = M.shuffled_dominant(160, band=5, seed=2)
    vals = M.shuffled_dominant_values_csr(a, band=5, seed=2)
    opts = OPTS.replace(pivot="static", perturb=True)
    eng = SolverEngine(opts, batch_slots=4, quality=True, device="cpu")
    rng = np.random.default_rng(2)
    rhs = [rng.standard_normal(a.n) for _ in range(5)]
    rids = [eng.submit(to_port(a), vals * (1.0 + 0.1 * i), r)
            for i, r in enumerate(rhs)]
    results = eng.flush()
    assert [r.rid for r in results] == rids
    plan = repro_torch.analyze(to_port(a), opts, values=vals, device="cpu")
    for i, r in enumerate(results):
        seq = plan.factorize(vals * (1.0 + 0.1 * i))
        assert torch.equal(r.x, seq.solve(rhs[i]).x)
        assert r.residual <= 1e-8
        assert r.quality is not None
        assert r.quality.verdict == seq.quality().verdict
        assert r.quality.perturbed_pivots == seq.perturbed_pivots
    assert eng.stats["quality_rejects"] == 0
    plain = SolverEngine(opts, batch_slots=4, device="cpu")
    assert plain.solve(to_port(a), vals, rhs[0]).quality is None
