"""repro_torch's robust tier on the CPU against repro's.

Contract: the static-pivoting pre-pass (maximum-product transversal + Ruiz
equilibration, on the host) is bitwise the reference's; the plain options
die on the hostile generators with the reference's ``ZeroPivotError``
(column, panel, level, message); ``LUOptions(pivot="static", perturb=True)``
rescues them to residual <= 1e-8 with factors within 1e-10 of the
reference's; tiny-pivot perturbation on the device bumps and counts the
pivots the reference bumps (per system in the batched tier); the quality
report's verdicts equal the reference's, its estimates within 1e-8; the
transposed solve matches dense numpy; ``pivot="none"`` leaves the port's
path as it was; robust plans pickle and replay."""
import pickle

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.sparse import matrices as M
from repro.sparse.numeric import generic_values_csr
from repro_torch.numeric.solve import solve_factored_transposed
from repro_torch.robust import (
    RobustPlan, StructurallySingularError, equilibrate,
    max_product_transversal,
)
from repro_torch.sparse.csr import CSRMatrix
from repro_torch.sparse.numeric import (
    PERTURB_EPS, PerturbState, ZeroPivotError, lu_inplace,
)

# tiny shapes, several pytest workers: one intra-op thread each keeps
# torch's pool from oversubscribing the CPU
torch.set_num_threads(1)

KW = dict(supernode_relax=2)
ROBUST = dict(supernode_relax=2, pivot="static", perturb=True)

#: the rescue tier of the reference's tests: (pattern, CSR-aligned values)
#: pairs the pivot-free path raises ZeroPivotError on
HOSTILE = {
    "indefinite": lambda: (
        lambda a: (a, M.indefinite_values_csr(a, seed=1)))(
            M.indefinite(240, band=6, seed=1)),
    "shuffled": lambda: (
        lambda a: (a, M.shuffled_dominant_values_csr(a, band=6, seed=2)))(
            M.shuffled_dominant(240, band=6, seed=2)),
}


def to_port(a):
    return CSRMatrix(n=a.n, indptr=a.indptr.copy(), indices=a.indices.copy())


def _rel_err(got, ref):
    return np.abs(got - ref).max() / max(1.0, np.abs(ref).max())


def _host_residual(a, vals, x, b):
    from repro.sparse.numeric import csr_matvec
    return (np.linalg.norm(csr_matvec(a, vals, x) - b)
            / np.linalg.norm(b))


def _tiny_diag_system(n=60, band=4):
    """The reference tests' system whose first pivot is exactly 0.0 (no
    elimination update reaches column 0)."""
    a = M.banded_random(n, band=band, seed=9)
    vals = generic_values_csr(a, seed=9)
    rows = np.repeat(np.arange(n), np.diff(a.indptr))
    slot = np.flatnonzero((rows == 0) & (a.indices == 0))[0]
    vals = vals.copy()
    vals[slot] = 0.0
    return a, vals


@pytest.fixture(scope="module")
def hostile():
    """{name: (a, values, reference robust plan, port robust plan)}."""
    out = {}
    for name, make in HOSTILE.items():
        a, vals = make()
        ref = repro.analyze(a, repro.LUOptions(**ROBUST), values=vals)
        port = repro_torch.analyze(to_port(a), repro_torch.LUOptions(**ROBUST),
                                   values=vals, device="cpu")
        out[name] = (a, vals, ref, port)
    return out


# ---------------------------------------------------------------------------
# the pre-pass: bitwise the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(HOSTILE))
def test_prepass_bitwise_reference(name, hostile):
    a, vals, ref, port = hostile[name]
    for field in ("perm", "row_scale", "col_scale", "value_map",
                  "value_scale"):
        assert np.array_equal(getattr(port.robust, field),
                              getattr(ref.robust, field)), field
    assert np.array_equal(port.a_factored.indptr, ref.a_factored.indptr)
    assert np.array_equal(port.a_factored.indices, ref.a_factored.indices)
    assert port.a is not port.a_factored
    # the symbolic analysis ran on the permuted pattern: same structure
    assert np.array_equal(port.sym.supernodes, ref.sym.supernodes)
    assert np.array_equal(port.pattern.rowind, ref.pattern.rowind)
    # the value transform on the device is the host numpy transform
    fv = port._transform().transform_values(torch.as_tensor(vals))
    assert np.array_equal(fv.numpy(), ref.robust.transform_values(vals))


@pytest.mark.parametrize("case", ["rotation", "zero_diagonal", "banded"])
def test_transversal_and_equilibration_match_reference(case):
    from repro.robust import equilibrate as ref_equilibrate
    from repro.robust import max_product_transversal as ref_transversal
    from repro.sparse.csr import csr_from_dense

    if case == "rotation":
        rng = np.random.default_rng(0)
        n = 8
        base = rng.uniform(0.5, 1.5, (n, n)) * (np.abs(
            np.subtract.outer(np.arange(n), np.arange(n))) <= 2)
        np.fill_diagonal(base, 10.0)
        dense = np.roll(base, -2, axis=0)
        a = csr_from_dense(dense)
        values = dense
    elif case == "zero_diagonal":
        dense = np.array([[0.0, 3.0], [2.0, 1e-12]])
        a = csr_from_dense(np.ones((2, 2)))
        values = dense
    else:
        a = M.banded_random(40, band=4, seed=3)
        values = generic_values_csr(a) * 1e6
    perm = max_product_transversal(to_port(a), values)
    assert np.array_equal(perm, ref_transversal(a, values))
    if case == "rotation":
        assert np.array_equal(perm, (np.arange(8) - 2) % 8)
    if case == "zero_diagonal":
        assert np.array_equal(perm, [1, 0])
    rows = np.repeat(np.arange(a.n), np.diff(a.indptr))
    cols = a.indices.astype(np.int64)
    absv = (np.abs(values[rows, cols]) if np.ndim(values) == 2
            else np.abs(values))
    for got, want in zip(equilibrate(a.n, rows, cols, absv),
                         ref_equilibrate(a.n, rows, cols, absv)):
        assert np.array_equal(got, want)


def test_structurally_singular_raises_as_reference():
    from repro.robust import StructurallySingularError as RefError
    from repro.robust import max_product_transversal as ref_transversal
    from repro.sparse.csr import csr_from_dense

    dense = np.array([[1.0, 0.0, 1.0],
                      [1.0, 0.0, 1.0],
                      [1.0, 0.0, 1.0]])
    a = csr_from_dense(dense)
    with pytest.raises(RefError) as ref:
        ref_transversal(a, dense)
    with pytest.raises(StructurallySingularError) as got:
        max_product_transversal(to_port(a), dense)
    assert str(got.value) == str(ref.value)
    with pytest.raises(StructurallySingularError):
        repro_torch.analyze(to_port(a), repro_torch.LUOptions(pivot="static"),
                            values=dense, device="cpu")


# ---------------------------------------------------------------------------
# the plain options die as the reference's; the robust tier rescues
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(HOSTILE))
def test_plain_options_raise_reference_error(name):
    a, vals = HOSTILE[name]()
    with pytest.raises(repro.ZeroPivotError) as ref:
        repro.analyze(a, repro.LUOptions(**KW)).factorize(vals)
    with pytest.raises(ZeroPivotError) as got:
        repro_torch.analyze(to_port(a), repro_torch.LUOptions(**KW),
                            device="cpu").factorize(vals)
    e = got.value
    assert e.panel is not None and e.level is not None
    assert (e.k, e.panel, e.level) == (ref.value.k, ref.value.panel,
                                       ref.value.level)
    assert str(e) == str(ref.value)
    assert "pivot='static', perturb=True" in str(e)


@pytest.mark.parametrize("name", sorted(HOSTILE))
def test_robust_tier_rescues_as_reference(name, hostile):
    a, vals, ref, port = hostile[name]
    factor = port.factorize(vals)
    ref_factor = ref.factorize(vals)
    assert factor.perturbed_pivots == ref_factor.perturbed_pivots
    assert _rel_err(factor.l, ref_factor.l) <= 1e-10
    assert _rel_err(factor.u, ref_factor.u) <= 1e-10
    b = np.random.default_rng(7).standard_normal(a.n)
    res = factor.solve(b)
    assert res.residual <= 1e-8
    assert _host_residual(a, vals, res.x.numpy(), b) <= 1e-8
    # the refinement matvec is against the ORIGINAL matrix and values
    assert factor.values is not factor.factored_values
    assert torch.equal(factor.values, torch.as_tensor(vals))


@pytest.mark.parametrize("name", sorted(HOSTILE))
def test_robust_batched_is_sequential_bitwise(name, hostile):
    a, vals, ref, port = hostile[name]
    batch = np.stack([vals, vals * 1.25, vals * 0.8])
    factor = port.factorize_batch(batch)
    ref_pp = ref.factorize_batch(batch).perturbed_pivots
    assert factor.perturbed_pivots.tolist() == ref_pp.tolist()
    b = np.random.default_rng(11).standard_normal((3, a.n))
    res = factor.solve_batch(b)
    for i in range(3):
        seq = port.factorize(batch[i])
        assert torch.equal(factor.store.flat[i], seq.store.flat)
        sol = seq.solve(b[i])
        assert torch.equal(res.x[i], sol.x)
        assert res.residuals[i] == sol.residuals
        assert _host_residual(a, batch[i], res.x[i].numpy(), b[i]) <= 1e-8
        # the per-system view replays the transform
        assert torch.equal(factor.system(i).factored_values,
                           seq.factored_values)


# ---------------------------------------------------------------------------
# tiny-pivot perturbation on the device
# ---------------------------------------------------------------------------

def test_perturbation_matches_reference():
    a, vals = _tiny_diag_system()
    ref = repro.analyze(a, repro.LUOptions(perturb=True, **KW)).factorize(
        vals)
    factor = repro_torch.analyze(
        to_port(a), repro_torch.LUOptions(perturb=True, **KW),
        device="cpu").factorize(vals)
    assert factor.perturbed_pivots == ref.perturbed_pivots == 1
    thr = PERTURB_EPS * np.abs(vals).max()
    # the bumped pivot IS the threshold (the reference's value, bitwise)
    assert float(factor.num.store.blocks[0][0, 0]) == thr
    assert float(factor.num.store.blocks[0][0, 0]) == \
        ref.num.store.blocks[0][0, 0]
    q, qr = factor.quality(), ref.quality()
    assert q.perturbed_pivots == 1 and q.verdict == qr.verdict == "suspect"


def test_perturbation_batched_counts_per_system():
    a, bad = _tiny_diag_system()
    good = generic_values_csr(a, seed=9)
    vb = np.stack([good, bad, good])
    ref = repro.analyze(a, repro.LUOptions(perturb=True, **KW)
                        ).factorize_batch(vb)
    factor = repro_torch.analyze(
        to_port(a), repro_torch.LUOptions(perturb=True, **KW),
        device="cpu").factorize_batch(vb)
    assert factor.perturbed_pivots.tolist() == [0, 1, 0]
    assert factor.perturbed_pivots.tolist() == ref.perturbed_pivots.tolist()
    for i in range(3):
        assert (factor.system(i).quality().verdict
                == ref.system(i).quality().verdict)


def test_batched_zero_pivot_message_equals_reference():
    a, bad = _tiny_diag_system()
    good = generic_values_csr(a, seed=9)
    vb = np.stack([good, good, bad])
    with pytest.raises(repro.ZeroPivotError) as ref:
        repro.analyze(a, repro.LUOptions(**KW)).factorize_batch(vb)
    with pytest.raises(ZeroPivotError) as got:
        repro_torch.analyze(to_port(a), repro_torch.LUOptions(**KW),
                            device="cpu").factorize_batch(vb)
    assert got.value.system == 2 and str(got.value) == str(ref.value)


@pytest.mark.parametrize("case", ["signed_zero", "zero_threshold",
                                  "non_finite", "last_pivot", "batched"])
def test_perturb_state_edges(case):
    """The sign of zero, a zero threshold, non-finite pivots, the last
    column of a block and per-system thresholds, against the reference's
    host elimination on the same blocks."""
    from repro.sparse.numeric import PerturbState as RefState
    from repro.sparse.numeric import lu_inplace as ref_lu
    from repro.sparse.numeric import lu_inplace_batched as ref_lu_batched

    rng = np.random.default_rng(3)
    m = rng.uniform(0.5, 1.5, (5, 5)) + 5.0 * np.eye(5)
    thr = 1e-3
    if case == "signed_zero":
        m[0, 0] = -0.0
    elif case == "zero_threshold":
        m[0, 0], thr = 0.0, 0.0
    elif case == "non_finite":
        m[0, 0] = np.inf
    elif case == "last_pivot":
        # column 4's pivot after elimination: make it exactly 0.0 by a
        # rank-deficient trailing block
        m[4] = m[3]
        m[4, 4] = m[3, 4]
    if case == "batched":
        mb = np.stack([m, m, m])
        mb[1, 0, 0] = 1e-9
        mb[2, 0, 0] = -1e-9
        thrs = np.array([thr, thr, 0.0])
        st = PerturbState(thrs, torch.device("cpu"))
        got = torch.as_tensor(mb)
        from repro_torch.sparse.numeric import lu_inplace_batched
        lu_inplace_batched(got, perturb=st)
        rs = RefState(thrs)
        want = mb.copy()
        try:
            ref_lu_batched(want, np.zeros(3), perturb=rs)
        except repro.ZeroPivotError:
            pass
        assert st.count.tolist() == rs.count.tolist() == [0, 1, 0]
        assert np.array_equal(got.diagonal(dim1=1, dim2=2)[:, 0].numpy(),
                              want[:, 0, 0])
        return
    st = PerturbState(thr, torch.device("cpu"))
    got = torch.as_tensor(m.copy())
    lu_inplace(got, perturb=st)
    rs = RefState(thr)
    want = m.copy()
    try:
        ref_lu(want, -1.0, perturb=rs)
    except repro.ZeroPivotError:
        pass                     # inf pivot: the check is the caller's here
    assert st.total() == rs.count
    d0 = got[0, 0].item()
    if case == "signed_zero":
        assert d0 == thr and np.copysign(1.0, d0) == 1.0 and st.total() == 1
    if case == "zero_threshold":
        assert d0 == 0.0 and st.total() == 0
    if case == "non_finite":
        assert d0 == np.inf and st.total() == 0
    if case == "last_pivot":
        assert st.total() >= 1 and abs(got[4, 4].item()) == thr
    if case in ("signed_zero", "last_pivot"):
        # every division finite: the elimination agrees with the host's
        assert np.allclose(got.numpy(), want, rtol=1e-12, atol=0.0)


def test_pivot_none_is_the_unperturbed_path():
    """``pivot="none"`` (and ``perturb=False``) is today's path: the same
    factors as the default options, and the diagonal LU is the elimination
    loop it was (one division and one rank-1 update per column but the
    last), bitwise."""
    a = M.banded_random(240, band=6, seed=4)
    vals = generic_values_csr(a)
    pa = to_port(a)
    base = repro_torch.analyze(pa, repro_torch.LUOptions(**KW), device="cpu")
    explicit = repro_torch.analyze(
        pa, repro_torch.LUOptions(pivot="none", perturb=False, **KW),
        device="cpu")
    f0, f1 = base.factorize(vals), explicit.factorize(vals)
    assert torch.equal(f0.store.flat, f1.store.flat)
    assert f1.perturbed_pivots == 0 and f1.factored_values is f1.values
    assert explicit.robust is None and explicit.a_factored is pa
    m = torch.as_tensor(np.random.default_rng(1).uniform(1, 2, (7, 7))
                        + 7 * np.eye(7))
    old = m.clone()
    for t in range(6):
        old[t + 1:, t] /= old[t, t]
        old[t + 1:, t + 1:] -= torch.outer(old[t + 1:, t], old[t, t + 1:])
    lu_inplace(m)
    assert torch.equal(m, old)


# ---------------------------------------------------------------------------
# quality: estimates and verdicts against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["banded", "indefinite", "shuffled"])
def test_quality_matches_reference(name, hostile):
    if name == "banded":
        a = M.banded_random(120, band=5, seed=6)
        vals = generic_values_csr(a, seed=6)
        q = repro_torch.analyze(to_port(a), repro_torch.LUOptions(**KW),
                                device="cpu").factorize(vals).quality()
        qr = repro.analyze(a, repro.LUOptions(**KW)).factorize(
            vals).quality()
        true_cond = np.linalg.cond(_dense_of(a, vals), 1)
        assert q.cond_1_est <= true_cond * (1 + 1e-8)
        assert q.verdict == "ok" and q.ok
    else:
        a, vals, ref, port = hostile[name]
        q = port.factorize(vals).quality()
        qr = ref.factorize(vals).quality()
    assert q.verdict == qr.verdict
    assert q.perturbed_pivots == qr.perturbed_pivots
    for field in ("growth", "cond_1_est", "norm1_a"):
        got, want = getattr(q, field), getattr(qr, field)
        assert abs(got - want) <= 1e-8 * abs(want), field


@pytest.mark.parametrize("args", [
    (np.inf, 1.0, 0), (1.0, 1e15, 0), (1.0, 1e12, 0), (1e7, 1.0, 0),
    (1.0, 1.0, 3), (1.0, 1.0, 0), (1e11, 1.0, 0), (1.0, np.nan, 0)])
def test_verdict_rule_matches_reference(args):
    from repro.robust.condition import _verdict as ref_verdict
    from repro_torch.robust.condition import _verdict

    assert _verdict(*args) == ref_verdict(*args)


def _dense_of(a, vals):
    d = np.zeros((a.n, a.n))
    rows = np.repeat(np.arange(a.n), np.diff(a.indptr))
    d[rows, a.indices] = vals
    return d


def test_transposed_solve_matches_dense():
    a = M.banded_random(80, band=5, seed=5)
    vals = generic_values_csr(a, seed=5)
    factor = repro_torch.analyze(to_port(a), repro_torch.LUOptions(**KW),
                                 device="cpu").factorize(vals)
    b = np.random.default_rng(5).standard_normal(a.n)
    x = solve_factored_transposed(factor.num, torch.as_tensor(b)).numpy()
    want = np.linalg.solve(_dense_of(a, vals).T, b)
    assert np.abs(x - want).max() <= 1e-12 * np.abs(want).max()


# ---------------------------------------------------------------------------
# plan persistence
# ---------------------------------------------------------------------------

def test_robust_plan_pickles_and_replays(hostile):
    a, vals, _, plan = hostile["shuffled"]
    f1 = plan.factorize(vals)
    clone = pickle.loads(pickle.dumps(plan))
    assert isinstance(clone.robust, RobustPlan)
    assert clone._device_cache == {}
    for field in ("perm", "row_scale", "col_scale", "value_map",
                  "value_scale"):
        assert np.array_equal(getattr(clone.robust, field),
                              getattr(plan.robust, field))
    f2 = clone.factorize(vals)
    assert torch.equal(f1.store.flat, f2.store.flat)
    b = np.arange(a.n, dtype=np.float64)
    assert torch.equal(f1.solve(b).x, f2.solve(b).x)
    # the device tables are the plan's numpy arrays, rebuilt after loading
    rhs = torch.as_tensor(np.stack([b, 2 * b], axis=1))
    want = plan.robust.row_scale[:, None] * rhs.numpy()[plan.robust.perm]
    assert np.array_equal(clone._transform().apply_rhs(rhs).numpy(), want)
