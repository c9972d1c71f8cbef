"""repro_torch bubble removal and the fill oracles against repro, on the CPU.

Bubble removal narrows a chunk's labels to ``max(src) + 1`` rounded up to
a multiple of 256, so a chunk is narrower than n only for n > 256: the
matrices here are n = 600 and 700 with ``concurrency=64``, and the tests
assert that narrow chunks occur.  The narrowed fixpoint must give the
reference's bubble run bitwise (counts, edge checks, conv iters,
supersteps, masks, the K2 fingerprints of the narrow label chunks) and
the full-width run's structure (counts, supernodes, CSC pattern)."""
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import fill2 as ref_fill2
from repro.core import gsofa as ref_gsofa
from repro.core import multisource as ref_ms
from repro.core import theory as ref_theory
from repro.sparse import matrices as M
from repro.sparse.numeric import generic_values_csr
from repro.supernodes import ColumnFingerprints as RefFingerprints
from repro.supernodes import detect_from_fingerprints as ref_detect
from repro_torch.core import fill2, gsofa, multisource, theory
from repro_torch.core.symbolic import symbolic_factorize
from repro_torch.sparse.csr import CSRMatrix
from repro_torch.supernodes import (
    ColumnFingerprints, detect_supernodes_batched, fingerprints_from_graph,
)

# tiny shapes, several pytest workers: one intra-op thread each keeps
# torch's pool from oversubscribing the CPU
torch.set_num_threads(1)

GENERATORS = {
    "circuit": lambda: M.circuit_like(700, seed=3),
    "bbd": lambda: M.bordered_block_diagonal(600, block=16, border=24,
                                             seed=4),
}
C = 64
_CACHE = {}


def to_port(a):
    return CSRMatrix(n=a.n, indptr=a.indptr.copy(), indices=a.indices.copy())


def reference_bubble(gen):
    """The reference's bubble run of one generator with its masks and the
    fingerprints of its label chunks, cached."""
    if gen not in _CACHE:
        a = GENERATORS[gen]()
        fp = RefFingerprints(n=a.n, backend="ref")
        res = ref_ms.run_multisource(ref_gsofa.prepare_graph(a),
                                     concurrency=C, bubble=True,
                                     collect_masks=True, on_chunk=fp.update)
        _CACHE[gen] = (a, res, fp)
    return _CACHE[gen]


@pytest.mark.parametrize("n,c", [(100, 64), (300, 64), (700, 64),
                                 (1000, 128), (257, 256), (513, 100)])
def test_plan_chunks_match_reference(n, c):
    for bubble in (False, True):
        want = ref_ms.plan_chunks(n, c, bubble=bubble)
        got = multisource.plan_chunks(n, c, bubble=bubble)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.array_equal(g.srcs, w.srcs)
            assert (g.n_real, g.width) == (w.n_real, w.width)


@pytest.mark.parametrize("backend", ["ell", "kernel"])
@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_bubble_run_matches_reference_bitwise(gen, backend):
    """The port's bubble run against the reference's (whose results do
    not depend on the backend): the per-row counts, edge checks, conv
    iters, supersteps, reinits, the full-width masks, and the fingerprints
    K2 folds from the narrow (G, W) label chunks.  Under ``backend=
    "kernel"`` the full-width chunks go through K1 (its plain version
    here), the narrow ones through the ELL relax."""
    a, ref, ref_fp = reference_bubble(gen)
    chunks = multisource.plan_chunks(a.n, C, bubble=True)
    assert any(ch.width < a.n for ch in chunks)
    assert any(ch.width == a.n for ch in chunks)
    graph = gsofa.prepare_graph(
        to_port(a), dense_block=128 if backend == "kernel" else None,
        device="cpu")
    masks = np.zeros((a.n, a.n), dtype=bool)
    widths = []

    def on_mask(mask, srcs):
        assert tuple(mask.shape) == (len(srcs), a.n)
        masks[srcs] = mask.numpy()

    fp = ColumnFingerprints(n=a.n)

    def on_chunk(labels, srcs, offset):
        widths.append(labels.shape[1])
        fp.update(labels, srcs, offset)

    got = multisource.run_multisource(graph, concurrency=C, backend=backend,
                                      bubble=True, on_chunk=on_chunk,
                                      on_mask=on_mask)
    assert widths == [ch.width for ch in chunks]
    for field in ("l_counts", "u_counts", "edge_checks", "conv_iters"):
        assert np.array_equal(getattr(got, field), getattr(ref, field)), field
    assert (got.supersteps, got.n_chunks, got.reinits, got.windows) == (
        ref.supersteps, ref.n_chunks, ref.reinits, ref.windows)
    assert np.array_equal(masks, ref.masks)
    for field in ("counts", "hsum", "hxor", "subdiag", "seen"):
        assert np.array_equal(getattr(fp, field), getattr(ref_fp, field))


@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_bubble_symbolic_matches_full_width(gen):
    """``symbolic_factorize`` with bubble against without: counts,
    supernodes, the CSC pattern and the fingerprints bitwise; the bubble
    run's own counters equal the reference's bubble run."""
    a = to_port(GENERATORS[gen]())
    kw = dict(concurrency=C, detect_supernodes=True, collect_pattern=True,
              supernode_relax=1, device="cpu")
    full = symbolic_factorize(a, **kw)
    bub = symbolic_factorize(a, bubble=True, **kw)
    assert np.array_equal(bub.l_counts, full.l_counts)
    assert np.array_equal(bub.u_counts, full.u_counts)
    assert np.array_equal(bub.supernodes, full.supernodes)
    assert np.array_equal(bub.pattern.indptr, full.pattern.indptr)
    assert np.array_equal(bub.pattern.rowind, full.pattern.rowind)
    for field in ("counts", "hsum", "hxor", "subdiag"):
        assert np.array_equal(getattr(bub.fingerprints, field),
                              getattr(full.fingerprints, field))
    _, ref, _ = reference_bubble(gen)
    assert bub.supersteps == ref.supersteps
    assert bub.reinits == ref.reinits
    assert bub.fill_ratio == full.fill_ratio


def test_bubble_checkpoint_restart_matches(tmp_path):
    """A checkpointed bubble run restarted from half its records (the
    pending sources re-run as full-width chunks, the collectors' missing
    rows re-run too) gives the uninterrupted run's structure."""
    a = to_port(GENERATORS["bbd"]())
    kw = dict(concurrency=C, detect_supernodes=True, collect_pattern=True,
              bubble=True, device="cpu")
    path = tmp_path / "ckpt.jsonl"
    whole = symbolic_factorize(a, checkpoint_path=str(path), **kw)
    lines = path.read_text().splitlines()
    path.write_text("\n".join(lines[:len(lines) // 2]) + "\n")
    again = symbolic_factorize(a, checkpoint_path=str(path), **kw)
    assert np.array_equal(again.l_counts, whole.l_counts)
    assert np.array_equal(again.u_counts, whole.u_counts)
    assert np.array_equal(again.supernodes, whole.supernodes)
    assert np.array_equal(again.pattern.rowind, whole.pattern.rowind)


def test_analyze_bubble_gives_the_full_width_plan():
    """``analyze(bubble=True)`` on the CPU: the same plan structure and
    bitwise the same factors and solution as the full-width plan."""
    a = M.circuit_like(320, seed=5)
    values = generic_values_csr(a)
    b = np.random.default_rng(0).standard_normal(a.n)
    opts = repro_torch.LUOptions(concurrency=C, supernode_relax=2)
    full = repro_torch.analyze(to_port(a), opts, device="cpu")
    bub = repro_torch.analyze(to_port(a), opts.replace(bubble=True),
                              device="cpu")
    assert any(ch.width < a.n
               for ch in multisource.plan_chunks(a.n, C, bubble=True))
    assert bub.options.bubble and bub.sym.reinits == len(
        multisource.plan_chunks(a.n, C))
    assert np.array_equal(bub.sym.supernodes, full.sym.supernodes)
    assert np.array_equal(bub.pattern.rowind, full.pattern.rowind)
    fb, ff = bub.factorize(values), full.factorize(values)
    assert torch.equal(fb.store.flat, ff.store.flat)
    assert torch.equal(fb.solve(b).x, ff.solve(b).x)


@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_detect_supernodes_batched_with_bubble(gen):
    """``fingerprints_from_graph`` / ``detect_supernodes_batched`` with
    bubble give the reference's fingerprints and ranges."""
    a, _, ref_fp = reference_bubble(gen)
    graph = gsofa.prepare_graph(to_port(a), device="cpu")
    fp = fingerprints_from_graph(graph, concurrency=C, bubble=True)
    for field in ("counts", "hsum", "hxor", "subdiag", "seen"):
        assert np.array_equal(getattr(fp, field), getattr(ref_fp, field))
    for relax in (0, 2):
        want = ref_detect(ref_fp, relax=relax, max_size=16)
        got = detect_supernodes_batched(to_port(a), relax=relax, max_size=16,
                                        concurrency=C, bubble=True,
                                        device="cpu")
        assert np.array_equal(got, want)
        assert np.array_equal(detect_supernodes_batched(
            graph, relax=relax, max_size=16, fp=fp), want)


ORACLE_GENERATORS = {
    "circuit": lambda: M.circuit_like(110, seed=2),
    "banded": lambda: M.banded_random(96, band=5, seed=8),
}


@pytest.mark.parametrize("gen", sorted(ORACLE_GENERATORS))
def test_oracles_match_reference_and_fixpoint(gen):
    """The port's copies of the oracles equal the reference's, the two
    oracles agree, and the port's fixpoint (labels -> fill masks) and its
    symbolic pattern equal them."""
    a = ORACLE_GENERATORS[gen]()
    pa = to_port(a)
    dense = fill2.fill2_dense(pa)
    assert np.array_equal(dense, ref_fill2.fill2_dense(a))
    elim = theory.elimination_fill(pa)
    assert np.array_equal(elim, ref_theory.elimination_fill(a))
    minimax = theory.minimax_fill(pa)
    assert np.array_equal(minimax, ref_theory.minimax_fill(a))
    assert np.array_equal(theory.minimax_closure(pa),
                          ref_theory.minimax_closure(a))
    assert np.array_equal(dense, elim) and np.array_equal(dense, minimax)
    assert theory.fill_ratio(pa, dense) == ref_theory.fill_ratio(a, dense)
    rows, edges = fill2.fill2_all(pa)
    want_rows, want_edges = ref_fill2.fill2_all(a)
    assert np.array_equal(edges, want_edges)
    assert all(np.array_equal(r, w) for r, w in zip(rows, want_rows))

    graph = gsofa.prepare_graph(pa, device="cpu")
    got = np.zeros((a.n, a.n), dtype=bool)
    for start in range(0, a.n, 32):
        srcs = np.arange(start, min(start + 32, a.n), dtype=np.int32)
        res = gsofa.gsofa_batch(graph, srcs)
        got[srcs] = gsofa.fill_masks(res.labels,
                                     torch.as_tensor(srcs)).numpy()
    np.fill_diagonal(got, True)
    assert np.array_equal(got, dense)
    sym = symbolic_factorize(pa, concurrency=32, collect_pattern=True,
                             device="cpu")
    assert np.array_equal(sym.pattern.to_dense(), dense)


def test_luoptions_bubble_is_accepted():
    """Bubble with ``distribute`` or the dynamic runtime is accepted by
    ``LUOptions``, as in the reference, and ``analyze`` raises the
    reference's ``ValueError``: chunks there are full-width."""
    assert repro_torch.LUOptions(bubble=True).bubble
    a = M.grid2d_laplacian(6)
    for later in (dict(bubble=True, distribute=True),
                  dict(bubble=True, runtime="dynamic")):
        with pytest.raises(ValueError) as ref:
            repro.analyze(a, repro.LUOptions(**later))
        with pytest.raises(ValueError) as got:
            repro_torch.analyze(to_port(a), repro_torch.LUOptions(**later),
                                device="cpu")
        assert str(got.value) == str(ref.value)
