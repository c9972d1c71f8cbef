"""repro_torch symbolic path against repro, bitwise: the GSoFa fixpoint
(labels, superstep counts, edge checks), the label arena, the multi-source
driver and ``symbolic_factorize`` (counts, fill ratio, fingerprints,
supernodes, CSC pattern) on every generator and every relaxation backend.
The port runs on the CPU, where K1/K2 take their plain versions; the
reference reaches its Pallas kernels in interpret mode."""
import numpy as np
import pytest
import torch

from repro.core import gsofa as jgsofa
from repro.core import spaceopt as jspace
from repro.core import symbolic as jsym
from repro.sparse import matrices as M
from repro_torch.core import gsofa as tgsofa
from repro_torch.core import spaceopt as tspace
from repro_torch.core import symbolic as tsym
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
BACKENDS = ["ell", "dense", "kernel"]
C = 48          # one chunk width for every test here, so jit caches hit


def to_port(a):
    return CSRMatrix(n=a.n, indptr=a.indptr.copy(), indices=a.indices.copy())


def _graphs(a, backend):
    block = None if backend == "ell" else 128
    return (jgsofa.prepare_graph(a, dense_block=block),
            tgsofa.prepare_graph(to_port(a), dense_block=block,
                                  device="cpu"))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_gsofa_batch_bitwise(gen, backend):
    """Labels, iters, conv_iter and edge_checks of one strided source batch,
    plain-encoded and in a label window just under the int32 top."""
    a = GENERATORS[gen]()
    jg, tg = _graphs(a, backend)
    srcs = (np.arange(C, dtype=np.int32) * 7) % a.n
    offset = tspace.LabelArena(capacity=C, n=a.n,
                                 device="cpu").next_window()
    assert offset == jspace.LabelArena(capacity=C, n=a.n).next_window()
    for off in (0, offset):
        jl0 = jgsofa.init_labels(jg, srcs, offset=off)
        tl0 = tgsofa.init_labels(tg, torch.as_tensor(srcs), offset=off)
        np.testing.assert_array_equal(tl0.numpy(), np.asarray(jl0))
        ref = jgsofa.gsofa_batch(jg, srcs, backend=backend, labels0=jl0,
                                 offset=off)
        got = tgsofa.gsofa_batch(tg, srcs, backend=backend, labels0=tl0,
                                 offset=off)
        assert got.labels.dtype == torch.int32
        np.testing.assert_array_equal(got.labels.numpy(),
                                      np.asarray(ref.labels))
        assert got.iters == int(ref.iters)
        np.testing.assert_array_equal(got.conv_iter.numpy(),
                                      np.asarray(ref.conv_iter))
        np.testing.assert_array_equal(got.edge_checks.numpy(),
                                      np.asarray(ref.edge_checks))
        tmask = tgsofa.fill_masks(got.labels, torch.as_tensor(srcs), off)
        np.testing.assert_array_equal(
            tmask.numpy(), np.asarray(jgsofa.fill_masks(ref.labels, srcs,
                                                        off)))


def _assert_symbolic_equal(got, ref):
    np.testing.assert_array_equal(got.l_counts, ref.l_counts)
    np.testing.assert_array_equal(got.u_counts, ref.u_counts)
    assert got.fill_ratio == ref.fill_ratio
    assert (got.concurrency, got.supersteps, got.reinits) == (
        ref.concurrency, ref.supersteps, ref.reinits)
    assert got.memory_report == ref.memory_report
    np.testing.assert_array_equal(got.supernodes, ref.supernodes)
    assert got.n_supernodes == ref.n_supernodes
    np.testing.assert_array_equal(got.pattern.indptr, ref.pattern.indptr)
    np.testing.assert_array_equal(got.pattern.rowind, ref.pattern.rowind)
    for name in ("counts", "hsum", "hxor", "subdiag", "seen"):
        np.testing.assert_array_equal(getattr(got.fingerprints, name),
                                      getattr(ref.fingerprints, name))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_symbolic_factorize_bitwise(gen, backend):
    a = GENERATORS[gen]()
    kw = dict(concurrency=C, backend=backend, detect_supernodes=True,
              supernode_relax=1, collect_pattern=True)
    ref = jsym.symbolic_factorize(a, **kw)
    got = tsym.symbolic_factorize(to_port(a), device="cpu", **kw)
    _assert_symbolic_equal(got, ref)


@pytest.mark.parametrize("knobs", [
    dict(combined=False), dict(use_arena=False),
    dict(budget_bytes=60_000), dict(supernode_max_size=3),
])
def test_symbolic_factorize_knobs_bitwise(knobs):
    a = GENERATORS["circuit"]()
    kw = dict(concurrency=C, detect_supernodes=True, collect_pattern=True,
              **knobs)
    ref = jsym.symbolic_factorize(a, **kw)
    got = tsym.symbolic_factorize(to_port(a), device="cpu", **kw)
    _assert_symbolic_equal(got, ref)


def test_label_arena_windows_near_int32_top():
    """Window offsets descend from just under int32 max and wrap with one
    real re-initialization, exactly as the reference arena does."""
    n = 1000
    ref = jspace.LabelArena(capacity=4, n=n)
    got = tspace.LabelArena(capacity=4, n=n, device="cpu")
    assert got.buf.dtype == torch.int32
    offsets = []
    for arena in (ref, got):
        seq = [arena.next_window() for _ in range(3)]
        arena._offset = arena._floor + 1            # force the wraparound
        seq += [arena.next_window() for _ in range(2)]
        offsets.append(seq)
    assert offsets[0] == offsets[1]
    assert offsets[1][0] + n + 2 <= np.iinfo(np.int32).max
    assert (got.reinits, got.windows) == (ref.reinits, ref.windows) == (2, 5)
    assert int(got.buf.min()) == np.iinfo(np.int32).max
    with pytest.raises(RuntimeError, match="next_window"):
        tspace.LabelArena(capacity=1, n=4, device="cpu").offset


def test_checkpoint_restart_replays_bitwise(tmp_path):
    """A restart that reuses recorded chunks (at another concurrency) gives
    the same counts, supernodes and pattern as a fresh run."""
    a = to_port(GENERATORS["bbd"]())
    path = str(tmp_path / "ckpt.jsonl")
    kw = dict(detect_supernodes=True, collect_pattern=True, device="cpu")
    fresh = tsym.symbolic_factorize(a, concurrency=C, **kw)
    first = tsym.symbolic_factorize(a, concurrency=C, checkpoint_path=path,
                                    **kw)
    ck = tsym.ChunkCheckpointer(path, a.n)
    ck.records = ck.records[:1]                     # keep one chunk only
    ck.covered[:] = False
    ck.covered[np.asarray(ck.records[0]["srcs"])] = True
    with open(path, "w") as f:
        import json
        f.write(json.dumps(ck.records[0]) + "\n")
    again = tsym.symbolic_factorize(a, concurrency=32, checkpoint_path=path,
                                    **kw)
    for res in (first, again):
        np.testing.assert_array_equal(res.l_counts, fresh.l_counts)
        np.testing.assert_array_equal(res.u_counts, fresh.u_counts)
        np.testing.assert_array_equal(res.supernodes, fresh.supernodes)
        np.testing.assert_array_equal(res.pattern.rowind,
                                      fresh.pattern.rowind)
