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


def _unfused_superstep(graph, srcs, labels, prev_labels, offset, it, edges,
                       conv):
    """Superstep ``it`` as the ELL loop ran it op by op before K8 fused it:
    props, frontier, counts, ``relax_ell``, ``minimum``.  Returns the next
    labels, edges, conv and whether any row had a frontier."""
    cur = tgsofa.compute_prop(labels, srcs, offset)
    prev = (tgsofa.compute_prop(prev_labels, srcs, offset) if it
            else torch.full_like(cur, tgsofa.INF))
    frontier = cur != prev
    row_active = frontier.any(dim=1)
    edges = edges + torch.where(frontier, graph.out_deg[None, :], 0).sum(
        dim=1).to(torch.int32)
    conv = torch.where(row_active, it + 1, conv)
    nxt = torch.minimum(labels, tgsofa.relax_ell(cur, graph))
    return nxt, edges, conv, bool(row_active.any())


@pytest.mark.parametrize("case,sources,window,step,width", [
    ("first", C, False, 0, None),
    ("later", C, False, 2, None),
    ("window_first", C, True, 0, None),
    ("window_later", C, True, 3, None),
    ("one_source", 1, True, 1, None),
    ("bubble_view", C, False, 1, 96),
])
def test_ell_superstep_plain_is_the_unfused_sequence(case, sources, window,
                                                     step, width):
    """K8's plain version against the op-by-op superstep it replaced:
    labels, edges, conv and the flag, bitwise, at superstep ``step`` after
    ``step`` unfused ones (offset 0, or an arena window just under the
    int32 top over a stale buffer; one source; a truncated bubble view)."""
    from repro_torch.core.multisource import _chunk_view
    from repro_torch.kernels import plain

    a = to_port(GENERATORS["bbd"]())
    graph = tgsofa.prepare_graph(a, device="cpu")
    srcs = torch.as_tensor((a.n - 1 - 7 * np.arange(sources, dtype=np.int32))
                           % a.n)
    if width is not None:                       # a bubble chunk's view
        srcs = srcs % width
        view = _chunk_view(graph, width)
        labels = tgsofa.init_labels(view, srcs, nbrs=graph.out_ell[srcs])
        graph = view
    offset, stale = 0, None
    if window:
        arena = tspace.LabelArena(capacity=sources, n=a.n, device="cpu")
        offset = arena.next_window()
        rng = np.random.default_rng(sources)
        stale = torch.as_tensor(rng.integers(
            offset + a.n + 1, tgsofa.INF, size=(sources, a.n),
            endpoint=True).astype(np.int32))
    if width is None:
        labels = tgsofa.init_labels(graph, srcs, offset=offset,
                                    stale_buf=stale)
    assert graph.n < a.n if width else graph.n == a.n
    prev = labels
    edges = torch.zeros(sources, dtype=torch.int32)
    conv = torch.zeros(sources, dtype=torch.int32)
    flag = torch.zeros(1, dtype=torch.int32)
    for t in range(step):
        nxt, edges, conv, active = _unfused_superstep(
            graph, srcs, labels, prev, offset, t, edges, conv)
        prev, labels = labels, nxt
        flag[0] = t + 1 if active else flag[0]
    want, want_edges, want_conv, active = _unfused_superstep(
        graph, srcs, labels, prev, offset, step, edges, conv)
    # superstep 0 must not read the other buffer: it holds garbage
    out = (prev.clone() if step else torch.randint(
        -5, graph.n, labels.shape, dtype=torch.int32))
    got_edges, got_conv, got_flag = edges.clone(), conv.clone(), flag.clone()
    plain.ell_superstep_plain(labels, out, graph.in_ell, graph.out_deg, srcs,
                              got_edges, got_conv, got_flag, offset=offset,
                              it=step)
    assert torch.equal(out, want)
    assert torch.equal(got_edges, want_edges)
    assert torch.equal(got_conv, want_conv)
    assert active and int(got_flag) == step + 1


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
