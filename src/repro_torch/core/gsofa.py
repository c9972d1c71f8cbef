"""GSoFa: fine-grained parallel symbolic factorization as a batched fixpoint.

The paper's algorithm (Fig 4b) relaxes fill2's serial threshold order: all
frontiers expand in parallel, guarded by the monotone label

    maxId[v] = min over discovered paths src -> v of (max intermediate vertex id)

updated with atomicMin and re-visitation until convergence.  Here one
*superstep* relaxes every vertex of every source in the batch at once
(Jacobi); the atomicMin race becomes a min-reduction and the paper's
re-visitation is the fixpoint iteration itself (DESIGN.md §2).  The label
lattice and the fixpoint are those of ``repro.core.gsofa`` — labels,
superstep counts and edge checks are bitwise the same.

Key algebraic facts used:

* direct edges carry label -1 (no intermediates), so the converged filled
  structure of row ``src`` is ``{v != src : maxId[v] < v}``;
* only vertices ``u < src`` may expand (paper lines 6/15), so for v > src
  the Theorem-1 test collapses to reachability;
* the paper's "line 9.5" optimization is the clamp
  ``prop(u) = max(u, maxId[u])``, which the Jacobi step applies inherently.

Three relaxation backends share this module's driver:
  * ``ell``    — padded-ELL gather (the default), the whole superstep
    (props, gather-min, frontier, counts, label update) fused in K8
    (``kernels/ops.ell_superstep``: one launch on the card, its plain
    version on the CPU) over a Jacobi pair of label buffers,
  * ``dense``  — masked min against the dense adjacency in plain torch,
  * ``kernel`` — the same product through K1 (``kernels/ops.minmax_relax``:
    the CUDA kernel on the card, its plain version on the CPU).

Labels are int32 throughout with INF = int32 max; the label-window offsets
of ``core/spaceopt.py`` sit just under it, so nothing here may promote to
int64 (Python int scalars keep the tensor's int32 dtype).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import plain as kplain
from repro_torch.obs import metrics as _om
from repro_torch.obs import trace as _ot
from repro_torch.sparse.csr import (
    CSRMatrix, csr_to_ell, dense_block_adjacency, transpose_csr,
)

# label "uninitialized / unreachable / masked"
INF = kplain.INF


@dataclasses.dataclass(frozen=True)
class SymbolicGraph:
    """Device-resident graph data for the fixpoint."""

    n: int
    in_ell: torch.Tensor      # (V, K_in) int32 in-neighbors, padded with V
    out_ell: torch.Tensor     # (V, K_out) int32 out-neighbors, padded with V
    out_deg: torch.Tensor     # (V,) int32 true out-degrees (edge-check metric)
    adj_dense: Optional[torch.Tensor] = None  # (Vp, Vp) uint8 u->v rows

    @property
    def device(self) -> torch.device:
        return self.in_ell.device


def prepare_graph(a: CSRMatrix, *, dense_block: Optional[int] = None,
                  device=None) -> SymbolicGraph:
    """The fixpoint's graph tables on ``device`` (default: the card)."""
    if not _ot.ENABLED:
        return _prepare_graph(a, dense_block, device)
    with _ot.span("prepare_graph"):
        return _prepare_graph(a, dense_block, device)


def _prepare_graph(a: CSRMatrix, dense_block: Optional[int],
                   device) -> SymbolicGraph:
    device = kops.resolve_device(device)
    at = transpose_csr(a)
    in_ell, _ = csr_to_ell(at, pad_value=a.n, drop_diagonal=True)
    out_ell, _ = csr_to_ell(a, pad_value=a.n, drop_diagonal=True)
    deg = np.array([int(np.sum(a.row(i) != i)) for i in range(a.n)],
                   dtype=np.int32)
    adj = None
    if dense_block is not None:
        with _ot.span("dense_adjacency"):
            adj = torch.as_tensor(dense_block_adjacency(a, dense_block),
                                  device=device)
    return SymbolicGraph(
        n=a.n,
        in_ell=torch.as_tensor(in_ell, device=device),
        out_ell=torch.as_tensor(out_ell, device=device),
        out_deg=torch.as_tensor(deg, device=device),
        adj_dense=adj,
    )


# ---------------------------------------------------------------------------
# label initialization & relaxation supersteps
# ---------------------------------------------------------------------------

def init_labels(graph: SymbolicGraph, srcs: torch.Tensor, *,
                offset: int = 0,
                stale_buf: Optional[torch.Tensor] = None,
                nbrs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(S, V) labels encoded as ``offset + maxId``: out-neighbors of each source
    get ``offset - 1`` (direct edge, no intermediates); everything else is left
    "uninitialized" — either explicit INF, or, when ``stale_buf`` is given, the
    stale contents of an earlier label window (spaceopt.LabelArena), which by
    construction are > offset + n and therefore read as uninitialized.
    The result is a fresh contiguous (S, V) buffer."""
    v = graph.n
    s = srcs.shape[0]
    if nbrs is None:
        nbrs = graph.out_ell[srcs]                      # (S, K_out), pad >= V
    if stale_buf is None:
        lab = torch.full((s, v), INF, dtype=torch.int32, device=srcs.device)
    else:
        lab = torch.empty((s, v), dtype=torch.int32, device=srcs.device)
        lab.copy_(stale_buf)
    if v:
        # every label here is > offset - 1, so a min writes offset - 1 at
        # each out-neighbour; pad ids fold onto column V - 1 as INF, which
        # the min leaves as it is
        vals = torch.full(nbrs.shape, offset - 1, dtype=torch.int32,
                          device=srcs.device).masked_fill_(nbrs >= v, INF)
        lab.scatter_reduce_(1, nbrs.clamp(max=v - 1).long(), vals, "amin")
    return lab


def compute_prop(labels: torch.Tensor, srcs: torch.Tensor,
                 offset: int = 0) -> torch.Tensor:
    """Clamped propagation values, (S, V), in the offset encoding:
    ``max(offset + u, labels[u])`` for expandable u (u < src, label valid in the
    current window), else INF (``kernels/plain.ell_prop_plain``, the body K8's
    plain version shares)."""
    return kplain.ell_prop_plain(labels, srcs, offset)


def relax_ell(prop: torch.Tensor, graph: SymbolicGraph) -> torch.Tensor:
    """Candidate labels via ELL gather: cand[s, v] = min_{u in in-nbr(v)}
    prop[s, u] (``kernels/plain.ell_relax_plain``)."""
    return kplain.ell_relax_plain(prop, graph.in_ell)


def _pad_prop(prop: torch.Tensor, graph: SymbolicGraph) -> torch.Tensor:
    vp = graph.adj_dense.shape[0]
    if vp == graph.n:
        return prop.contiguous()
    return torch.cat([prop, torch.full((prop.shape[0], vp - graph.n), INF,
                                       dtype=torch.int32,
                                       device=prop.device)], dim=1)


def relax_dense(prop: torch.Tensor, graph: SymbolicGraph) -> torch.Tensor:
    """Candidates as a (min, max)-semiring product against the dense
    adjacency, in plain torch: cand[s, v] = min_u (adj[u, v] ? prop[s, u] :
    INF).  ``prop`` already encodes the u < src mask and the max(u, label)
    clamp, so this is a pure masked-min contraction."""
    return kplain.minmax_relax_plain(_pad_prop(prop, graph),
                                     graph.adj_dense)[:, :graph.n]


def relax_kernel(prop: torch.Tensor, graph: SymbolicGraph) -> torch.Tensor:
    """Candidates via K1 (the CUDA kernel for labels on the card)."""
    return kops.minmax_relax(_pad_prop(prop, graph),
                             graph.adj_dense)[:, :graph.n]


_BACKENDS = {"dense": relax_dense, "kernel": relax_kernel}


# ---------------------------------------------------------------------------
# fixpoint driver
# ---------------------------------------------------------------------------

class FixpointResult(NamedTuple):
    labels: torch.Tensor       # (S, V) converged maxId
    iters: int                 # total supersteps for the batch
    conv_iter: torch.Tensor    # (S,) last superstep at which each source was active
    edge_checks: torch.Tensor  # (S,) paper's workload counter (frontier out-degrees)


def gsofa_batch(graph: SymbolicGraph, srcs, *, backend: str = "ell",
                max_iters: Optional[int] = None,
                labels0: Optional[torch.Tensor] = None,
                offset: int = 0) -> FixpointResult:
    """Run the fine-grained parallel fixpoint for a batch of sources ("combined
    traversal": one shared computation over the whole batch, DESIGN.md §2).

    The superstep loop runs on the graph's device; the host reads one flag
    per superstep (whether any frontier is left), so ``iters``,
    ``conv_iter`` and ``edge_checks`` are exactly the reference's."""
    dev = graph.device
    if isinstance(srcs, torch.Tensor):
        srcs = srcs.to(device=dev, dtype=torch.int32)
    else:
        srcs = torch.as_tensor(np.asarray(srcs, dtype=np.int32), device=dev)
    n = graph.n
    if max_iters is None:
        max_iters = n + 2
    if backend == "ell":
        return _fused_ell(graph, srcs, labels0, offset, max_iters)
    labels = (init_labels(graph, srcs, offset=offset) if labels0 is None
              else labels0)
    relax = _BACKENDS[backend]
    s = srcs.shape[0]
    prev_prop = torch.full((s, n), INF, dtype=torch.int32, device=dev)
    conv = torch.zeros(s, dtype=torch.int32, device=dev)
    edges = torch.zeros(s, dtype=torch.int32, device=dev)
    out_deg = graph.out_deg[None, :]
    it = 0
    any_frontier = True
    while any_frontier and it < max_iters:
        cur_prop = compute_prop(labels, srcs, offset)
        # frontier = vertices whose propagation value changed since the last
        # superstep (includes the initial source-adjacency frontier at it=0,
        # because prev_prop starts all-INF).  Paper's edge-check workload
        # metric = sum of frontier out-degrees (Figs 7/8).
        frontier = cur_prop != prev_prop
        row_active = frontier.any(dim=1)
        edges = edges + torch.where(frontier, out_deg, 0).sum(
            dim=1).to(torch.int32)
        conv = torch.where(row_active, it + 1, conv)
        labels = torch.minimum(labels, relax(cur_prop, graph))
        prev_prop = cur_prop
        it += 1
        any_frontier = bool(_host_read(row_active.any()))
    # the final superstep only *verifies* the fixpoint; don't count it as work
    return FixpointResult(labels=labels, iters=max(it - 1, 0),
                          conv_iter=(conv - 1).clamp(min=0),
                          edge_checks=edges)


def _host_read(flag: torch.Tensor) -> int:
    """The host's one read a superstep: it waits here for the card."""
    if not _ot.ENABLED:
        return int(flag.item())
    with _ot.span("fixpoint_wait"):
        return int(flag.item())


def _fused_ell(graph: SymbolicGraph, srcs: torch.Tensor,
               labels0: Optional[torch.Tensor], offset: int,
               max_iters: int) -> FixpointResult:
    """The ``ell`` fixpoint: one K8 call a superstep (one launch on the
    card) over two label buffers that swap roles, and one read of the
    4-byte flag, which K8 sets to ``it + 1`` on a superstep with a
    frontier.  Without ``labels0`` the initial labels are built straight
    into the first buffer; a given ``labels0`` is copied, never written."""
    dev = graph.device
    s = srcs.shape[0]
    labels = (init_labels(graph, srcs, offset=offset) if labels0 is None
              else labels0.clone(memory_format=torch.contiguous_format))
    other = torch.empty_like(labels)
    conv = torch.zeros(s, dtype=torch.int32, device=dev)
    edges = torch.zeros(s, dtype=torch.int32, device=dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    it = 0
    any_frontier = True
    while any_frontier and it < max_iters:
        kops.ell_superstep(labels, other, graph.in_ell, graph.out_deg, srcs,
                           edges, conv, flag, offset=offset, it=it)
        labels, other = other, labels
        it += 1
        any_frontier = _host_read(flag) == it
    if _ot.ENABLED:
        _om.registry().count("fixpoint.fused_supersteps", it)
    return FixpointResult(labels=labels, iters=max(it - 1, 0),
                          conv_iter=(conv - 1).clamp(min=0),
                          edge_checks=edges)


# ---------------------------------------------------------------------------
# structure extraction
# ---------------------------------------------------------------------------

def fill_masks(labels: torch.Tensor, srcs: torch.Tensor,
               offset: int = 0) -> torch.Tensor:
    """(S, V) bool: filled structure of each row (originals + fill-ins, no diag)."""
    n = labels.shape[1]
    v_ids = torch.arange(n, dtype=torch.int32, device=labels.device)
    mask = labels < v_ids[None, :] + offset
    return mask & (v_ids[None, :] != srcs[:, None])


def row_counts(labels: torch.Tensor, srcs: torch.Tensor,
               offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row L-part / U-part structural counts (columns < src / > src)."""
    n = labels.shape[1]
    v_ids = torch.arange(n, dtype=torch.int32, device=labels.device)
    mask = fill_masks(labels, srcs, offset)
    l_cnt = (mask & (v_ids[None, :] < srcs[:, None])).sum(dim=1)
    u_cnt = (mask & (v_ids[None, :] > srcs[:, None])).sum(dim=1)
    return l_cnt, u_cnt
