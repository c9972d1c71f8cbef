"""Sharded GSoFa over ``torch.distributed``: every rank relaxes its own row
of the interleaved source matrix.

Sources are independent once per-source work is balanced, so scaling is a
scheduling question (paper §V, Fig 8): **interleaved source assignment**
``src[d, i] = d + i * D`` flattens the workload that grows with the source
id, where a contiguous split loads late shards ~10x heavier.

The run is SPMD (``launch/mesh.py``): each rank runs the single-device
fixpoint (``core.gsofa``) over chunks of its row of ``assign_sources`` on
its own device — no collective inside the loop, each rank's superstep
count its own — and the collectives come once, at the end: the per-source
counts and edge checks are all-reduced over disjoint owned sources, the
per-rank edge checks and per-step superstep counts all-gathered.

``distributed_multisource`` is the analyze driver: each rank's converged
chunks stream into its own supernode fingerprints (merged afterwards by
``runtime/collectives.merge_fingerprint_shards``) and its own pattern
collector (unioned once by ``gather_pattern``), so every rank ends with the
whole structure, bitwise the single-device analyze's.  Every per-source
fixpoint is unique and chunking-independent, so counts, fingerprints and
patterns do not depend on the shard count.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.gsofa import (
    SymbolicGraph, fill_masks, gsofa_batch, row_counts,
)
from repro_torch.obs import metrics as _om
from repro_torch.obs import trace as _ot


def assign_sources(n: int, n_shards: int, *,
                   policy: str = "interleave") -> np.ndarray:
    """(n_shards, ceil(n / n_shards)) source matrix; short rows padded by
    repeating the row's last source (idempotent duplicates, sliced on return).

    interleave: src[d, i] = d + i * D   (paper's round-robin, Fig 8 'after')
    contiguous: src[d, i] = d * C + i   (the imbalanced baseline, Fig 8 'before')
    """
    per = -(-n // n_shards)
    total = per * n_shards
    ids = np.arange(total, dtype=np.int32)
    if policy == "interleave":
        mat = ids.reshape(per, n_shards).T
    elif policy == "contiguous":
        mat = ids.reshape(n_shards, per)
    else:
        raise ValueError(policy)
    mat = np.where(mat < n, mat, np.int32(n - 1))
    return np.ascontiguousarray(mat)


def ownership_mask(srcs_mat: np.ndarray) -> np.ndarray:
    """(D, S) bool: True at the globally-first occurrence of each source.

    ``assign_sources`` pads short rows by clipping ids to ``n - 1``, so the
    last source can appear on several shards; exactly one shard must *own*
    each source or per-shard fingerprint partials would double-count on
    merge (``ColumnFingerprints.merge`` rejects overlapping shards for the
    same reason).
    """
    flat = srcs_mat.reshape(-1)
    owned = np.zeros(flat.shape, dtype=bool)
    _, first = np.unique(flat, return_index=True)
    owned[first] = True
    return owned.reshape(srcs_mat.shape)


def make_chunk_step(graph_n: int, *, backend: str = "ell",
                    max_iters: Optional[int] = None):
    """The single-device chunk step: the closure every rank of the sharded
    analyze and every slot of the dynamic scheduler (``runtime.scheduler``)
    runs.

    In: (C,) int32 sources on the graph's device + the graph.  Out:
    converged (C, n) labels, (C, n) bool fill masks, (C,) l/u counts and
    edge checks (device tensors), and the chunk's superstep count (an int)
    — the streams the fingerprint and pattern collectors consume.
    Per-source fixpoints are unique and chunking- and device-independent,
    so results are bitwise the same whichever device runs which chunk, in
    whatever order, however many times.
    """
    if max_iters is None:
        max_iters = graph_n + 2

    def step(srcs: torch.Tensor, graph: SymbolicGraph):
        res = gsofa_batch(graph, srcs, backend=backend, max_iters=max_iters)
        mask = fill_masks(res.labels, srcs)
        l_cnt, u_cnt = row_counts(res.labels, srcs)
        return res.labels, mask, l_cnt, u_cnt, res.edge_checks, res.iters

    return step


def _all_gather_np(mesh, arr: np.ndarray) -> np.ndarray:
    """(size, *arr.shape) stack of every rank's ``arr`` (same shape on
    every rank); ``arr[None]`` on a one-shard mesh."""
    if mesh.size == 1:
        return np.asarray(arr)[None]
    t = torch.as_tensor(np.ascontiguousarray(arr))
    out = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(out, t, group=mesh.group)
    return torch.stack(out).numpy()


def _all_reduce_sum(mesh, arr: np.ndarray) -> np.ndarray:
    if mesh.size == 1:
        return arr
    t = torch.as_tensor(arr)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t.numpy()


def distributed_symbolic(graph: SymbolicGraph, mesh, *,
                         policy: str = "interleave",
                         backend: str = "ell") -> dict:
    """Counts-only sharded fixpoint: this rank's whole row of sources in one
    batch; returns counts + balance metrics, the same on every rank."""
    n = graph.n
    n_shards = mesh.size
    srcs = assign_sources(n, n_shards, policy=policy)
    owned = ownership_mask(srcs)
    row, own = srcs[mesh.rank], owned[mesh.rank]
    step = make_chunk_step(n, backend=backend)
    _, _, l_cnt, u_cnt, edges, iters = step(
        torch.as_tensor(row, device=graph.device), graph)
    l_out = np.zeros(n, dtype=np.int64)
    u_out = np.zeros(n, dtype=np.int64)
    l_out[row[own]] = l_cnt.cpu().numpy()[own]
    u_out[row[own]] = u_cnt.cpu().numpy()[own]
    mine = np.array([edges.cpu().numpy()[own].astype(np.int64).sum()])
    per_dev_edges = _all_gather_np(mesh, mine)[:, 0]
    balance = float(per_dev_edges.max()) / max(1.0, float(per_dev_edges.min()))
    return {
        "l_counts": _all_reduce_sum(mesh, l_out),
        "u_counts": _all_reduce_sum(mesh, u_out),
        "per_device_edge_checks": per_dev_edges,
        "balance_ratio": balance,
        "iters": _all_gather_np(mesh, np.array([iters], np.int64))[:, 0],
        "n_shards": n_shards,
        "policy": policy,
    }


def distributed_multisource(graph: SymbolicGraph, mesh, *,
                            concurrency: int = 128, backend: str = "ell",
                            policy: str = "interleave",
                            on_shard_chunk: Optional[Callable] = None,
                            on_shard_mask: Optional[Callable] = None,
                            on_progress: Optional[Callable] = None):
    """Multi-source symbolic fixpoint over this rank's row of the source
    matrix, on the graph's device (every rank of ``mesh`` calls it).

    ``on_shard_chunk(d, labels, srcs)`` receives this rank's (``d``)
    converged (G, n) label tensor restricted to the rows it *owns*
    (``ownership_mask``) — where its ``ColumnFingerprints`` accumulate;
    ``on_shard_mask(d, mask, srcs)`` the matching fill masks, every row
    (``PatternCollector.update`` is idempotent).  Chunks are padded exactly
    as the reference pads them: a fixed width, repeating the row's last
    column, so a row made only of padding still runs its steps.
    ``on_progress(done, total, eta_s)`` fires after every chunk step.

    Each chunk's host reduction runs right after its fixpoint.  The
    reference double-buffers (it dispatches step k+1 before reducing step
    k); the port's fixpoint reads a host flag every superstep, so the
    overlap would need a second thread, and on an H100 (80GB HBM3, 700 W,
    bbd-20k at 512 sources a chunk, 2 ranks) a one-worker double buffer
    made the chunk loop 15–20 % slower than this loop: the two threads'
    Python serialises on the interpreter lock.  ``overlap_hidden_s`` is
    therefore 0.

    Returns a ``core.multisource.MultiSourceResult``, the same on every
    rank after the collectives, plus ``result.dist``: ``n_shards``,
    ``per_device_edge_checks``, ``balance_ratio``, ``policy``,
    ``overlap_hidden_s``.  ``supersteps`` sums, over steps, the slowest
    rank's superstep count of that step.
    """
    from repro_torch.core.multisource import MultiSourceResult

    n = graph.n
    n_shards, me = mesh.size, mesh.rank
    srcs_mat = assign_sources(n, n_shards, policy=policy)     # (D, per)
    row, row_own = srcs_mat[me], ownership_mask(srcs_mat)[me]
    per = len(row)
    concurrency = max(1, min(concurrency, per))
    step = make_chunk_step(n, backend=backend)

    l_counts = np.zeros(n, dtype=np.int64)
    u_counts = np.zeros(n, dtype=np.int64)
    edge_checks = np.zeros(n, dtype=np.int64)
    my_edges = 0
    step_iters = []
    total_steps = -(-per // concurrency)
    meter = _om.ProgressMeter(on_progress) if on_progress is not None else None

    for k, start in enumerate(range(0, per, concurrency)):
        cols = row[start:start + concurrency]
        own = row_own[start:start + concurrency]
        if len(cols) < concurrency:
            # fixed step shape: pad by repeating the row's last column
            # (duplicate sources are idempotent and never owned twice)
            short = concurrency - len(cols)
            cols = np.concatenate([cols, np.repeat(cols[-1:], short)])
            own = np.concatenate([own, np.zeros(short, dtype=bool)])
        with _ot.span("fixpoint_chunk"):
            labels, mask, l_cnt, u_cnt, edges, iters = step(
                torch.as_tensor(cols, device=graph.device), graph)
        step_iters.append(iters)
        with _ot.span("host_reduce"):
            srcs = cols[own]
            edges = edges.cpu().numpy()[own]
            l_counts[srcs] = l_cnt.cpu().numpy()[own]
            u_counts[srcs] = u_cnt.cpu().numpy()[own]
            edge_checks[srcs] = edges
            my_edges += int(edges.sum())
            if on_shard_chunk is not None and own.any():
                on_shard_chunk(me, labels[torch.as_tensor(
                    np.flatnonzero(own), device=labels.device)], srcs)
            if on_shard_mask is not None:
                on_shard_mask(me, mask, cols)
        if meter is not None:
            meter.update(k + 1, total_steps)

    with _ot.span("dist_collect"):
        l_counts = _all_reduce_sum(mesh, l_counts)
        u_counts = _all_reduce_sum(mesh, u_counts)
        edge_checks = _all_reduce_sum(mesh, edge_checks)
        per_dev_edges = _all_gather_np(mesh, np.array([my_edges]))[:, 0]
        # (D, steps): every rank runs the same number of steps; a step's
        # wall clock is its slowest rank's superstep count
        slowest = _all_gather_np(mesh, np.array(step_iters,
                                                np.int64)).max(axis=0)
    if _ot.ENABLED:
        reg = _om.registry()
        for it in slowest:
            reg.observe("fixpoint.iterations", int(it))
        reg.count("fixpoint.chunks", total_steps)

    result = MultiSourceResult(
        l_counts=l_counts, u_counts=u_counts, edge_checks=edge_checks,
        conv_iters=np.zeros(n, dtype=np.int64),
        supersteps=int(slowest.sum()), n_chunks=total_steps,
        concurrency=concurrency, reinits=total_steps, windows=total_steps)
    balance = (float(per_dev_edges.max()) / max(1.0, float(per_dev_edges.min()))
               if n_shards > 1 else 1.0)
    result.dist = {                                 # type: ignore[attr-defined]
        "n_shards": n_shards,
        "per_device_edge_checks": per_dev_edges,
        "balance_ratio": balance,
        "policy": policy,
        "overlap_hidden_s": 0.0,
    }
    return result


def gather_pattern(mesh, collector) -> None:
    """Union every rank's ``PatternCollector`` rows into ``collector`` in
    place (one all-gather of the collected row lists); a no-op on a
    one-shard mesh."""
    if mesh.size == 1:
        return
    rows = np.flatnonzero(collector.seen)
    mine = (rows, [collector.row_cols[r] for r in rows])
    everyone = [None] * mesh.size
    dist.all_gather_object(everyone, mine, group=mesh.group)
    for d, (rows_d, cols_d) in enumerate(everyone):
        if d == mesh.rank:
            continue
        for r, cols in zip(rows_d, cols_d):
            if not collector.seen[r]:
                collector.row_cols[r] = cols
                collector.seen[r] = True
