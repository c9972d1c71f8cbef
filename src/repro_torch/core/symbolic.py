"""Symbolic factorization: CSR in, L/U structure out.

``symbolic_factorize`` runs the multi-source fixpoint on one device with the
paper's knobs (concurrency, combined traversal, bubble removal, memory
envelope) and chunk checkpointing for restart.  The converged chunks stream
into the supernode fingerprints and the sparse pattern collector, so no
dense (n, n) pattern is ever gathered.  Every output — counts, fill ratio, supernodes, CSC pattern —
is bitwise that of ``repro.core.symbolic.symbolic_factorize``.

With a ``mesh`` (``launch.mesh.FlatMesh``) the fixpoint shards its sources
over the ranks of a process group (``core.distributed``); with
``runtime="dynamic"`` it runs on the work-stealing scheduler's executor
slots (``runtime.scheduler``).  Both stream into the same collectors, and
every output stays bitwise the single-device one.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.gsofa import SymbolicGraph, prepare_graph
from repro_torch.core.multisource import MultiSourceResult, run_multisource
from repro_torch.core.spaceopt import aux_memory_report, auto_concurrency
from repro_torch.obs import metrics as _om
from repro_torch.obs import trace as _ot
from repro_torch.sparse.csr import CSRMatrix


@dataclasses.dataclass
class SymbolicResult:
    n: int
    l_counts: np.ndarray          # per-row strictly-lower structural counts
    u_counts: np.ndarray          # per-row strictly-upper structural counts
    fill_ratio: float             # #fill-ins / nnz(A)  (Table I statistic)
    concurrency: int              # effective #C after the memory envelope
    supersteps: int
    reinits: int
    elapsed_s: float
    memory_report: dict
    # supernode partition (detect_supernodes=True)
    supernodes: Optional[np.ndarray] = None   # (n_supernodes, 2) [start, end)
    n_supernodes: int = 0
    mean_supernode_size: float = 0.0
    # sparse L+U pattern streamed from the fixpoint (collect_pattern=True) —
    # a numeric.storage.CSCPattern
    pattern: Optional[object] = None
    # merged per-column fingerprints (detect_supernodes=True) — O(n) numpy
    fingerprints: Optional[object] = None

    @property
    def lu_nnz(self) -> int:
        return int(self.l_counts.sum() + self.u_counts.sum() + self.n)


class ChunkCheckpointer:
    """Per-chunk durable progress for long symbolic runs.

    The source space is embarrassingly parallel, so the checkpoint unit is a
    completed *source range*; restart resumes whatever sources no record
    covers.  Coverage is tracked per source, so a restart may use a different
    ``concurrency`` than the recording run.
    """

    def __init__(self, path: str, n: int):
        self.path = path
        self.n = n
        self.records: list[dict] = []
        self.covered = np.zeros(n, dtype=bool)
        self.done: dict[int, dict] = {}    # start -> latest rec (introspection)
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    rec = json.loads(line)
                    if rec["n"] == n:
                        self._remember(rec)

    def _remember(self, rec: dict) -> None:
        self.records.append(rec)
        self.covered[np.asarray(rec["srcs"], dtype=np.int64)] = True
        self.done[rec["start"]] = rec

    def pending_sources(self) -> np.ndarray:
        """Sources not covered by any record."""
        return np.flatnonzero(~self.covered).astype(np.int64)

    def record(self, start: int, srcs: np.ndarray, l_cnt: np.ndarray,
               u_cnt: np.ndarray) -> None:
        rec = {"n": self.n, "start": int(start), "srcs": srcs.tolist(),
               "l": l_cnt.tolist(), "u": u_cnt.tolist()}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
            f.flush()
            os.fsync(f.fileno())
        self._remember(rec)

    def restore_into(self, l_counts: np.ndarray, u_counts: np.ndarray) -> int:
        for rec in self.records:
            srcs = np.asarray(rec["srcs"], dtype=np.int64)
            l_counts[srcs] = np.asarray(rec["l"], dtype=np.int64)
            u_counts[srcs] = np.asarray(rec["u"], dtype=np.int64)
        return int(self.covered.sum())


class PatternCollector:
    """Streams the filled L+U structure out of the fixpoint as sparse rows.

    ``update`` consumes the (G, n) bool fill mask of each converged chunk
    exactly as ``run_multisource(on_mask=...)`` emits it (padded duplicate
    sources allowed; re-delivery is idempotent), copies it to the host, and
    reduces each row to its column-index list, so peak host memory is
    O(nnz(L+U)) + one chunk mask.  ``to_csc`` transposes the row lists into
    the ``storage.CSCPattern`` the packed numeric path consumes.
    """

    def __init__(self, n: int):
        self.n = n
        self.row_cols: list = [None] * n
        self.seen = np.zeros(n, dtype=bool)

    @property
    def complete(self) -> bool:
        return bool(self.seen.all())

    def update(self, mask, srcs: np.ndarray) -> int:
        """Accumulate one chunk's fill mask; returns #new rows consumed."""
        if not _ot.ENABLED:
            return self._update(mask, srcs)
        with _ot.span("pattern_collect"):
            return self._update(mask, srcs)

    def _update(self, mask, srcs: np.ndarray) -> int:
        srcs = np.asarray(srcs, dtype=np.int64)
        _, first = np.unique(srcs, return_index=True)
        keep = first[~self.seen[srcs[first]]]
        if len(keep) == 0:
            return 0
        if isinstance(mask, torch.Tensor):
            mask = mask.cpu().numpy()
        mask = np.asarray(mask, dtype=bool)
        for i in keep:
            src = int(srcs[i])
            row = np.flatnonzero(mask[i]).astype(np.int64)
            d = np.searchsorted(row, src)
            if d >= len(row) or row[d] != src:      # diagonal always present
                row = np.insert(row, d, src)
            self.row_cols[src] = row
            self.seen[src] = True
        return len(keep)

    def to_csc(self):
        """CSR row lists -> ``storage.CSCPattern`` (sorted rows per column)."""
        if not _ot.ENABLED:
            return self._to_csc()
        with _ot.span("pattern_to_csc"):
            return self._to_csc()

    def _to_csc(self):
        from repro_torch.numeric.storage import CSCPattern

        if not self.complete:
            missing = np.flatnonzero(~self.seen)
            raise ValueError(f"pattern incomplete: rows {missing[:8].tolist()}"
                             f"... of {self.n} were never collected")
        counts = np.array([len(r) for r in self.row_cols], dtype=np.int64)
        rows = np.repeat(np.arange(self.n, dtype=np.int64), counts)
        cols = (np.concatenate(self.row_cols) if self.n
                else np.zeros(0, dtype=np.int64))
        order = np.lexsort((rows, cols))
        indptr = np.zeros(self.n + 1, dtype=np.int64)
        np.add.at(indptr, cols + 1, 1)
        return CSCPattern(n=self.n, indptr=np.cumsum(indptr),
                          rowind=rows[order])


def _record_fill_metrics(res: SymbolicResult, a: CSRMatrix) -> None:
    """Fill gauges (obs registry, DESIGN.md §12)."""
    if not _ot.ENABLED:
        return
    reg = _om.registry()
    reg.gauge("fill.lu_nnz", res.lu_nnz)
    reg.gauge("fill.input_nnz", int(a.nnz))


def symbolic_factorize(a: CSRMatrix, *, concurrency: int = 128,
                       backend: str = "ell", combined: bool = True,
                       bubble: bool = False, use_arena: bool = True,
                       budget_bytes: Optional[int] = None,
                       checkpoint_path: Optional[str] = None,
                       graph: Optional[SymbolicGraph] = None,
                       detect_supernodes: bool = False,
                       supernode_relax: int = 0,
                       supernode_max_size: int = 64,
                       collect_pattern: bool = False,
                       mesh=None, runtime: str = "static",
                       device=None, on_progress=None) -> SymbolicResult:
    """Compute the L/U nonzero structure of ``a`` with the fixpoint on
    ``device`` (default: the card; the graph's device when ``graph`` is
    given).

    With ``detect_supernodes=True`` the per-chunk converged label matrices
    are folded into O(n) column fingerprints as they stream out of the
    fixpoint, and the result gains ``supernodes`` / ``n_supernodes`` /
    ``mean_supernode_size`` (``supernode_relax`` is the T3 merge tolerance,
    0 = exact T2; ``supernode_max_size`` caps panel width).

    With ``collect_pattern=True`` the sparse L+U structure streams out of the
    same chunks (``PatternCollector``) into ``result.pattern``, a
    ``storage.CSCPattern`` in O(nnz(L+U)) host memory.

    ``checkpoint_path`` records each chunk's counts durably; a restart runs
    only the sources no record covers.

    ``bubble`` narrows each chunk's labels to its sources' window
    (``multisource.plan_chunks``); every output stays bitwise that of the
    full-width run.

    With ``mesh`` (a ``launch.mesh.FlatMesh``; every rank of its process
    group calls this) the fixpoint shards its sources over the ranks
    (``core.distributed``): fingerprints accumulate per rank and merge
    through ring collectives, the pattern streams per rank and is unioned
    once, and every rank returns the mesh-less result bitwise, plus
    ``result.dist``.  ``device`` defaults to the mesh's.  The sharded path
    always runs combined full-width chunks: ``bubble`` and
    ``checkpoint_path`` raise there, ``use_arena`` is ignored.

    ``runtime="dynamic"`` runs the fixpoint on the work-stealing
    ``runtime.scheduler.DynamicScheduler`` with its default executor slots
    (one per visible CUDA device, or the CPU when ``device`` is the CPU):
    converged chunks stream into the same collectors, so every output stays
    bitwise the static loop's, and the result gains ``runtime`` (slots,
    chunks, steals, re-issues, retired).  ``checkpoint_path`` composes with
    it; ``mesh`` and ``bubble`` do not.
    """
    t0 = time.perf_counter()
    if runtime not in ("static", "dynamic"):
        raise ValueError(f"unknown runtime {runtime!r}; pick from "
                         f"('static', 'dynamic')")
    if mesh is not None:
        if runtime == "dynamic":
            raise ValueError(
                "runtime='dynamic' is the host-driven scheduler over the "
                "visible devices and cannot be combined with a shard_map "
                "mesh — drop one of the two")
        if checkpoint_path is not None:
            raise ValueError(
                "checkpoint_path is a single-device refinement; the "
                "distributed path re-runs lost shards instead (drop the "
                "mesh or the checkpoint)")
        if bubble:
            raise ValueError("bubble removal is not supported on the "
                             "distributed path (chunks are full-width)")
        if device is None and graph is None:
            device = mesh.device
    elif runtime == "dynamic" and bubble:
        raise ValueError("bubble removal is not supported on the "
                         "dynamic runtime (chunks are full-width)")
    if graph is None:
        dense_block = 128 if backend in ("dense", "kernel") else None
        graph = prepare_graph(a, dense_block=dense_block, device=device)
    eff_c = auto_concurrency(graph, budget_bytes, concurrency, backend)

    fp = None
    on_chunk = None
    if detect_supernodes:
        from repro_torch.supernodes import ColumnFingerprints

        fp = ColumnFingerprints(n=a.n)
        on_chunk = fp.update
    collector = PatternCollector(n=a.n) if collect_pattern else None
    on_mask = collector.update if collector is not None else None

    ckpt = ChunkCheckpointer(checkpoint_path, a.n) if checkpoint_path else None
    runtime_stats = None
    if mesh is not None:
        # this rank's row of the interleaved source matrix; the fingerprints
        # fold the chunks it owns and merge over the ring, the pattern rows
        # it collected are unioned once
        from repro_torch.core.distributed import (
            distributed_multisource, gather_pattern,
        )
        from repro_torch.launch.mesh import FLAT_AXIS
        from repro_torch.runtime.collectives import merge_fingerprint_shards

        with _ot.span("fixpoint"):
            ms = distributed_multisource(
                graph, mesh, concurrency=eff_c, backend=backend,
                on_shard_chunk=(None if fp is None else
                                lambda d, labels, srcs: fp.update(labels,
                                                                  srcs)),
                on_shard_mask=(None if collector is None else
                               lambda d, mask, srcs: collector.update(mask,
                                                                      srcs)),
                on_progress=on_progress)
        t_merge = time.perf_counter()
        if fp is not None:
            with _ot.span("fingerprint_merge"):
                fp = merge_fingerprint_shards(mesh, FLAT_AXIS, fp)
        if collector is not None:
            with _ot.span("pattern_gather"):
                gather_pattern(mesh, collector)
        ms.dist["merge_s"] = time.perf_counter() - t_merge
    elif runtime == "dynamic":
        from repro_torch.runtime.scheduler import DynamicScheduler

        sched = DynamicScheduler(graph, concurrency=eff_c, backend=backend,
                                 checkpointer=ckpt, on_chunk=on_chunk,
                                 on_mask=on_mask)
        with _ot.span("fixpoint"):
            out = sched.run()
        ms = MultiSourceResult(
            l_counts=out["l_counts"], u_counts=out["u_counts"],
            edge_checks=out["edge_checks"],
            conv_iters=np.zeros(a.n, np.int64),
            supersteps=out["supersteps"], n_chunks=out["completed"],
            concurrency=eff_c, reinits=out["completed"],
            windows=out["completed"])
        runtime_stats = {
            "n_devices": len(sched.devices),
            "chunks": out["chunks"], "completed": out["completed"],
            "steals": out["steals"], "reissues": out["reissues"],
            "retired": out["retired"],
        }
    elif ckpt is not None and ckpt.covered.any():
        # restart path: only run the uncovered sources, re-chunked on THIS
        # run's grid (the recording run may have used a different concurrency)
        l_counts = np.zeros(a.n, dtype=np.int64)
        u_counts = np.zeros(a.n, dtype=np.int64)
        ckpt.restore_into(l_counts, u_counts)
        pending = ckpt.pending_sources()
        supersteps = reinits = n_chunks = 0
        with _ot.span("fixpoint"):
            for start in range(0, len(pending), eff_c):
                srcs = pending[start:start + eff_c].astype(np.int32)
                res = run_multisource(graph, concurrency=eff_c,
                                      backend=backend, combined=combined,
                                      bubble=bubble, use_arena=use_arena,
                                      sources=srcs, on_chunk=on_chunk,
                                      on_mask=on_mask)
                l_counts[srcs] = res.l_counts[srcs]
                u_counts[srcs] = res.u_counts[srcs]
                supersteps += res.supersteps
                reinits += res.reinits
                n_chunks += 1
                ckpt.record(int(srcs[0]), srcs, res.l_counts[srcs],
                            res.u_counts[srcs])
        ms = MultiSourceResult(
            l_counts=l_counts, u_counts=u_counts,
            edge_checks=np.zeros(a.n, np.int64),
            conv_iters=np.zeros(a.n, np.int64),
            supersteps=supersteps, n_chunks=n_chunks, concurrency=eff_c,
            reinits=reinits, windows=0)
    else:
        with _ot.span("fixpoint"):
            ms = run_multisource(graph, concurrency=eff_c, backend=backend,
                                 combined=combined, bubble=bubble,
                                 use_arena=use_arena,
                                 budget_bytes=budget_bytes,
                                 on_chunk=on_chunk, on_mask=on_mask,
                                 on_progress=on_progress)
        if ckpt is not None:
            for start in range(0, a.n, eff_c):
                srcs = np.arange(start, min(start + eff_c, a.n), dtype=np.int64)
                ckpt.record(start, srcs, ms.l_counts[srcs], ms.u_counts[srcs])

    # checkpoint restart restored some chunks' counts without their label
    # matrices; re-run those sources once for whichever collectors miss them
    # (update() is idempotent, so one shared re-run feeds both)
    missing = np.zeros(a.n, dtype=bool)
    if fp is not None and not fp.complete:
        missing |= ~fp.seen
    if collector is not None and not collector.complete:
        missing |= ~collector.seen
    if missing.any():
        run_multisource(graph, concurrency=eff_c, backend=backend,
                        combined=combined, bubble=bubble,
                        use_arena=use_arena,
                        sources=np.flatnonzero(missing).astype(np.int32),
                        on_chunk=on_chunk, on_mask=on_mask)

    sn_ranges = None
    sn_count = 0
    sn_mean = 0.0
    if fp is not None:
        from repro_torch.supernodes import (
            detect_from_fingerprints, supernode_stats,
        )

        sn_ranges = detect_from_fingerprints(
            fp, relax=supernode_relax, max_size=supernode_max_size)
        stats = supernode_stats(sn_ranges)
        sn_count = stats["n_supernodes"]
        sn_mean = stats["mean_size"]

    row_ids = np.repeat(np.arange(a.n, dtype=np.int64), np.diff(a.indptr))
    nnz_offdiag = int(a.nnz) - int(np.count_nonzero(a.indices == row_ids))
    lu_offdiag = int(ms.l_counts.sum() + ms.u_counts.sum())
    fills = lu_offdiag - nnz_offdiag
    out = SymbolicResult(
        n=a.n, l_counts=ms.l_counts, u_counts=ms.u_counts,
        fill_ratio=fills / max(1, a.nnz),
        concurrency=ms.concurrency, supersteps=ms.supersteps,
        reinits=ms.reinits, elapsed_s=time.perf_counter() - t0,
        memory_report=aux_memory_report(graph, ms.concurrency, backend),
        supernodes=sn_ranges, n_supernodes=sn_count,
        mean_supernode_size=sn_mean,
        pattern=collector.to_csc() if collector is not None else None,
        fingerprints=fp,
    )
    if mesh is not None:
        out.dist = ms.dist                     # type: ignore[attr-defined]
    if runtime_stats is not None:
        out.runtime = runtime_stats            # type: ignore[attr-defined]
    _record_fill_metrics(out, a)
    return out
