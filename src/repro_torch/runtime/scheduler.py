"""Dynamic chunk scheduler: work stealing + straggler re-issue + elastic
scaling over executor slots on CUDA streams.

The sharded path (``core.distributed``) assigns sources statically; on a
real run, stragglers (slow or failed devices) break static balance.  This
host-driven scheduler treats source chunks as a work queue over the *same*
chunk step the static drivers run (``core.distributed.make_chunk_step``):
each completed chunk streams its converged label matrix and fill mask back
to the collectors, so supernode fingerprints and the sparse pattern
accumulate exactly as in ``run_multisource`` — which is what lets
``repro_torch.analyze`` itself run on it (``LUOptions(runtime="dynamic")``).

* each slot pulls the next chunk when its previous one completes (work
  stealing — a pull of a chunk whose round-robin home is another slot
  counts as a *steal*);
* a chunk whose slot exceeds ``timeout_factor`` x the median chunk time is
  re-issued to an idle slot (speculative re-execution; per-source fixpoints
  are unique and collector updates idempotent, so duplicates are harmless —
  once any copy completes, the superseded flights are *retired* so their
  slots rejoin the idle pool);
* slots can join/leave between chunks (elastic scaling);
* completed chunks go through the ``ChunkCheckpointer``, so a restart
  resumes pending work only.

An executor slot is a device in ``devices`` (one may repeat: independent
slots on one card).  Each slot is one worker thread with its own
``torch.cuda.Stream`` on that device (no stream on the CPU): a launch
submits the chunk step to the slot's thread, which issues it under the
slot's stream and synchronizes that stream before its future completes, so
``_ready`` is ``future.done()`` and the host never reads a slot's outputs
early.  Results are delivered to the collectors exactly once per chunk
(first copy wins) on the driving thread, so counts, fingerprints and
patterns are bitwise the static drivers' regardless of slot count,
completion order, steals or duplicated flights.

Steal/re-issue/retire counts are in the return dict and, with tracing on,
the ``runtime.steals`` / ``runtime.reissues`` / ``runtime.retired`` /
``runtime.chunks`` counters; the drain loop runs under a ``runtime`` span.
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.distributed import make_chunk_step
from repro_torch.core.gsofa import SymbolicGraph
from repro_torch.core.symbolic import ChunkCheckpointer
from repro_torch.obs import metrics as _om
from repro_torch.obs import trace as _ot


@dataclasses.dataclass
class _InFlight:
    chunk_id: int
    srcs: np.ndarray             # unpadded sources of this chunk
    started: float
    future: concurrent.futures.Future   # -> (labels, mask, l, u, edges, iters)


@dataclasses.dataclass
class _Slot:
    device: torch.device
    pool: concurrent.futures.ThreadPoolExecutor
    stream: Optional[torch.cuda.Stream]


def default_devices(device=None) -> List[torch.device]:
    """One slot per visible CUDA device, or ``[cpu]`` when ``device`` is the
    CPU; raises without a card otherwise (never a quiet CPU run)."""
    from repro_torch.kernels.ops import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _graph_to(graph: SymbolicGraph, dev: torch.device) -> SymbolicGraph:
    def mv(t):
        return None if t is None else t.to(dev)

    return SymbolicGraph(n=graph.n, in_ell=mv(graph.in_ell),
                         out_ell=mv(graph.out_ell), out_deg=mv(graph.out_deg),
                         adj_dense=mv(graph.adj_dense))


class DynamicScheduler:
    """Work-stealing scheduler over executor slots.

    ``on_chunk(labels, srcs, offset)`` receives each chunk's converged
    (G, n) label tensor exactly once (``ColumnFingerprints.update`` shape);
    ``on_mask(mask, srcs)`` the matching bool fill masks
    (``PatternCollector.update`` shape).  ``devices`` (default: one slot
    per visible CUDA device, or the graph's device when it is the CPU) may
    repeat a device to model independent executor slots.
    """

    def __init__(self, graph: SymbolicGraph, *,
                 devices: Optional[Sequence] = None,
                 concurrency: int = 64, backend: str = "ell",
                 timeout_factor: float = 4.0,
                 checkpointer: Optional[ChunkCheckpointer] = None,
                 on_chunk: Optional[Callable] = None,
                 on_mask: Optional[Callable] = None):
        self.graph = graph
        self.devices = [torch.device(d) for d in (
            devices if devices is not None else default_devices(graph.device))]
        self.concurrency = concurrency
        self.backend = backend
        self.timeout_factor = timeout_factor
        self.ckpt = checkpointer
        self.on_chunk = on_chunk
        self.on_mask = on_mask
        self._step = make_chunk_step(graph.n, backend=backend)
        self._graphs: Dict[torch.device, SymbolicGraph] = {}
        self._chunk_times: List[float] = []
        self.steals = 0
        self.reissues = 0
        self.retired = 0

    def _graph_on(self, dev: torch.device) -> SymbolicGraph:
        if dev not in self._graphs:
            self._graphs[dev] = (self.graph if dev == self.graph.device
                                 else _graph_to(self.graph, dev))
        return self._graphs[dev]

    def _run_chunk(self, slot: _Slot, graph: SymbolicGraph,
                   padded: np.ndarray):
        """On the slot's thread: the chunk step under the slot's stream,
        which is synchronized before the outputs are handed back."""
        if slot.stream is None:
            return self._step(torch.as_tensor(padded, device=slot.device),
                              graph)
        with torch.cuda.stream(slot.stream):
            outs = self._step(torch.as_tensor(padded, device=slot.device),
                              graph)
        slot.stream.synchronize()
        return outs

    def _launch(self, slot: _Slot, chunk_id: int,
                srcs: np.ndarray) -> _InFlight:
        g = self._graph_on(slot.device)
        pad = self.concurrency - len(srcs)
        padded = (np.concatenate([srcs, np.full(pad, srcs[-1], np.int32)])
                  if pad else srcs)
        if slot.stream is not None:
            # the graph (and anything queued before) is made on the
            # driving thread's stream
            slot.stream.wait_stream(torch.cuda.current_stream(slot.device))
        return _InFlight(chunk_id=chunk_id, srcs=srcs,
                         started=time.perf_counter(),
                         future=slot.pool.submit(self._run_chunk, slot, g,
                                                 padded))

    @staticmethod
    def _ready(flight: _InFlight) -> bool:
        return flight.future.done()

    def run(self, *, drop_devices_after: Optional[int] = None,
            join_devices_after: Optional[int] = None) -> dict:
        """Process all chunks.

        ``drop_devices_after``: after N completed chunks, shrink to one
        slot; ``join_devices_after``: start on one slot and activate the
        rest after N completed chunks (elastic leave/join — the queue never
        cares how many slots are active).
        """
        slots = [_Slot(device=d,
                       pool=concurrent.futures.ThreadPoolExecutor(
                           max_workers=1),
                       stream=(torch.cuda.Stream(d) if d.type == "cuda"
                               else None))
                 for d in self.devices]
        try:
            if not _ot.ENABLED:
                return self._run(slots, drop_devices_after,
                                 join_devices_after)
            with _ot.span("runtime"):
                return self._run(slots, drop_devices_after,
                                 join_devices_after)
        finally:
            # superseded flights still running finish here; their results
            # are dropped
            for slot in slots:
                slot.pool.shutdown(wait=True)

    def _run(self, slots: List[_Slot], drop_devices_after: Optional[int],
             join_devices_after: Optional[int]) -> dict:
        n = self.graph.n
        n_dev = len(slots)
        chunk_starts = list(range(0, n, self.concurrency))
        queue: collections.deque[int] = collections.deque()
        l_counts = np.zeros(n, dtype=np.int64)
        u_counts = np.zeros(n, dtype=np.int64)
        edge_checks = np.zeros(n, dtype=np.int64)
        for ci, start in enumerate(chunk_starts):
            srcs = np.arange(start, min(start + self.concurrency, n))
            # coverage is per source, not per grid start: a checkpoint
            # recorded under a different concurrency still restarts correctly
            # (a partially-covered chunk recomputes, which is idempotent)
            if self.ckpt is not None and self.ckpt.covered[srcs].all():
                continue
            queue.append(ci)
        if self.ckpt is not None:
            self.ckpt.restore_into(l_counts, u_counts)

        inflight: Dict[int, _InFlight] = {}   # slot idx -> flight
        superseded: List[_InFlight] = []      # retired flights, read at the end
        done_chunks: set[int] = set()
        completed = 0
        supersteps = 0
        active_devices = (list(range(n_dev)) if join_devices_after is None
                          else [0])
        current = (torch.cuda.current_stream
                   if any(s.stream is not None for s in slots) else None)

        def srcs_of(ci: int) -> np.ndarray:
            s = chunk_starts[ci]
            return np.arange(s, min(s + self.concurrency, n), dtype=np.int32)

        def consume(fl: _InFlight) -> None:
            """Deliver one chunk's results exactly once (first copy wins)."""
            nonlocal completed, supersteps
            labels, mask, l, u, edges, iters = fl.future.result()
            if current is not None and labels.is_cuda:
                # made on a slot's stream, read (and freed) on this one
                for t in (labels, mask):
                    t.record_stream(current(t.device))
            k = len(fl.srcs)
            l_counts[fl.srcs] = l[:k].cpu().numpy()
            u_counts[fl.srcs] = u[:k].cpu().numpy()
            edge_checks[fl.srcs] = edges[:k].cpu().numpy()
            if self.on_chunk is not None:
                self.on_chunk(labels[:k], fl.srcs, 0)
            if self.on_mask is not None:
                self.on_mask(mask[:k], fl.srcs)
            supersteps += int(iters)
            done_chunks.add(fl.chunk_id)
            completed += 1
            self._chunk_times.append(time.perf_counter() - fl.started)
            if self.ckpt is not None:
                self.ckpt.record(chunk_starts[fl.chunk_id], fl.srcs,
                                 l_counts[fl.srcs], u_counts[fl.srcs])

        while queue or inflight:
            # fill idle slots; pulling a chunk whose round-robin home slot
            # differs is a steal (static assignment would have put chunk ci
            # on slot ci % n_dev)
            for d in list(active_devices):
                if d not in inflight and queue:
                    ci = queue.popleft()
                    if ci in done_chunks:
                        continue
                    if n_dev > 1 and ci % n_dev != d:
                        self.steals += 1
                    inflight[d] = self._launch(slots[d], ci, srcs_of(ci))
            if not inflight:
                break
            # poll
            progressed = False
            for d, fl in list(inflight.items()):
                if d not in inflight:          # retired this sweep
                    continue
                if self._ready(fl):
                    if fl.chunk_id not in done_chunks:
                        consume(fl)
                        # retire superseded duplicate flights: the race is
                        # decided, so losers must not keep occupying slots
                        for d2, fl2 in list(inflight.items()):
                            if d2 != d and fl2.chunk_id == fl.chunk_id:
                                superseded.append(inflight.pop(d2))
                                self.retired += 1
                        if (drop_devices_after is not None
                                and completed >= drop_devices_after
                                and len(active_devices) > 1):
                            active_devices = active_devices[:1]  # shrink
                        if (join_devices_after is not None
                                and completed >= join_devices_after
                                and len(active_devices) < n_dev):
                            active_devices = list(range(n_dev))   # join
                    del inflight[d]
                    progressed = True
                elif self._chunk_times:
                    # straggler: re-issue to an idle slot (speculative)
                    med = float(np.median(self._chunk_times))
                    racing = any(f.chunk_id == fl.chunk_id
                                 for x, f in inflight.items() if x != d)
                    if (time.perf_counter() - fl.started
                            > self.timeout_factor * med
                            and fl.chunk_id not in done_chunks
                            and not racing):
                        idle = [x for x in active_devices if x not in inflight]
                        if idle:
                            self.reissues += 1
                            inflight[idle[0]] = self._launch(
                                slots[idle[0]], fl.chunk_id, fl.srcs)
            if not progressed:
                time.sleep(0.001)
        for fl in superseded:
            # a losing copy's result is dropped, but its failure is not
            fl.future.result()

        if _ot.ENABLED:
            reg = _om.registry()
            reg.count("runtime.steals", self.steals)
            reg.count("runtime.reissues", self.reissues)
            reg.count("runtime.retired", self.retired)
            reg.count("runtime.chunks", completed)

        return {"l_counts": l_counts, "u_counts": u_counts,
                "edge_checks": edge_checks,
                "chunks": len(chunk_starts), "completed": completed,
                "supersteps": supersteps,
                "steals": self.steals, "reissues": self.reissues,
                "retired": self.retired, "chunk_times": self._chunk_times}
