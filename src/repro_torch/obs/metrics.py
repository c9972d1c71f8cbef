"""Counters / gauges / histograms registry (DESIGN.md §12).

The registry is deliberately simple: a process-global named-metric store the
pipeline writes *only when tracing is enabled* (call sites gate on
``trace.ENABLED`` so the disabled path stays a boolean check).  Recorded
quantities (span taxonomy table in DESIGN.md §12):

==============================  ========  =====================================
metric                          kind      meaning
==============================  ========  =====================================
fixpoint.iterations             hist      converged supersteps per chunk
fixpoint.chunks                 counter   chunks processed
fixpoint.fused_supersteps       counter   ELL supersteps run through K8
fill.lu_nnz                     gauge     structural nnz(L+U) incl. diagonal
fill.input_nnz                  gauge     nnz(A)
supernodes.count                gauge     number of detected panels
supernodes.size                 hist      panel widths (columns per supernode)
placement.imbalance_modeled     hist      per-level max/mean modeled bin weight
factor.level_imbalance_measured hist      per-level max/mean measured segment s
gemm.flops                      counter   flops of the accumulated panel GEMMs
gemm.bytes                      counter   analytic bytes gathered + scattered
gemm.seconds                    counter   wall seconds of the panel sweep
robust.perturbed_pivots         counter   tiny pivots bumped by the sweep
robust.growth                   gauge     element growth max|L\\U|/max|A_f|
robust.cond_estimate            gauge     Hager cond_1 estimate (-1 = inf)
blocking.merges                 counter   supernode pairs coalesced by blocking
blocking.panels_before          gauge     panels entering the merge pass
blocking.panels_after           gauge     panels after structure-aware merging
blocking.pad_entries            gauge     explicit zeros the merged blocks carry
blocking.modeled_gain_s         gauge     modeled sweep seconds saved by merging
tune.candidates                 counter   partitions scored by the autotune sweep
tune.modeled_s                  gauge     modeled sweep seconds of the chosen
tune.baseline_s                 gauge     modeled seconds of the untuned knobs
==============================  ========  =====================================
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, List


@dataclasses.dataclass
class Histogram:
    """Streaming histogram: exact count/sum/min/max + small-sample values.

    Keeps up to ``keep`` raw observations (enough for the pipeline's
    per-chunk / per-level cardinalities) so percentiles stay exact for the
    sizes we record; beyond that only the moments update.
    """

    keep: int = 4096
    count: int = 0
    total: float = 0.0
    min: float = math.inf
    max: float = -math.inf
    values: List[float] = dataclasses.field(default_factory=list)

    def record(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if len(self.values) < self.keep:
            self.values.append(v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Exact percentile over the kept sample (q in [0, 100])."""
        if not self.values:
            return 0.0
        vs = sorted(self.values)
        idx = min(len(vs) - 1, max(0, int(round(q / 100 * (len(vs) - 1)))))
        return vs[idx]

    def to_dict(self) -> dict:
        return {
            "count": self.count,
            "mean": self.mean,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
        }


class MetricsRegistry:
    """Named counters/gauges/histograms; thread-safe; cheap to snapshot."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, Histogram] = {}

    def count(self, name: str, value: float = 1) -> None:
        if hasattr(value, "item"):       # numpy scalars -> JSON-safe python
            value = value.item()
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            h = self.histograms.get(name)
            if h is None:
                h = self.histograms[name] = Histogram()
            h.record(value)

    def get(self, name: str):
        """Counter or gauge value, or the Histogram object, or None."""
        with self._lock:
            if name in self.counters:
                return self.counters[name]
            if name in self.gauges:
                return self.gauges[name]
            return self.histograms.get(name)

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.histograms.clear()

    def snapshot(self) -> dict:
        """JSON-ready dump: {counters, gauges, histograms}."""
        with self._lock:
            return {
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "histograms": {k: h.to_dict()
                               for k, h in self.histograms.items()},
            }


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-global registry the pipeline writes into."""
    return _REGISTRY


# ---- progress reporting (satellite: on_progress / ETA) -------------------

class ProgressMeter:
    """Rolling-rate progress/ETA helper behind the ``on_progress`` callback
    plumbing: call ``update(done, total)`` per unit of work; the wrapped
    callback receives ``(done, total, eta_s)`` with ``eta_s`` from the
    rolling completion rate (None until a rate exists)."""

    def __init__(self, callback, *, window: int = 8):
        import time as _time

        self._cb = callback
        self._clock = _time.perf_counter
        self._window = window
        self._ticks: List[tuple] = []          # (time, done)

    def update(self, done: int, total: int) -> None:
        now = self._clock()
        self._ticks.append((now, done))
        if len(self._ticks) > self._window:
            self._ticks.pop(0)
        eta = None
        if len(self._ticks) >= 2:
            t0, d0 = self._ticks[0]
            dt, dd = now - t0, done - d0
            if dd > 0 and dt > 0:
                eta = (total - done) * dt / dd
        self._cb(done, total, eta)
