"""Nested span tracing for the LU pipeline (DESIGN.md §12).

Zero-overhead-when-disabled is the design contract: every instrumentation
site in the pipeline calls ``span("name")``, and when tracing is off that
call is a module-level boolean check returning a cached no-op context
manager — no ``Span`` allocation, no ``perf_counter`` read, no lock.  The
tier-1 bitwise gates and the committed bench ratio gates therefore see the
instrumented code paths unchanged.

When enabled (``tracing(path=...)``, ``enable()``, or
``LUOptions(trace=True)``) the active ``Tracer`` records one *complete*
event per span — name, start, duration, track, nesting depth — with a
per-thread span stack (``threading.local``) so the chunk driver's worker
threads and the per-device segment sweeps each get coherent nesting, and a
single lock protecting only the append to the shared event list.

Exports:

* Chrome trace-event JSON (``Tracer.export_chrome`` / ``write_chrome``):
  ``ph="X"`` complete events with microsecond ``ts``/``dur``, one ``pid``
  per track (``track="device 3"`` spans land on their own Perfetto track,
  named via ``"M"`` metadata events).
* A picklable summary tree (``Tracer.summary`` -> ``SpanSummary``):
  spans aggregated by (depth, name) path with call counts and total
  seconds, rendered as an indented text tree — this is what
  ``LUPlan.stats`` / ``LUFactorization.stats`` carry.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

ENABLED = False                 # module-level hot-path gate — read, not called
_TRACER: Optional["Tracer"] = None
_LOCK = threading.Lock()

_MAIN_TRACK = "main"


@dataclasses.dataclass
class SpanEvent:
    """One closed span, times in seconds relative to the tracer epoch."""

    name: str
    start: float
    dur: float
    track: str
    depth: int
    tid: int


class _NullSpan:
    """Cached do-nothing context manager returned while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """A live span: records its event on exit."""

    __slots__ = ("tracer", "name", "track", "start", "depth")

    def __init__(self, tracer: "Tracer", name: str, track: Optional[str]):
        self.tracer = tracer
        self.name = name
        self.track = track

    def __enter__(self):
        tl = self.tracer._tl()
        if self.track is None:
            self.track = tl.track
        self.depth = len(tl.stack)
        tl.stack.append(self.name)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        tl = self.tracer._tl()
        tl.stack.pop()
        self.tracer._record(SpanEvent(
            name=self.name, start=self.start - self.tracer.epoch,
            dur=end - self.start, track=self.track, depth=self.depth,
            tid=threading.get_ident()))
        return False


class Tracer:
    """Collects spans; thread-safe; one instance active at a time."""

    def __init__(self):
        self.epoch = time.perf_counter()
        self.events: List[SpanEvent] = []
        self._lock = threading.Lock()
        self._local = threading.local()

    def _tl(self):
        tl = self._local
        if not hasattr(tl, "stack"):
            tl.stack = []
            tl.track = _MAIN_TRACK
        return tl

    def _record(self, ev: SpanEvent) -> None:
        with self._lock:
            self.events.append(ev)

    @contextlib.contextmanager
    def track(self, name: str):
        """Route this thread's spans to a named track (e.g. "device 2")."""
        tl = self._tl()
        prev = tl.track
        tl.track = name
        try:
            yield
        finally:
            tl.track = prev

    # ---- exports ---------------------------------------------------------

    def export_chrome(self) -> dict:
        """Chrome trace-event JSON object (Perfetto-loadable)."""
        with self._lock:
            events = list(self.events)
        tracks = sorted({ev.track for ev in events},
                        key=lambda t: (t != _MAIN_TRACK, t))
        pid_of = {t: i for i, t in enumerate(tracks)}
        out = []
        for t, pid in pid_of.items():
            out.append({"ph": "M", "name": "process_name", "pid": pid,
                        "tid": 0, "args": {"name": t}})
        for ev in events:
            out.append({
                "ph": "X",
                "name": ev.name,
                "ts": round(ev.start * 1e6, 3),
                "dur": round(ev.dur * 1e6, 3),
                "pid": pid_of[ev.track],
                "tid": ev.tid % 100000,
                "args": {"depth": ev.depth},
            })
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def write_chrome(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.export_chrome(), f)

    def mark(self) -> int:
        """Current event count — pass to ``summary`` to aggregate only
        spans recorded after this point."""
        with self._lock:
            return len(self.events)

    def summary(self, start: int = 0) -> "SpanSummary":
        """Aggregate events[start:] into a picklable ``SpanSummary`` tree.

        Spans nest by (track, tid, time containment); aggregation is by
        name path, so e.g. all ``factor_level`` spans under ``factorize``
        fold into one node with a call count.
        """
        with self._lock:
            events = list(self.events[start:])
        root = SpanSummary(name="total", count=1, total_s=0.0, children=[])
        # Rebuild ancestry per (track, tid) from start/end ordering: a span
        # is a child of the innermost open span that contains it.
        by_thread: Dict[Tuple[str, int], List[SpanEvent]] = {}
        for ev in events:
            by_thread.setdefault((ev.track, ev.tid), []).append(ev)
        for evs in by_thread.values():
            # sort by start; containment via an explicit stack of (end, node)
            evs.sort(key=lambda e: (e.start, -e.dur))
            stack: List[Tuple[float, SpanSummary]] = []
            for ev in evs:
                while stack and ev.start >= stack[-1][0] - 1e-12:
                    stack.pop()
                parent = stack[-1][1] if stack else root
                node = parent.child(ev.name)
                node.count += 1
                node.total_s += ev.dur
                stack.append((ev.start + ev.dur, node))
        root.total_s = sum(c.total_s for c in root.children)
        return root


@dataclasses.dataclass
class SpanSummary:
    """Aggregated span tree node — picklable, carried on plan/factor
    ``.stats`` so a traced analysis can be saved and inspected later."""

    name: str
    count: int
    total_s: float
    children: List["SpanSummary"] = dataclasses.field(default_factory=list)

    def child(self, name: str) -> "SpanSummary":
        for c in self.children:
            if c.name == name:
                return c
        c = SpanSummary(name=name, count=0, total_s=0.0, children=[])
        self.children.append(c)
        return c

    def find(self, name: str) -> Optional["SpanSummary"]:
        """Depth-first lookup by span name."""
        for c in self.children:
            if c.name == name:
                return c
            hit = c.find(name)
            if hit is not None:
                return hit
        return None

    def render(self, indent: int = 0) -> str:
        """Indented text tree: name, total seconds, call count."""
        lines = []
        pad = "  " * indent
        lines.append(f"{pad}{self.name:<28s} {self.total_s * 1e3:10.2f} ms"
                     f"  x{self.count}")
        for c in sorted(self.children, key=lambda c: -c.total_s):
            lines.append(c.render(indent + 1))
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.render()


# ---- module-level API (what the pipeline calls) --------------------------

def span(name: str, *, track: Optional[str] = None):
    """Open a nested span.  THE hot-path entry point: when tracing is off
    this is one global-bool check plus returning a cached null object."""
    if not ENABLED:
        return _NULL_SPAN
    return _Span(_TRACER, name, track)


def traced(name: Optional[str] = None) -> Callable:
    """Decorator form of ``span`` (span name defaults to the function's)."""
    def deco(fn):
        sname = name or fn.__name__

        def wrapper(*args, **kwargs):
            if not ENABLED:
                return fn(*args, **kwargs)
            with _Span(_TRACER, sname, None):
                return fn(*args, **kwargs)
        wrapper.__name__ = fn.__name__
        wrapper.__doc__ = fn.__doc__
        wrapper.__wrapped__ = fn
        return wrapper
    return deco


def device_track(device: Optional[int]):
    """Context routing this thread's spans to a per-device track; a no-op
    null context when tracing is off or ``device`` is None."""
    if not ENABLED or device is None:
        return _NULL_SPAN
    return _TRACER.track(f"device {int(device)}")


def tracer() -> Optional[Tracer]:
    """The active tracer, or None when disabled."""
    return _TRACER


def enable() -> Tracer:
    """Switch tracing on (idempotent); returns the active tracer."""
    global ENABLED, _TRACER
    with _LOCK:
        if _TRACER is None:
            _TRACER = Tracer()
        ENABLED = True
        return _TRACER


def disable() -> Optional[Tracer]:
    """Switch tracing off; returns the tracer that was active (so callers
    can still export), clearing the global slot."""
    global ENABLED, _TRACER
    with _LOCK:
        tr, _TRACER = _TRACER, None
        ENABLED = False
        return tr


@contextlib.contextmanager
def tracing(path=None):
    """``with repro.obs.tracing("trace.json"):`` — enable for the block,
    write Chrome trace JSON to ``path`` on exit, restore the prior state."""
    global ENABLED, _TRACER
    prev_enabled, prev_tracer = ENABLED, _TRACER
    tr = enable()
    try:
        yield tr
    finally:
        with _LOCK:
            ENABLED, _TRACER = prev_enabled, prev_tracer
        if path is not None:
            tr.write_chrome(path)


@contextlib.contextmanager
def ensure(flag: bool):
    """Enable tracing for the block iff ``flag`` and it is not already on —
    the ``LUOptions(trace=True)`` plumbing.  Yields the active tracer (or
    None).  Never disables a tracer someone outside the block owns."""
    global ENABLED, _TRACER
    if not flag:
        yield _TRACER if ENABLED else None
        return
    if ENABLED:
        yield _TRACER
        return
    tr = enable()
    try:
        yield tr
    finally:
        with _LOCK:
            # only tear down if still the tracer we installed
            if _TRACER is tr:
                ENABLED = False
                _TRACER = None
