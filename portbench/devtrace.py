"""Reading a ``torch.profiler`` trace of the card: its device events, the
time the device was busy (overlapping events merged), the operations that
took most time, and the idle gaps named by the program span the host was in.

Device busy and idle share follow ``chip_smoke.py::device_summary`` (every
kernel, copy and fill counts as busy), with overlapping events merged
instead of summed."""
from __future__ import annotations

from collections import Counter, defaultdict


def device_events(prof):
    """[(name, start_ns, end_ns)] of every device activity in a finished
    profile, in start order."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.profiler.kineto_results.events():
        if (ev.device_type() == DeviceType.CUDA
                and not ev.is_user_annotation()
                and not getattr(ev, "is_hidden_event", lambda: False)()):
            start = ev.start_ns()
            out.append((ev.name(), start, start + ev.duration_ns()))
    out.sort(key=lambda e: e[1])
    return out


def busy_intervals(events):
    """Merged [start_ns, end_ns) intervals in which some activity ran."""
    merged = []
    for _, s, e in events:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_seconds(events) -> float:
    return sum(e - s for s, e in busy_intervals(events)) / 1e9


def top_ops(events, k: int = 10, width: int = 120):
    """[[name, seconds]] of the ``k`` names with the most device time, each
    name cut to ``width`` characters."""
    ns = Counter()
    for name, s, e in events:
        ns[name] += e - s
    return [[name[:width], t / 1e9] for name, t in ns.most_common(k)]


def kernel_time(events, needle: str):
    """(launches, seconds) of the events whose name holds ``needle``."""
    hits = [e - s for name, s, e in events if needle in name]
    return len(hits), sum(hits) / 1e9


def _innermost(spans):
    """The host timeline as [start_ns, end_ns, label]: each piece labelled
    by the innermost span open over it (spans nest on one thread)."""
    points = sorted({p for _, s, e, _ in spans for p in (s, e)})
    pieces = []
    for s, e in zip(points, points[1:]):
        mid = (s + e) // 2
        inner = [sp for sp in spans if sp[1] <= mid < sp[2]]
        if inner:
            pieces.append([s, e, "host in " + max(inner,
                                                  key=lambda sp: sp[3])[0]])
    return pieces


def idle_gaps(events, lo_ns: int, hi_ns: int, spans, k: int = 10):
    """Idle time of the device within [lo_ns, hi_ns), split by the innermost
    host span open over each part of each gap: [[label, seconds]] of the
    ``k`` largest.  ``spans`` are (name, start_ns, end_ns, depth) on the
    device events' clock."""
    gaps, edge = [], lo_ns
    for s, e in busy_intervals(events) + [[hi_ns, hi_ns]]:
        s, e = max(s, lo_ns), min(e, hi_ns)
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    by = defaultdict(int)
    pieces = _innermost(spans)
    i = 0
    for gs, ge in gaps:
        covered = 0
        while i < len(pieces) and pieces[i][1] <= gs:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < ge:
            part = min(ge, pieces[j][1]) - max(gs, pieces[j][0])
            by[pieces[j][2]] += part
            covered += part
            j += 1
        by["host outside the program's spans"] += (ge - gs) - covered
    top = sorted(((lab, ns) for lab, ns in by.items() if ns > 0),
                 key=lambda kv: -kv[1])[:k]
    return [[label, ns / 1e9] for label, ns in top]
