"""The program's span trees (``plan.stats``, a ``SpanSummary`` per traced
analysis) as the per-layer metrics that read spans need them: the seconds
recorded under a span name, and a mean over the traced window."""
from __future__ import annotations


def seconds(tree, name: str):
    """Seconds of every node called ``name`` in ``tree`` (a node under
    another of the same name counted once, in its ancestor); None when no
    node has the name."""
    hits = []
    stack = list(tree.children)
    while stack:
        node = stack.pop()
        if node.name == name:
            hits.append(node.total_s)
        else:
            stack.extend(node.children)
    return sum(hits) if hits else None


def mean(obs, reading):
    """Mean of ``reading(stats)`` over the traced analyses whose reading is
    not None; None when none has one (a program without the spans)."""
    values = [reading(a["stats"]) for a in obs.get("analyses", [])]
    values = [v for v in values if v is not None]
    return sum(values) / len(values) if values else None
