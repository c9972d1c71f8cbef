"""Seconds of the ``analyze`` span's self time per analysis: its total less
its children's, the host time inside the analysis that no span names,
averaged over the traced window."""
from portbench import spans


def self_seconds(stats):
    node = stats.find("analyze")
    if node is None:
        return None
    return node.total_s - sum(c.total_s for c in node.children)


def read(obs):
    return spans.mean(obs, self_seconds)
