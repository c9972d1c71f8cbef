"""Seconds of graph preparation per analysis: the program's
``prepare_graph`` span (the transpose, the ELL tables and their copies to
the card, and on the kernel path the dense adjacency, its ``dense_adjacency``
child), averaged over the traced window."""
from portbench import spans


def read(obs):
    return spans.mean(obs, lambda stats: spans.seconds(stats,
                                                       "prepare_graph"))
