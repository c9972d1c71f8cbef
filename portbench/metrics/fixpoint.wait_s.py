"""Seconds the host waits on the card inside the fixpoint per analysis: the
program's ``fixpoint_wait`` spans, one a superstep around its only read of
the card (whether a frontier is left), averaged over the traced window.
The rest of the fixpoint's time the host spends launching and collecting."""
from portbench import spans


def read(obs):
    return spans.mean(obs, lambda stats: spans.seconds(stats,
                                                       "fixpoint_wait"))
