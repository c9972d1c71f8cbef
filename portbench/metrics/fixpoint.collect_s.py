"""Seconds of pattern collection per analysis: the program's
``pattern_collect`` spans (each chunk's fill mask copied to the host and
reduced to rows) and its ``pattern_to_csc`` span (the row lists sorted into
columns), averaged over the traced window; nothing for a program without
the second span."""
from portbench import spans


def collect_seconds(stats):
    parts = [spans.seconds(stats, name)
             for name in ("pattern_collect", "pattern_to_csc")]
    return None if None in parts else sum(parts)


def read(obs):
    return spans.mean(obs, collect_seconds)
