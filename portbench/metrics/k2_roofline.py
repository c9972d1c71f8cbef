"""K2's share of its roofline over one profiled analysis: the least time of
its folds (``portbench.work.k2_fingerprint_work``, one a chunk over its
real sources) over K2's device time, summed over its launches."""
from portbench import devtrace, work


def read(obs):
    prof = obs.get("profile")
    if not prof or not obs.get("analyses"):
        return None
    first = obs["analyses"][0]
    n = first["input"].n
    sources = work.chunk_sources(n, first["sym"].concurrency)
    launches, seconds = devtrace.kernel_time(prof["events"],
                                             "column_fingerprints_kernel")
    if not launches or launches != len(sources):
        return None
    least = sum(work.least_seconds(*work.k2_fingerprint_work(s, n))
                for s in sources)
    return 100.0 * least / seconds
