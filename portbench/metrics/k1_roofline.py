"""K1's share of its roofline over one profiled analysis: the least time of
the relaxations it ran (``portbench.work.k1_relax_work``: what the
relaxation needs, whatever implements it) over K1's device time, summed
over its launches.  A chunk of the fixpoint launches K1 once a superstep
and once more to verify the fixpoint; the program's ``fixpoint.iterations``
histogram gives each chunk's supersteps."""
from portbench import devtrace, work


def read(obs):
    prof = obs.get("profile")
    if not prof or not obs.get("analyses"):
        return None
    iters = prof["counters"]["histograms"].get("fixpoint.iterations")
    if iters is None:
        return None
    first = obs["analyses"][0]
    n, edges = first["input"].n, work.offdiag_edges(first["input"])
    sources = work.chunk_sources(n, first["sym"].concurrency)
    launches, seconds = devtrace.kernel_time(prof["events"],
                                             "minmax_relax_kernel")
    if not launches or len(iters) != len(sources) or launches != sum(
            int(i) + 1 for i in iters):
        return None
    least = sum((int(i) + 1) * work.least_seconds(
        *work.k1_relax_work(s, n, edges)) for s, i in zip(sources, iters))
    return 100.0 * least / seconds
