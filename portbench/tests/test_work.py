"""The roofline counts and the trace arithmetic, against hand counts."""
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import devtrace, layout, work
from portbench.csr import csr_from_coo, with_diagonal


def test_k1_counts_by_hand():
    # 512 sources over n = 1,000 vertices with 3,000 off-diagonal edges:
    # prop read 512 * 1000 * 4 B, edges 3000 * 4 B, row pointers 1001 * 4 B,
    # candidates written 512 * 1000 * 4 B; one min per (source, edge)
    nbytes, ops = work.k1_relax_work(512, 1000, 3000)
    assert nbytes == 2_048_000 + 12_000 + 4_004 + 2_048_000 == 4_112_004
    assert ops == 1_536_000


def test_k1_counts_ignore_the_dense_adjacency():
    # doubling the padding of a dense (n_pad, n_pad) layout changes nothing
    assert work.k1_relax_work(1, 60_000, 400_000) == (
        4 * 60_000 + 4 * 400_000 + 4 * 60_001 + 4 * 60_000, 400_000)


def test_k2_counts_by_hand():
    nbytes, ops = work.k2_fingerprint_work(512, 1000)
    assert nbytes == 512 * 1000 * 4 + 4 * 4 * 512 + 3 * 1000 * 4 == 2_068_192
    assert ops == 1_024_000


def test_least_seconds_takes_the_longer_bound():
    assert work.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert work.least_seconds(0, 67e12) == pytest.approx(1.0)
    assert work.least_seconds(3.35e9, 67e12) == pytest.approx(1.0)


def test_offdiag_edges():
    a = SimpleNamespace(n=3, indptr=np.array([0, 2, 3, 5]),
                        indices=np.array([0, 2, 1, 0, 2]))
    assert work.offdiag_edges(a) == 2


def test_chunk_sources():
    assert work.chunk_sources(1100, 512) == [512, 512, 76]
    assert work.chunk_sources(1024, 512) == [512, 512]


class _Stats:
    """A stand-in of the program's span tree: ``find(name).total_s``."""

    def __init__(self, totals):
        self.totals = totals

    def find(self, name):
        if name not in self.totals:
            return None
        return SimpleNamespace(total_s=self.totals[name])


def _obs(events, iters, n=1100, edges=5000):
    # n rows with the diagonal and `edges` distinct entries off it
    k = np.arange(edges)
    rows, cols = with_diagonal(n, k % n, (k % n + 1 + k // n) % n)
    indptr, indices = csr_from_coo(n, rows, cols)
    a = SimpleNamespace(n=n, indptr=indptr, indices=indices)
    sym = [SimpleNamespace(supersteps=s, concurrency=512) for s in (10, 12)]
    stats = [_Stats({"build_schedule": 0.2, "gather_maps": 0.3}),
             _Stats({"build_schedule": 0.3, "gather_maps": 0.3,
                     "solve_schedule": 0.1})]
    return {"analyses": [{"input": a, "sym": y, "stats": t}
                         for y, t in zip(sym, stats)],
            "profile": {"events": events, "spans": [], "wall_s": 1.0,
                        "busy_s": devtrace.busy_seconds(events),
                        "peak_bytes": 2**30,
                        "counters": {"counters": {}, "gauges": {},
                                     "histograms": {
                                         "fixpoint.iterations": iters}}}}


def test_k1_and_k2_readers():
    k1 = "void (anonymous namespace)::minmax_relax_kernel<true>(int const*)"
    k2 = "column_fingerprints_kernel(int const*)"
    # chunks of 512, 512, 76 sources with 2, 3, 1 supersteps: 3 + 4 + 2
    # launches of K1, each 1 ms; one K2 fold a chunk, each 0.1 ms
    events = [(k1, i * 10**6, (i + 1) * 10**6) for i in range(9)]
    events += [(k2, 10**7 + i * 10**5, 10**7 + (i + 1) * 10**5)
               for i in range(3)]
    obs = _obs(events, [2, 3, 1])
    least = sum(m * work.least_seconds(*work.k1_relax_work(s, 1100, 5000))
                for s, m in ((512, 3), (512, 4), (76, 2)))
    read = layout.module("metrics", "k1_roofline").read
    assert read(obs) == pytest.approx(100 * least / 9e-3)
    assert read(_obs(events, [2, 3, 2])) is None     # launches disagree
    assert read(_obs(events, None)) is None
    least2 = sum(work.least_seconds(*work.k2_fingerprint_work(s, 1100))
                 for s in (512, 512, 76))
    assert layout.module("metrics", "k2_roofline").read(obs) == (
        pytest.approx(100 * least2 / 3e-4))
    assert layout.module("metrics", "device.idle_share").read(obs) == (
        pytest.approx(1 - 9.3e-3))
    assert layout.module("metrics", "api.device_calls").read(obs) == 12
    assert layout.module("metrics", "device.peak_gib").read(obs) == 1.0
    assert layout.module("metrics", "fixpoint.supersteps").read(obs) == 11
    assert layout.module("metrics", "plan.build_s").read(obs) == (
        pytest.approx(0.6))


def test_readers_find_nothing_without_a_trace():
    for name in ("k1_roofline", "k2_roofline", "device.idle_share",
                 "api.device_calls", "device.peak_gib",
                 "fixpoint.supersteps", "plan.build_s"):
        assert layout.module("metrics", name).read({}) is None, name


def test_busy_merges_overlaps_and_gaps_are_named():
    events = [("a", 0, 10), ("b", 5, 20), ("c", 40, 50), ("d", 90, 100)]
    assert devtrace.busy_intervals(events) == [[0, 20], [40, 50], [90, 100]]
    assert devtrace.busy_seconds(events) == pytest.approx(40e-9)
    spans = [("analyze", 0, 100, 0), ("pattern_collect", 20, 40, 1)]
    gaps = devtrace.idle_gaps(events, 0, 110, spans)
    # 20-40 inside pattern_collect, 50-90 in analyze, 100-110 outside
    assert gaps == [["host in analyze", 40e-9],
                    ["host in pattern_collect", 20e-9],
                    ["host outside the program's spans", 10e-9]]
    assert devtrace.top_ops(events, 1) == [["b", 15e-9]]
    assert devtrace.kernel_time(events, "c") == (1, 10e-9)


def test_a_gap_is_split_across_the_spans_it_crosses():
    events = [("a", 0, 10), ("b", 100, 110)]
    spans = [("analyze", 0, 120, 0), ("build_schedule", 20, 50, 1),
             ("gather_maps", 50, 90, 1)]
    assert devtrace.idle_gaps(events, 0, 110, spans) == [
        ["host in gather_maps", 40e-9], ["host in build_schedule", 30e-9],
        ["host in analyze", 20e-9]]
