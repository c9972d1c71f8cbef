"""The port's tracing on the analysis path: a traced ``analyze`` names its
host phases and the fixpoint's per-superstep wait on the device; an
untraced one records nothing."""
import math

import pytest
import torch

import repro_torch
from repro_torch.obs import metrics as om
from repro_torch.obs import trace as ot
from repro_torch.sparse import matrices as M

# tiny shapes, several pytest workers: one intra-op thread each
torch.set_num_threads(1)

OPTS = dict(concurrency=32, supernode_relax=0)


def _analyze(**opts):
    return repro_torch.analyze(M.grid3d_laplacian(5),
                               repro_torch.LUOptions(**OPTS, **opts),
                               device="cpu")


@pytest.mark.parametrize("backend", ["ell", "kernel"])
def test_traced_analyze_names_its_phases(backend):
    plan = _analyze(backend=backend, trace=True)
    analyze = plan.stats.find("analyze")
    names = {c.name for c in analyze.children}
    assert {"prepare_graph", "pattern_to_csc", "fixpoint"} <= names
    prepare = analyze.find("prepare_graph")
    has_adjacency = prepare.find("dense_adjacency") is not None
    assert has_adjacency == (backend == "kernel")
    wait = analyze.find("fixpoint_wait")
    # one read a superstep, and one more a chunk to see the fixpoint
    assert wait.count == plan.sym.supersteps + math.ceil(
        plan.a.n / plan.sym.concurrency)
    assert wait.total_s <= analyze.find("fixpoint").total_s


def test_untraced_analyze_records_nothing():
    om.registry().reset()
    plan = _analyze()
    assert plan.stats is None
    assert ot.tracer() is None and not ot.ENABLED
    assert om.registry().snapshot() == {"counters": {}, "gauges": {},
                                        "histograms": {}}


def test_traced_analyze_records_no_fingerprint_counters():
    om.registry().reset()
    plan = _analyze(trace=True)
    assert plan.stats.find("fingerprint_update") is not None
    snap = om.registry().snapshot()
    assert snap["counters"].get("fixpoint.chunks") == math.ceil(
        plan.a.n / plan.sym.concurrency)
    recorded = [k for kind in snap.values() for k in kind]
    assert not [k for k in recorded if k.startswith("fingerprint.")]


@pytest.mark.parametrize("backend", ["ell", "kernel"])
def test_traced_analyze_counts_fused_supersteps(backend):
    """``fixpoint.fused_supersteps`` counts every superstep the ELL
    fixpoint ran through K8 (each chunk's verifying one too), and nothing
    on the kernel backend, whose loop is unfused."""
    om.registry().reset()
    plan = _analyze(backend=backend, trace=True)
    fused = om.registry().snapshot()["counters"].get(
        "fixpoint.fused_supersteps")
    chunks = math.ceil(plan.a.n / plan.sym.concurrency)
    assert fused == (plan.sym.supersteps + chunks if backend == "ell"
                     else None)
