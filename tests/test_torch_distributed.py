"""repro_torch's sharded analyze over torch.distributed against repro.

Gloo worlds of 2 and 4 CPU ranks (``_torch_world.run_world``, one
module-scoped fixture) analyze, factor and solve the repo's generators with
``analyze(mesh=make_flat_mesh(device="cpu"))``.  Every rank's counts,
supernodes, CSC pattern and fingerprints are held bitwise against the
port's single-device plan and the reference's mesh-less plan; its factors
and solves bitwise against the port's single-device ones (and within the
reference tests' 1e-10 of the reference's float64 host factors, whose BLAS
sums in another order).  The numbers that need a mesh in the reference —
``distributed_multisource``'s ``dist``, ``distributed_symbolic``'s balance
and ``make_ring_allreduce`` — come from one JAX subprocess with 4 forced
host devices, as ``tests/test_distributed_plan.py`` runs it.

The rank functions live at module level and this module imports no JAX at
import time, so the spawned ranks import it cheaply."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import distributed as tdist
from repro_torch.core.gsofa import gsofa_batch, prepare_graph
from repro_torch.launch.mesh import FLAT_AXIS, make_flat_mesh
from repro_torch.runtime import collectives as tcoll
from repro_torch.sparse import matrices as TM
from repro_torch.sparse.numeric import generic_values_csr
from repro_torch.supernodes.fingerprint import ColumnFingerprints

from _torch_world import run_world

torch.set_num_threads(1)

WORLDS = (2, 4)
CONCURRENCY = 48
# name -> (generator, args, kwargs), the same in repro.sparse and
# repro_torch.sparse (bitwise copies)
GENS = {
    "grid2d": ("grid2d_laplacian", [10], {}),
    "circuit": ("circuit_like", [200], {"seed": 7}),
    "bbd": ("bordered_block_diagonal", [320],
            {"block": 16, "border": 32, "seed": 6}),
    "economic": ("economic_like", [192], {"block": 16, "seed": 2}),
    "banded": ("banded_random", [160], {"band": 6, "seed": 4}),
    "random": ("random_pattern", [120], {"density": 0.02, "seed": 5}),
}
RING_OPS = ("add", "xor", "max", "compress")
RING_K = 37                     # not a multiple of the rank count: padding
FP_FIELDS = ("counts", "hsum", "hxor", "subdiag", "seen")


def _port_matrix(name):
    fn, args, kw = GENS[name]
    return getattr(TM, fn)(*args, **kw)


def _ring_payload(op, count):
    rng = np.random.default_rng(5)
    if op == "compress":
        return rng.standard_normal((count, RING_K)).astype(np.float32)
    return rng.integers(0, 2 ** 31 - 1, size=(count, RING_K)).astype(np.int32)


def _rhs(n):
    return np.random.default_rng(1).standard_normal((n, 2))


def _opts(**kw):
    return repro_torch.LUOptions(concurrency=CONCURRENCY, supernode_relax=2,
                                 **kw)


def _plan_record(plan, values):
    factor = plan.factorize(values)
    fp = plan.sym.fingerprints
    return {
        "l": plan.sym.l_counts, "u": plan.sym.u_counts,
        "supernodes": plan.sym.supernodes,
        "indptr": plan.pattern.indptr, "rowind": plan.pattern.rowind,
        "fp": {f: getattr(fp, f) for f in FP_FIELDS},
        "flat": factor.store.flat.numpy().copy(),
        "x": factor.solve(_rhs(plan.n)).x.numpy(),
        "supersteps": plan.sym.supersteps, "reinits": plan.sym.reinits,
        "dist": getattr(plan.sym, "dist", None),
        "n_devices": plan.n_devices,
    }


def _world_rank(rank, world):
    """One rank of a gloo world: every generator through the sharded
    analyze, the collectives, and the driver's knobs."""
    torch.set_num_threads(1)
    mesh = make_flat_mesh(device="cpu")
    out = {"plans": {}, "ring": {}}
    for name in GENS:
        a = _port_matrix(name)
        plan = repro_torch.analyze(a, _opts(), mesh=mesh)
        out["plans"][name] = _plan_record(plan, generic_values_csr(a))
    a = _port_matrix("bbd")
    values = generic_values_csr(a)
    # distribute=True builds the same mesh itself
    out["distribute"] = _plan_record(repro_torch.analyze(
        a, _opts(distribute=True), device="cpu"), values)
    out["kernel"] = _plan_record(repro_torch.analyze(
        a, _opts(backend="kernel", numeric_backend="kernel"), mesh=mesh),
        values)
    graph = prepare_graph(a, device="cpu")
    out["symbolic"] = {
        policy: tdist.distributed_symbolic(graph, mesh, policy=policy)
        for policy in ("interleave", "contiguous")}
    for op in RING_OPS:
        x = torch.from_numpy(_ring_payload(op, world)[rank])
        got = tcoll.ring_allreduce(x, mesh, op="add" if op == "compress"
                                   else op, compress=op == "compress")
        out["ring"][op] = got.numpy()
    # this rank's own sources' fingerprints, merged through the rings
    srcs = tdist.assign_sources(a.n, world)[rank]
    srcs = srcs[tdist.ownership_mask(tdist.assign_sources(a.n, world))[rank]]
    res = gsofa_batch(graph, srcs)
    shard = ColumnFingerprints(n=a.n)
    shard.update(res.labels, srcs)
    merged = tcoll.merge_fingerprint_shards(mesh, FLAT_AXIS, shard)
    out["shard"] = {f: getattr(shard, f) for f in FP_FIELDS}
    out["merged"] = {f: getattr(merged, f) for f in FP_FIELDS}
    clash = ColumnFingerprints(n=a.n)
    clash.update(res.labels[:1], srcs[:1])
    clash.seen[0] = True                      # row 0 seen on every rank
    try:
        tcoll.merge_fingerprint_shards(mesh, FLAT_AXIS, clash)
        out["overlap_error"] = None
    except ValueError as e:
        out["overlap_error"] = str(e)
    return out


_REFERENCE_SCRIPT = r"""
import json, sys
import numpy as np
import repro
from repro.core.distributed import distributed_multisource, distributed_symbolic
from repro.core.gsofa import prepare_graph
from repro.launch.mesh import make_flat_mesh
from repro.runtime.collectives import make_ring_allreduce
from repro.sparse import matrices as M
from repro.sparse.numeric import generic_values_csr
import jax.numpy as jnp

part, gens = sys.argv[1], json.loads(sys.argv[2])
c, ring_k = int(sys.argv[3]), int(sys.argv[4])
out = {"plans": {}, "multisource": {}, "symbolic": {}, "ring": {}}
for name, (fn, args, kw) in (gens.items() if part == "plans" else ()):
    a = getattr(M, fn)(*args, **kw)
    plan = repro.analyze(a, repro.LUOptions(concurrency=c, supernode_relax=2))
    x = plan.factorize(generic_values_csr(a)).solve(
        np.random.default_rng(1).standard_normal((a.n, 2))).x
    fp = plan.sym.fingerprints
    out["plans"][name] = {
        "l": plan.sym.l_counts.tolist(), "u": plan.sym.u_counts.tolist(),
        "supernodes": plan.sym.supernodes.tolist(),
        "indptr": plan.pattern.indptr.tolist(),
        "rowind": plan.pattern.rowind.tolist(),
        "fp": {"counts": fp.counts.tolist(), "hsum": fp.hsum.tolist(),
               "hxor": fp.hxor.tolist(), "subdiag": fp.subdiag.tolist(),
               "seen": fp.seen.tolist()},
        "x": x.tolist()}
for count in ((2, 4) if part == "mesh" else ()):
    mesh = make_flat_mesh(count)
    for name, (fn, args, kw) in gens.items():
        g = prepare_graph(getattr(M, fn)(*args, **kw))
        ms = distributed_multisource(g, mesh, concurrency=c)
        out["multisource"][f"{name}/{count}"] = {
            "per_device_edge_checks":
                ms.dist["per_device_edge_checks"].tolist(),
            "balance_ratio": ms.dist["balance_ratio"],
            "supersteps": ms.supersteps, "n_chunks": ms.n_chunks,
            "l_counts": ms.l_counts.tolist()}
        if name == "bbd":
            for policy in ("interleave", "contiguous"):
                d = distributed_symbolic(g, mesh, policy=policy)
                out["symbolic"][f"{count}/{policy}"] = {
                    "per_device_edge_checks":
                        d["per_device_edge_checks"].tolist(),
                    "balance_ratio": d["balance_ratio"],
                    "iters": np.asarray(d["iters"]).tolist(),
                    "l_counts": d["l_counts"].tolist()}
    for op in ("add", "xor", "max", "compress"):
        rng = np.random.default_rng(5)
        if op == "compress":
            x = rng.standard_normal((count, ring_k)).astype(np.float32)
        else:
            x = rng.integers(0, 2 ** 31 - 1,
                             size=(count, ring_k)).astype(np.int32)
        ring = make_ring_allreduce(mesh, "shards",
                                   op="add" if op == "compress" else op,
                                   compress=op == "compress")
        got = np.asarray(ring(jnp.asarray(x)))
        out["ring"][f"{op}/{count}"] = got.view(np.int32).tolist()
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX reference subprocesses (4 forced host devices): the
    mesh-less plans, in two halves, and the mesh runs
    (``distributed_multisource``, ``distributed_symbolic``, the rings) —
    started first and left to run beside the gloo worlds of 2 and 4 ranks
    and the port's single-device plans."""
    script = tmp_path_factory.mktemp("reference") / "reference.py"
    script.write_text(_REFERENCE_SCRIPT)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    names = sorted(GENS)
    parts = [("plans", {k: GENS[k] for k in names[::2]}),
             ("plans", {k: GENS[k] for k in names[1::2]}),
             ("mesh", GENS)]
    procs = [subprocess.Popen(
        [sys.executable, str(script), part, json.dumps(gens),
         str(CONCURRENCY), str(RING_K)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for part, gens in parts]
    try:
        worlds = {w: run_world(w, _world_rank,
                               workdir=tmp_path_factory.mktemp(f"world{w}"))
                  for w in WORLDS}
        single = {}
        for name in GENS:
            a = _port_matrix(name)
            single[name] = _plan_record(
                repro_torch.analyze(a, _opts(), device="cpu"),
                generic_values_csr(a))
        a = _port_matrix("bbd")
        single["kernel"] = _plan_record(repro_torch.analyze(
            a, _opts(backend="kernel", numeric_backend="kernel"),
            device="cpu"), generic_values_csr(a))
        ref = {"plans": {}, "multisource": {}, "symbolic": {}, "ring": {}}
        for proc in procs:
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, stderr[-4000:]
            line = [ln for ln in stdout.splitlines()
                    if ln.startswith("RESULT ")][-1]
            for key, val in json.loads(line[len("RESULT "):]).items():
                ref[key].update(val)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    reference = {}
    for name, rec in ref["plans"].items():
        reference[name] = {k: np.asarray(v) for k, v in rec.items()
                           if k != "fp"}
        reference[name]["fp"] = {f: np.asarray(v)
                                 for f, v in rec["fp"].items()}
    return {"worlds": worlds, "single": single, "reference": reference,
            "mesh": ref}


@pytest.fixture(scope="module")
def worlds(runs):
    return runs["worlds"]


@pytest.fixture(scope="module")
def single(runs):
    return runs["single"]


@pytest.fixture(scope="module")
def reference(runs):
    return runs["reference"]


@pytest.fixture(scope="module")
def mesh_reference(runs):
    return runs["mesh"]


def _same_structure(got, want):
    for key in ("l", "u", "supernodes", "indptr", "rowind"):
        assert np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(GENS))
def test_world_structure_bitwise(worlds, single, reference, world, name):
    """Every rank's counts, supernodes and CSC pattern are bitwise the
    port's single-device plan's and the reference's mesh-less plan's."""
    for rank_out in worlds[world]:
        got = rank_out["plans"][name]
        _same_structure(got, single[name])
        _same_structure(got, reference[name])
        assert got["n_devices"] == world


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(GENS))
def test_world_fingerprints_bitwise(worlds, single, reference, world, name):
    for rank_out in worlds[world]:
        got = rank_out["plans"][name]["fp"]
        for f in FP_FIELDS:
            assert np.array_equal(got[f], single[name]["fp"][f]), f
            assert np.array_equal(got[f], reference[name]["fp"][f]), f


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(GENS))
def test_world_factors_and_solves_bitwise(worlds, single, reference, world,
                                          name):
    """A placed plan's factors and solves are bitwise the single-device
    plan's; against the reference's float64 host factors, the reference
    tests' 1e-10."""
    for rank_out in worlds[world]:
        got = rank_out["plans"][name]
        assert np.array_equal(got["flat"], single[name]["flat"])
        assert np.array_equal(got["x"], single[name]["x"])
        ref_x = reference[name]["x"]
        assert np.abs(got["x"] - ref_x).max() <= 1e-10 * np.abs(ref_x).max()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(GENS))
def test_world_dist_matches_reference(worlds, mesh_reference, world, name):
    """``sym.dist`` and the superstep count equal the reference's
    ``distributed_multisource`` at the same shard count."""
    want = mesh_reference["multisource"][f"{name}/{world}"]
    for rank_out in worlds[world]:
        got = rank_out["plans"][name]
        assert got["dist"]["n_shards"] == world
        assert (got["dist"]["per_device_edge_checks"].tolist()
                == want["per_device_edge_checks"])
        assert got["dist"]["balance_ratio"] == want["balance_ratio"]
        assert got["dist"]["overlap_hidden_s"] == 0.0  # reduced in turn
        assert got["supersteps"] == want["supersteps"]
        assert got["reinits"] == want["n_chunks"]
        assert got["l"].tolist() == want["l_counts"]


@pytest.mark.parametrize("world", WORLDS)
def test_world_distribute_option_and_kernel_backend(worlds, single, world):
    """``LUOptions(distribute=True)`` equals the explicit mesh; the kernel
    backends' placed factors are bitwise the single-device ones."""
    for rank_out in worlds[world]:
        for key in ("flat", "x", "l", "rowind", "supernodes"):
            assert np.array_equal(rank_out["distribute"][key],
                                  rank_out["plans"]["bbd"][key]), key
            assert np.array_equal(rank_out["kernel"][key],
                                  single["kernel"][key]), key


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("policy", ["interleave", "contiguous"])
def test_distributed_symbolic_matches_reference(worlds, mesh_reference,
                                                world, policy):
    want = mesh_reference["symbolic"][f"{world}/{policy}"]
    for rank_out in worlds[world]:
        got = rank_out["symbolic"][policy]
        assert (got["per_device_edge_checks"].tolist()
                == want["per_device_edge_checks"])
        assert got["balance_ratio"] == want["balance_ratio"]
        assert got["iters"].tolist() == want["iters"]
        assert got["l_counts"].tolist() == want["l_counts"]
    inter = worlds[world][0]["symbolic"]["interleave"]["balance_ratio"]
    contig = worlds[world][0]["symbolic"]["contiguous"]["balance_ratio"]
    assert inter < contig


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("op", RING_OPS)
def test_ring_allreduce_matches_reference(worlds, mesh_reference, world, op):
    """The ring is the reference's hop for hop: add (wrapping int32), xor
    and max bitwise, every rank the same.  The int8-compressed add rank by
    rank (each rank keeps the chunk it reduced exact and the others' as the
    wire delivered them, so the ranks differ, in the reference as here):
    within 1 float32 ulp per hop, 2 (W - 1) hops, each ulp taken at the
    largest magnitude a partial sum of that element can reach (the sum of
    the ranks' dequantized magnitudes) — XLA contracts the reference's
    dequantize-and-accumulate ``acc + q * scale`` into one fused
    multiply-add, the port rounds the product and the sum apart."""
    want = np.array(mesh_reference["ring"][f"{op}/{world}"], dtype=np.int32)
    assert (want == want[0]).all() == (op != "compress")
    for rank, rank_out in enumerate(worlds[world]):
        got = rank_out["ring"][op].view(np.int32)
        if op != "compress":
            assert np.array_equal(got, want[rank])
            continue
        x = _ring_payload(op, world)
        reach = (np.abs(x) + np.abs(x).max(axis=1, keepdims=True) / 127
                 ).sum(axis=0).astype(np.float32)
        diff = np.abs(got.view(np.float32).astype(np.float64)
                      - want[rank].view(np.float32).astype(np.float64))
        assert (diff <= 2 * (world - 1) * np.spacing(reach)).all()


@pytest.mark.parametrize("world", WORLDS)
def test_merge_fingerprint_shards_matches_host_fold(worlds, single, world):
    """The ring merge of the ranks' disjoint shards equals folding them on
    the host with ``ColumnFingerprints.merge``, and the single-device
    fingerprints; an overlapping shard raises on every rank."""
    outs = worlds[world]
    n = len(outs[0]["shard"]["counts"])
    fold = ColumnFingerprints(n=n)
    for rank_out in outs:
        shard = ColumnFingerprints(n=n)
        for f in FP_FIELDS:
            setattr(shard, f, rank_out["shard"][f].copy())
        fold.merge(shard)
    for rank_out in outs:
        for f in FP_FIELDS:
            assert np.array_equal(rank_out["merged"][f], getattr(fold, f)), f
            assert np.array_equal(rank_out["merged"][f],
                                  single["bbd"]["fp"][f]), f
        assert "overlapping fingerprint shards" in rank_out["overlap_error"]
    with pytest.raises(ValueError, match="overlapping fingerprint shards"):
        fold.merge(fold)


@pytest.mark.parametrize("n,shards", [(10, 4), (320, 3), (7, 8), (64, 2)])
@pytest.mark.parametrize("policy", ["interleave", "contiguous"])
def test_assign_sources_and_ownership_match_reference(n, shards, policy):
    from repro.core import distributed as rdist

    got = tdist.assign_sources(n, shards, policy=policy)
    want = rdist.assign_sources(n, shards, policy=policy)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(tdist.ownership_mask(got),
                          rdist.ownership_mask(want))


def test_flat_mesh_without_a_process_group():
    """No process group: a one-shard mesh with no group, rings the
    identity, ``n_devices`` out of range raising the reference's error."""
    from repro.launch.mesh import make_flat_mesh as ref_mesh

    mesh = make_flat_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    assert mesh.axis_names == (FLAT_AXIS,) and mesh.shape == {FLAT_AXIS: 1}
    assert mesh.device == torch.device("cpu")
    x = torch.arange(5, dtype=torch.int32)
    assert tcoll.ring_allreduce(x, mesh, op="xor") is x
    for bad in (0, 2):
        with pytest.raises(ValueError) as ref:
            ref_mesh(bad)
        with pytest.raises(ValueError) as got:
            make_flat_mesh(bad, device="cpu")
        assert str(got.value) == str(ref.value)
    for kw, msg in ((dict(op="min"), "unknown ring op"),
                    (dict(op="xor", compress=True), "only supports")):
        with pytest.raises(ValueError, match=msg):
            tcoll.ring_allreduce(x, mesh, **kw)


def test_quantize_matches_reference():
    """The int8 wire codec: max-abs/127 scale, half-to-even rounding,
    bitwise ``jnp``'s."""
    import jax.numpy as jnp
    from repro.runtime import collectives as rcoll

    g = np.random.default_rng(3).standard_normal(257).astype(np.float32)
    g[:4] = [0.5, -1.5, 2.5, 0.0]
    q, s = tcoll.quantize(torch.from_numpy(g))
    rq, rs = rcoll.quantize(jnp.asarray(g))
    assert np.array_equal(q.numpy(), np.asarray(rq))
    assert s.numpy().tobytes() == np.asarray(rs).tobytes()
    assert np.array_equal(tcoll.dequantize(q, s).numpy(),
                          np.asarray(rcoll.dequantize(rq, rs)))


def test_mesh_argument_checks_match_reference():
    """The reference's argument checks of the sharded path, same types and
    messages (a one-shard mesh on both sides)."""
    import repro
    from repro.core.symbolic import symbolic_factorize as ref_sym
    from repro.launch.mesh import make_flat_mesh as ref_mesh
    from repro.sparse import matrices as RM
    from repro_torch.core.symbolic import symbolic_factorize as port_sym

    a_ref = RM.grid2d_laplacian(6)
    a = TM.grid2d_laplacian(6)
    for kw in (dict(runtime="dynamic"), dict(checkpoint_path="x.jsonl"),
               dict(bubble=True), dict(runtime="bogus")):
        with pytest.raises(ValueError) as ref:
            ref_sym(a_ref, mesh=ref_mesh(), **kw)
        with pytest.raises(ValueError) as got:
            port_sym(a, mesh=make_flat_mesh(device="cpu"), **kw)
        assert str(got.value) == str(ref.value)
    with pytest.raises(ValueError) as ref:
        repro.analyze(a_ref, repro.LUOptions(bubble=True), mesh=ref_mesh())
    with pytest.raises(ValueError) as got:
        repro_torch.analyze(a, repro_torch.LUOptions(bubble=True),
                            mesh=make_flat_mesh(device="cpu"))
    assert str(got.value) == str(ref.value)
