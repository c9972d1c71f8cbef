"""repro_torch kernels: the plain versions against the Pallas kernels (JAX
interpret mode) and their jnp oracles, and the dispatch rules of
``repro_torch.kernels.ops``.  The CUDA kernels themselves run only on a
card: ``test_torch_cuda.py`` holds them against the plain versions there."""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, plain, work
from test_torch_cuda import (
    I32MAX, MAPPED_SHAPES, _fp_inputs, _mapped_inputs, _mapped_operands,
    _pu_inputs, _pu_tol, _relax_adjacency, _relax_inputs,
)

# tiny shapes, several pytest workers: one intra-op thread each keeps
# torch's pool from oversubscribing the CPU
torch.set_num_threads(1)


@pytest.mark.parametrize("s,u,v", [
    (1, 8, 16), (4, 50, 70), (9, 131, 257), (2, 1, 1), (16, 256, 130),
])
def test_minmax_relax_plain_matches_pallas(s, u, v):
    prop, adj = _relax_inputs(s, u, v, seed=s * 1000 + u + v)
    want = np.asarray(jops.minmax_relax(jnp.asarray(prop), jnp.asarray(adj)))
    np.testing.assert_array_equal(
        want, np.asarray(jref.minmax_relax_ref(jnp.asarray(prop),
                                               jnp.asarray(adj))))
    got = ops.minmax_relax(torch.as_tensor(prop), torch.as_tensor(adj))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind,s,u,v", [
    ("empty", 6, 70, 100), ("dense", 5, 40, 33), ("ragged", 7, 101, 77),
    ("border", 4, 96, 130)])
def test_minmax_relax_plain_matches_pallas_adjacencies(kind, s, u, v):
    """The adjacencies the card test holds K1 to bitwise, on the CPU: the
    plain version against the Pallas kernel (interpret mode)."""
    rng = np.random.default_rng(u + v)
    prop = rng.integers(-1, u + 2, size=(s, u)).astype(np.int32)
    prop[rng.random((s, u)) < 0.3] = I32MAX
    adj = _relax_adjacency(kind, u, v, rng)
    want = np.asarray(jops.minmax_relax(jnp.asarray(prop), jnp.asarray(adj)))
    got = ops.minmax_relax(torch.as_tensor(prop), torch.as_tensor(adj))
    np.testing.assert_array_equal(got.numpy(), want)


def test_minmax_relax_sentinels_near_int32_top():
    """Label-arena offsets sit just under int32 max: the masked-out INF must
    never undercut them, and nothing may promote to int64."""
    prop, adj = _relax_inputs(8, 96, 120, seed=7, high=I32MAX - 5)
    want = np.asarray(jref.minmax_relax_ref(jnp.asarray(prop),
                                            jnp.asarray(adj)))
    got = plain.minmax_relax_plain(torch.as_tensor(prop), torch.as_tensor(adj),
                                   max_elems=4096)      # many u chunks
    np.testing.assert_array_equal(got.numpy(), want)
    empty = plain.minmax_relax_plain(torch.as_tensor(prop),
                                     torch.zeros((96, 40), dtype=torch.uint8))
    assert int(empty.min()) == I32MAX


@pytest.mark.parametrize("s,v", [(1, 1), (5, 100), (13, 300), (33, 700),
                                 (64, 129)])
def test_column_fingerprints_plain_matches_pallas(s, v):
    args = _fp_inputs(s, v, seed=s * 101 + v)
    want = np.asarray(jops.column_fingerprints(*map(jnp.asarray, args)))
    np.testing.assert_array_equal(
        want, np.asarray(jref.supernode_fp_ref(*map(jnp.asarray, args))))
    got = ops.column_fingerprints(*map(torch.as_tensor, args))
    assert got.dtype == torch.int32 and got.shape == (3, v)
    np.testing.assert_array_equal(got.numpy(), want)


def test_column_fingerprints_hash_sum_wraps_int32():
    """m1 hashes near 2^31 overflow the column sum: it must wrap mod 2^32
    exactly like the reference's int32 sum (torch.sum of int32 is int64)."""
    s, v = 40, 64
    rel = np.full((s, v), -1, dtype=np.int32)       # every label "filled"
    src = np.full(s, v, dtype=np.int32)             # every row below
    m1 = np.full(s, 2**31 - 7, dtype=np.int64).astype(np.int32)
    m2 = np.arange(s, dtype=np.int32) * 0x01010101
    valid = np.ones(s, dtype=np.int32)
    args = (rel, src, m1, m2, valid)
    want = np.asarray(jref.supernode_fp_ref(*map(jnp.asarray, args)))
    got = plain.column_fingerprints_plain(*map(torch.as_tensor, args))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(want[1, 0]) != s * (2**31 - 7)       # it did wrap


@pytest.mark.parametrize("m,k,n", [(8, 8, 8), (200, 96, 70), (37, 5, 130),
                                   (128, 256, 128), (1, 1, 1)])
def test_panel_update_plain_matches_pallas(m, k, n):
    acc, lp, up = _pu_inputs((m, n), (m, k), (k, n), seed=m * 31 + k + n)
    want = np.asarray(jops.panel_update(acc, lp, up))
    ref = np.asarray(jref.panel_update_ref(*map(jnp.asarray, (acc, lp, up))))
    got = ops.panel_update(*map(torch.as_tensor, (acc, lp, up)))
    assert got.dtype == torch.float32
    tol = _pu_tol(lp, up)
    assert np.abs(got.numpy() - want).max() <= tol
    assert np.abs(got.numpy() - ref).max() <= tol


@pytest.mark.parametrize("b,m,k,n", [(3, 16, 8, 4), (5, 33, 70, 9)])
def test_panel_update_batched_plain_matches_pallas(b, m, k, n):
    acc, lp, up = _pu_inputs((b, m, n), (b, m, k), (b, k, n), seed=b + m)
    want = np.asarray(jops.panel_update_batched(acc, lp, up))
    got = ops.panel_update_batched(*map(torch.as_tensor, (acc, lp, up)))
    assert np.abs(got.numpy() - want).max() <= _pu_tol(lp, up)
    single = ops.panel_update(*map(torch.as_tensor, (acc[1], lp[1], up[1])))
    np.testing.assert_array_equal(got[1].numpy(), single.numpy())


@pytest.mark.parametrize("b,m,k,n", [(4, 8, 1, 1), (3, 33, 70, 9)])
def test_panel_update_batched_plain_float64_is_per_panel(b, m, k, n):
    """The float64 sweep's stacked update on the CPU: every slice bitwise
    the per-panel ``acc - l @ u`` (a stacked ``torch.matmul`` is not)."""
    acc, lp, up = (torch.as_tensor(x.astype(np.float64)) for x in _pu_inputs(
        (b, m, n), (b, m, k), (b, k, n), seed=b * m + k))
    got = ops.panel_update_batched(acc, lp, up)
    assert got.dtype == torch.float64
    for i in range(b):
        assert torch.equal(got[i], ops.panel_update(acc[i], lp[i], up[i]))
        assert torch.equal(got[i], acc[i] - lp[i] @ up[i])


@pytest.mark.parametrize("m,k,n", [(0, 4, 5), (6, 0, 5), (6, 4, 0)])
def test_panel_update_empty_returns_acc(m, k, n):
    acc, lp, up = _pu_inputs((m, n), (m, k), (k, n), seed=1)
    want = np.asarray(jops.panel_update(acc, lp, up))
    got = ops.panel_update(*map(torch.as_tensor, (acc, lp, up)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), acc)
    accb, lpb, upb = (x[None] for x in (acc, lp, up))
    gotb = ops.panel_update_batched(*map(torch.as_tensor, (accb, lpb, upb)))
    np.testing.assert_array_equal(gotb.numpy(), accb)


@pytest.mark.parametrize("f32", [False, True])
def test_panel_update_mapped_plain_matches_pallas(f32):
    """The plain mapped update in place, slice by slice, against the Pallas
    panel update (interpret mode, float32) on the gathered operands; the
    entries it must not touch stay as they were."""
    shapes = [(9, 1, 2), (14, 14, 48), (33, 5, 17), (3, 20, 7)]
    flat, u, lmap, tiles = _mapped_inputs(shapes, seed=11)
    got = torch.as_tensor(flat.copy())
    ops.panel_update_mapped(got, torch.as_tensor(u), torch.as_tensor(lmap),
                            torch.as_tensor(tiles), f32=f32)
    assert ops.panel_update_mapped.launches == 0
    np.testing.assert_array_equal(got[:4096].numpy(), flat[:4096])
    recs = tiles[(tiles[:, 6] == 0) & (tiles[:, 7] == 0)]
    assert len(recs) == len(shapes)
    for rec in recs:
        acc, lp, up = (x.astype(np.float32)
                       for x in _mapped_operands(flat, u, lmap, rec))
        want = np.asarray(jops.panel_update(acc, lp, up))
        acc_off, m, n = int(rec[0]), int(rec[3]), int(rec[4])
        out = got[acc_off:acc_off + m * n].numpy().reshape(m, n)
        assert np.abs(out - want).max() <= _pu_tol(lp, up)


@pytest.mark.parametrize("m,n,k", MAPPED_SHAPES + [(1, 200, 3), (64, 1, 17)])
def test_mapped_tiles_cover_each_output_once(m, n, k):
    """The tile records of a slice cover its (M, N) outputs exactly once,
    with tiles the kernel takes: TC a power of two in the kind's range,
    ``PANEL_THREADS // TC`` rows, BK 16 up to K = 16 and 32 beyond."""
    tiles = ops.mapped_tiles([(100, 7, 3, m, n, k)])
    seen = np.zeros((m, n), dtype=int)
    for *head, m0, n0, tc, bk in tiles.tolist():
        assert head == [100, 7, 3, m, n, k]
        assert tc & (tc - 1) == 0 and bk == (32 if k > 16 else 16)
        assert 4 <= tc <= (32 if bk == 32 else 64)
        seen[m0:m0 + ops.PANEL_THREADS // tc, n0:n0 + tc] += 1
    assert (seen == 1).all()


def test_dispatch_rules_on_the_cpu():
    """CPU tensors take the plain version and count no launch; ``meta``
    tensors (a shape-only trace) compute nothing, launch nothing and count
    no launch, and record one launch in the dry run's work tally; inputs
    on mixed devices raise instead of falling back."""
    ops.reset_launches()
    prop, adj = _relax_inputs(4, 32, 32, seed=2)
    ops.minmax_relax(torch.as_tensor(prop), torch.as_tensor(adj))
    assert set(ops.launch_counts().values()) == {0}
    work.reset()
    out = ops.minmax_relax(torch.as_tensor(prop, device="meta"),
                           torch.as_tensor(adj, device="meta"))
    assert out.is_meta and tuple(out.shape) == (4, 32)
    assert set(ops.launch_counts().values()) == {0}
    assert work.totals()["minmax_relax"]["launches"] == 1
    with pytest.raises(ValueError, match="one device"):
        ops.minmax_relax(torch.as_tensor(prop, device="meta"),
                         torch.as_tensor(adj))
    flat, u, lmap, tiles = (torch.as_tensor(x) for x in _mapped_inputs(
        [(4, 2, 3)], seed=1))
    with pytest.raises(ValueError, match="one device"):
        ops.panel_update_mapped(flat.to("meta"), u, lmap.to("meta"),
                                tiles.to("meta"))
    ops.panel_update_mapped(flat.to("meta"), u.to("meta"), lmap.to("meta"),
                            tiles.to("meta"))
    assert set(ops.launch_counts().values()) == {0}
    assert work.totals()["panel_update_mapped"] == {
        "launches": 1, "bytes": None, "flops": None}


def test_ell_superstep_dispatch_and_checks():
    """K8 on the CPU runs its plain version in place and counts no launch;
    on ``meta`` it launches nothing and records one launch with
    ``work.ell_superstep_work``; on a device that checks (``meta``) wrong
    shapes, dtypes and one buffer for both labels raise."""
    s, n, k = 3, 10, 4

    def args(device, **over):
        t = dict(labels=torch.full((s, n), plain.INF, dtype=torch.int32),
                 out=torch.zeros((s, n), dtype=torch.int32),
                 in_ell=torch.full((n, k), n, dtype=torch.int32),
                 out_deg=torch.ones(n, dtype=torch.int32),
                 srcs=torch.arange(s, dtype=torch.int32),
                 edges=torch.zeros(s, dtype=torch.int32),
                 conv=torch.zeros(s, dtype=torch.int32),
                 flag=torch.zeros(1, dtype=torch.int32))
        t.update(over)
        return {name: x.to(device) for name, x in t.items()}

    ops.reset_launches()
    cpu = args("cpu")
    ops.ell_superstep(**cpu, offset=0, it=0)
    assert torch.equal(cpu["out"], cpu["labels"])   # nothing to expand
    assert int(cpu["flag"]) == 0 and ops.launch_counts()["ell_superstep"] == 0
    work.reset()
    ops.ell_superstep(**args("meta"), offset=0, it=0)
    assert ops.launch_counts()["ell_superstep"] == 0
    assert work.totals()["ell_superstep"] == {
        "launches": 1, "bytes": work.ell_superstep_work(s, n, k)[0],
        "flops": work.ell_superstep_work(s, n, k)[1]}
    for bad in (dict(out=torch.zeros((s, n + 1), dtype=torch.int32)),
                dict(conv=torch.zeros(s, dtype=torch.int64)),
                dict(in_ell=torch.zeros((n, k), dtype=torch.int32).t())):
        with pytest.raises(ValueError):
            ops.ell_superstep(**args("meta", **bad), offset=0, it=0)
    with pytest.raises(ValueError, match="one device"):
        ops.ell_superstep(**{**args("meta"), "flag": torch.zeros(
            1, dtype=torch.int32)}, offset=0, it=0)


def test_launch_signatures_match_the_sources():
    """Every ctypes signature in ``_build.SIGNATURES`` names a function its
    source exports with as many parameters, pointers (or a stream) where
    the source has them (a wrong count only shows on the card)."""
    import re

    from repro_torch.kernels import _build

    for name, (source, symbol, argtypes) in _build.SIGNATURES.items():
        text = (_build.CSRC / f"{source}.cu").read_text()
        decl = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", text)
        assert decl, f"{source}.cu does not export {symbol}"
        params = [p.strip() for p in decl.group(1).split(",")]
        assert len(params) == len(argtypes), (name, params)
        for p, t in zip(params, argtypes):
            pointer = "*" in p or p.startswith("cudaStream_t")
            assert pointer == (t is ctypes.c_void_p), (name, p, t)
