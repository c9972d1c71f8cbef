"""repro_torch's CUDA kernels against their plain versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode).  The file imports neither jax nor the JAX
package, so it runs on a machine with only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Its input builders are shared with ``test_torch_kernels.py``."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, plain

I32MAX = np.iinfo(np.int32).max


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _relax_inputs(s, u, v, seed, *, high=None):
    rng = np.random.default_rng(seed)
    hi = u + 2 if high is None else high
    lo = -1 if high is None else high - 3 * u
    prop = rng.integers(lo, hi, size=(s, u)).astype(np.int32)
    prop[rng.random((s, u)) < 0.3] = I32MAX
    adj = (rng.random((u, v)) < 0.15).astype(np.uint8)
    return prop, adj


def _fp_inputs(s, v, seed):
    rng = np.random.default_rng(seed)
    rel = rng.integers(-1, v + 2, size=(s, v)).astype(np.int32)
    src = rng.integers(0, v, size=s).astype(np.int32)
    m1 = rng.integers(0, 2**32, size=s, dtype=np.uint64).astype(np.uint32)
    m2 = rng.integers(0, 2**32, size=s, dtype=np.uint64).astype(np.uint32)
    valid = (rng.random(s) < 0.8).astype(np.int32)
    return rel, src, m1.view(np.int32), m2.view(np.int32), valid


def _pu_inputs(shape_acc, shape_l, shape_u, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(sh).astype(np.float32)
                 for sh in (shape_acc, shape_l, shape_u))


def _pu_tol(l_panel, u_panel):
    k = l_panel.shape[-1]
    return 2e-6 * k * np.abs(l_panel).max() * np.abs(u_panel).max()


def _mapped_inputs(shapes, seed, *, absent=0.3):
    """A random store for the mapped panel update: (flat, u, lmap, tiles)
    as numpy, slices of ``shapes`` (M, N, K) whose acc runs lie after every
    L entry, a share ``absent`` of L entries structural zeros (-1)."""
    rng = np.random.default_rng(seed)
    n_l = 4096
    slices, lmaps, acc, moff, uoff = [], [], n_l, 0, 0
    for m, n, k in shapes:
        idx = rng.integers(0, n_l, m * k)
        idx[rng.random(m * k) < absent] = -1
        lmaps.append(idx)
        slices.append((acc, moff, uoff, m, n, k))
        acc, moff, uoff = acc + m * n, moff + m * k, uoff + k * n
    flat = rng.standard_normal(acc)
    u = rng.standard_normal(uoff)
    return (flat, u, np.concatenate(lmaps).astype(np.int32),
            ops.mapped_tiles(slices))


def _mapped_operands(flat, u, lmap, rec):
    """(acc, L, U) of one slice record, gathered (L through lmap)."""
    acc_off, map_off, u_off, m, n, k = (int(x) for x in rec[:6])
    lm = lmap[map_off:map_off + m * k].reshape(m, k)
    lp = np.where(lm >= 0, flat[np.maximum(lm, 0)], 0.0)
    return (flat[acc_off:acc_off + m * n].reshape(m, n), lp,
            u[u_off:u_off + k * n].reshape(k, n))


@pytest.mark.cuda
@pytest.mark.parametrize("s,u,v", [(1, 8, 16), (33, 131, 257), (64, 512, 300)])
def test_minmax_relax_kernel_bitwise(cuda, s, u, v):
    prop, adj = _relax_inputs(s, u, v, seed=u + v)
    prop, adj = torch.as_tensor(prop, device=cuda), torch.as_tensor(
        adj, device=cuda)
    before = ops.minmax_relax.launches
    got = ops.minmax_relax(prop, adj)
    assert ops.minmax_relax.launches == before + 1
    assert torch.equal(got, plain.minmax_relax_plain(prop, adj))


def _relax_adjacency(kind, u, v, rng):
    """The adjacencies K1 is held to bitwise: none, all, a sparse ragged
    one, and a sparse one with one dense strip of border columns."""
    if kind == "empty":
        return np.zeros((u, v), np.uint8)
    if kind == "dense":
        return np.ones((u, v), np.uint8)
    adj = (rng.random((u, v)) < 0.02).astype(np.uint8)
    if kind == "border":
        adj[:, v - 64:] = 1
    return adj


@pytest.mark.cuda
@pytest.mark.parametrize("kind,s,u,v", [
    ("empty", 512, 1024, 2048), ("dense", 40, 300, 200),
    ("ragged", 530, 1001, 1037), ("border", 512, 2048, 1280)])
def test_minmax_relax_kernel_bitwise_adjacencies(cuda, kind, s, u, v):
    rng = np.random.default_rng(u + v)
    prop = rng.integers(-1, u + 2, size=(s, u)).astype(np.int32)
    prop[rng.random((s, u)) < 0.3] = I32MAX
    adj = _relax_adjacency(kind, u, v, rng)
    prop, adj = (torch.as_tensor(x, device=cuda) for x in (prop, adj))
    got = ops.minmax_relax(prop, adj)
    assert torch.equal(got, plain.minmax_relax_plain(prop, adj))


def _stencil27(nx, hubs=0):
    """The 27-point stencil on an nx^3 grid in natural order (n = nx^3, 26
    in-neighbours a vertex inside), with ``hubs`` vertices joined both ways
    to every vertex (in-degree n - 1: K8 then reads its table from device
    memory, not from shared memory)."""
    from repro_torch.sparse import csr_from_coo

    g = np.arange(nx ** 3).reshape(nx, nx, nx)
    rows, cols = [], []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                src = g[max(0, -dx):nx - max(0, dx),
                        max(0, -dy):nx - max(0, dy),
                        max(0, -dz):nx - max(0, dz)]
                dst = g[max(0, dx):nx - max(0, -dx),
                        max(0, dy):nx - max(0, -dy),
                        max(0, dz):nx - max(0, -dz)]
                rows.append(src.ravel())
                cols.append(dst.ravel())
    n = nx ** 3
    for h in range(hubs):
        hub = (h * 331) % n
        rows += [np.full(n, hub), np.arange(n)]
        cols += [np.arange(n), np.full(n, hub)]
    return csr_from_coo(n, np.concatenate(rows), np.concatenate(cols))


def _ell_state(graph, srcs, window):
    """Labels of a fresh chunk: offset 0, or an arena window just under the
    int32 top over a stale buffer whose entries all read as uninitialized."""
    from repro_torch.core import gsofa
    from repro_torch.core.spaceopt import LabelArena

    s, n = srcs.shape[0], graph.n
    if not window:
        return gsofa.init_labels(graph, srcs), 0
    offset = LabelArena(capacity=s, n=n, device=graph.device).next_window()
    stale = torch.randint(offset + n + 1, I32MAX, (s, n), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(s))
    return gsofa.init_labels(graph, srcs, offset=offset,
                             stale_buf=stale.to(graph.device)), offset


@pytest.mark.cuda
@pytest.mark.parametrize("nx,hubs,s,window", [
    (9, 0, 1, False), (9, 0, 1, True), (9, 0, 48, False), (9, 0, 48, True),
    (9, 0, 512, False), (9, 0, 512, True), (7, 2, 48, False),
    (7, 2, 300, True)])
def test_ell_superstep_kernel_bitwise(cuda, nx, hubs, s, window):
    """K8 against its plain version on the card, superstep by superstep
    (next labels, edges, conv, flag) through a whole fixpoint, then a
    whole ``gsofa_batch`` on the card against the CPU's; n = 729 or 343 is
    no multiple of K8's 128-vertex tile, and hubs push K past its shared
    table."""
    from repro_torch.core import gsofa

    a = _stencil27(nx, hubs)
    graph = gsofa.prepare_graph(a, device=cuda)
    srcs = torch.as_tensor((a.n - 1 - 7 * np.arange(s)) % a.n,
                           dtype=torch.int32, device=cuda)
    labels0, offset = _ell_state(graph, srcs, window)
    kern = [labels0.clone(), torch.full_like(labels0, -7)]
    ref = [labels0.clone(), torch.full_like(labels0, 5)]
    counts = {side: [torch.zeros(s, dtype=torch.int32, device=cuda),
                     torch.zeros(s, dtype=torch.int32, device=cuda),
                     torch.zeros(1, dtype=torch.int32, device=cuda)]
              for side in ("kernel", "plain")}
    before = ops.ell_superstep.launches
    it = 0
    while True:
        ops.ell_superstep(*kern, graph.in_ell, graph.out_deg, srcs,
                          *counts["kernel"], offset=offset, it=it)
        plain.ell_superstep_plain(*ref, graph.in_ell, graph.out_deg, srcs,
                                  *counts["plain"], offset=offset, it=it)
        assert torch.equal(kern[1], ref[1]), it
        for got, want in zip(counts["kernel"], counts["plain"]):
            assert torch.equal(got, want), it
        kern.reverse()
        ref.reverse()
        it += 1
        if int(counts["plain"][2]) != it:
            break
    assert it > 2 and ops.ell_superstep.launches == before + it
    host = gsofa.prepare_graph(a, device="cpu")
    want = gsofa.gsofa_batch(host, srcs.cpu(), labels0=labels0.cpu(),
                             offset=offset)
    got = gsofa.gsofa_batch(graph, srcs, labels0=labels0, offset=offset)
    assert got.iters == want.iters == it - 1
    for name in ("labels", "conv_iter", "edge_checks"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name))


@pytest.mark.cuda
@pytest.mark.parametrize("bubble", [False, True])
def test_ell_analyze_on_card_matches_cpu(cuda, bubble):
    """``analyze`` on the default ELL backend runs its fixpoint through K8
    on the card (bubble chunks on their truncated views too) and gives the
    CPU run's structure and supernodes bitwise."""
    import repro_torch

    a = _bbd_400()
    opts = repro_torch.LUOptions(concurrency=64, bubble=bubble)
    ops.reset_launches()
    card = repro_torch.analyze(a, opts, device=cuda)
    counts = ops.launch_counts()
    host = repro_torch.analyze(a, opts, device="cpu")
    for got, want in zip(_structure(card), _structure(host)):
        assert np.array_equal(got, want)
    assert card.sym.supersteps == host.sym.supersteps
    assert counts["ell_superstep"] > 0 and counts["minmax_relax"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("s,v", [(1, 1), (65, 300), (130, 1000)])
def test_column_fingerprints_kernel_bitwise(cuda, s, v):
    args = [torch.as_tensor(x, device=cuda) for x in _fp_inputs(s, v, seed=v)]
    assert torch.equal(ops.column_fingerprints(*args),
                       plain.column_fingerprints_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(200, 96, 70), (1, 1, 1), (65, 17, 129)])
def test_panel_update_kernels_on_card(cuda, m, k, n):
    acc, lp, up = _pu_inputs((4, m, n), (4, m, k), (4, k, n), seed=m + n)
    acc, lp, up = (torch.as_tensor(x, device=cuda) for x in (acc, lp, up))
    got = ops.panel_update(acc[0], lp[0], up[0])
    want = plain.panel_update_plain(acc[0], lp[0], up[0])
    assert float((got - want).abs().max()) <= _pu_tol(
        lp.cpu().numpy(), up.cpu().numpy())
    stacked = ops.panel_update_batched(acc, lp, up)
    for i in range(4):
        assert torch.equal(stacked[i], ops.panel_update(acc[i], lp[i], up[i]))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(200, 96, 70), (8, 1, 1), (65, 17, 129)])
def test_panel_update_float64_kernels_on_card(cuda, m, k, n):
    """The float64 instances: K4 bitwise K3 per slice, K3 within float64
    roundoff of the plain product, and the plain stacked version bitwise
    the plain per-panel one."""
    acc, lp, up = (torch.as_tensor(x.astype(np.float64), device=cuda)
                   for x in _pu_inputs((5, m, n), (5, m, k), (5, k, n),
                                       seed=m * n + k))
    before = ops.panel_update_batched.launches
    stacked = ops.panel_update_batched(acc, lp, up)
    assert ops.panel_update_batched.launches == before + 1
    assert stacked.dtype == torch.float64
    want = plain.panel_update_batched_plain(acc, lp, up)
    for i in range(5):
        one = ops.panel_update(acc[i], lp[i], up[i])
        assert torch.equal(stacked[i], one)
        assert torch.equal(want[i],
                           plain.panel_update_plain(acc[i], lp[i], up[i]))
        assert float((one - want[i]).abs().max()) <= 1e-14 * k * float(
            lp.abs().max() * up.abs().max())


# ragged slices (M, N, K): the sweep's (9 x 1 x 2, a border panel's 40-deep
# chain), every tile kind and edge, and the largest the card tests take
MAPPED_SHAPES = [(9, 1, 2), (14, 14, 48), (200, 3, 20), (5, 64, 7),
                 (33, 17, 512), (1, 1, 1), (130, 65, 16), (3, 5, 17)]


@pytest.mark.cuda
@pytest.mark.parametrize("f32", [False, True])
def test_panel_update_mapped_kernel_matches_plain(cuda, f32):
    """The mapped update in place on the card against its plain version:
    ragged slices, absent rows, both element modes."""
    flat, u, lmap, tiles = _mapped_inputs(MAPPED_SHAPES, seed=int(f32))
    got, want = (torch.as_tensor(flat, device=cuda) for _ in range(2))
    u_d, lmap_d, tiles_d = (torch.as_tensor(x, device=cuda)
                            for x in (u, lmap, tiles))
    before = ops.panel_update_mapped.launches
    ops.panel_update_mapped(got, u_d, lmap_d, tiles_d, f32=f32)
    assert ops.panel_update_mapped.launches == before + 1
    plain.panel_update_mapped_plain(want, u_d, lmap_d, tiles_d, f32=f32)
    torch.cuda.synchronize()
    assert torch.equal(got[:4096], torch.as_tensor(flat[:4096], device=cuda))
    eps = 2e-6 if f32 else 1e-14
    for rec in tiles[(tiles[:, 6] == 0) & (tiles[:, 7] == 0)]:
        acc_off, m, n, k = int(rec[0]), *(int(x) for x in rec[3:6])
        sl = slice(acc_off, acc_off + m * n)
        _, lp, up = _mapped_operands(flat, u, lmap, rec)
        tol = eps * k * max(np.abs(lp).max(), 1.0) * np.abs(up).max()
        assert float((got[sl] - want[sl]).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("f32", [False, True])
def test_panel_update_mapped_kernel_is_dense_k3(cuda, f32):
    """Every slice of one multi-slice launch is bitwise a launch over that
    slice alone, and bitwise dense K3 on the gathered operands (float32
    mode: on ``.float()`` operands, widened)."""
    flat, u, lmap, tiles = _mapped_inputs(MAPPED_SHAPES, seed=7)
    all_at_once = torch.as_tensor(flat, device=cuda)
    u_d, lmap_d, tiles_d = (torch.as_tensor(x, device=cuda)
                            for x in (u, lmap, tiles))
    ops.panel_update_mapped(all_at_once, u_d, lmap_d, tiles_d, f32=f32)
    for rec in tiles[(tiles[:, 6] == 0) & (tiles[:, 7] == 0)]:
        acc_off, m, n, k = int(rec[0]), *(int(x) for x in rec[3:6])
        sl = slice(acc_off, acc_off + m * n)
        mine = (tiles[:, 0] == rec[0])
        one = torch.as_tensor(flat, device=cuda)
        # one slice, U handed over alone with its offset shifted away
        u_one = u_d[int(rec[2]):int(rec[2]) + k * n].clone()
        ops.panel_update_mapped(one, u_one, lmap_d,
                                torch.as_tensor(tiles[mine], device=cuda),
                                u_shift=int(rec[2]), f32=f32)
        assert torch.equal(one[sl], all_at_once[sl])
        acc, lp, up = (torch.as_tensor(x, device=cuda)
                       for x in _mapped_operands(flat, u, lmap, rec))
        if f32:
            dense = ops.panel_update(acc.float(), lp.float(),
                                     up.float()).double()
        else:
            dense = ops.panel_update(acc, lp, up)
        assert torch.equal(all_at_once[sl].view(m, n), dense)


@pytest.mark.cuda
@pytest.mark.parametrize("f32", [False, True])
def test_panel_update_mapped_systems_bitwise(cuda, f32):
    """One launch over 5 systems (padded system strides) gives every
    system bitwise the one-system launch on that system alone and the
    plain version within tolerance, and writes nothing between systems."""
    flat0, u0, lmap, tiles = _mapped_inputs(MAPPED_SHAPES, seed=11)
    rng = np.random.default_rng(12)
    systems, fs, us = 5, len(flat0) + 3, len(u0) + 5
    flat = rng.standard_normal(systems * fs)
    u = rng.standard_normal(systems * us)
    lmap_d, tiles_d = (torch.as_tensor(x, device=cuda)
                       for x in (lmap, tiles))
    got = torch.as_tensor(flat, device=cuda)
    u_d = torch.as_tensor(u, device=cuda)
    before = ops.panel_update_mapped.launches
    ops.panel_update_mapped(got, u_d, lmap_d, tiles_d, f32=f32,
                            systems=systems, flat_stride=fs, u_stride=us)
    assert ops.panel_update_mapped.launches == before + 1
    want = torch.as_tensor(flat, device=cuda)
    plain.panel_update_mapped_plain(want, u_d, lmap_d, tiles_d, f32=f32,
                                    systems=systems, flat_stride=fs,
                                    u_stride=us)
    torch.cuda.synchronize()
    eps = 2e-6 if f32 else 1e-14
    k_max = int(tiles[:, 5].max())
    for sy in range(systems):
        one = torch.as_tensor(flat[sy * fs:sy * fs + len(flat0)],
                              device=cuda)
        ops.panel_update_mapped(one, u_d[sy * us:(sy + 1) * us].clone(),
                                lmap_d, tiles_d, f32=f32)
        mine = got[sy * fs:sy * fs + len(flat0)]
        assert torch.equal(mine.view(torch.int64), one.view(torch.int64))
        pad = slice(sy * fs + len(flat0), (sy + 1) * fs)
        assert torch.equal(got[pad], torch.as_tensor(flat[pad], device=cuda))
        tol = (eps * k_max * float(np.abs(flat).max())
               * float(np.abs(u).max()))
        assert float((mine - want[sy * fs:sy * fs + len(flat0)]
                      ).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["numpy", "kernel"])
def test_batched_tier_on_card_bitwise(cuda, backend):
    """factorize_batch on the card: one mapped launch per level for all
    systems, every system's factors bitwise its sequential factorization;
    solve_batch bitwise the sequential solves (which repeat bitwise); a
    NaN pivot in system 1 is named."""
    import repro_torch
    from repro_torch.sparse import bordered_block_diagonal
    from repro_torch.sparse.numeric import generic_values_csr

    a = bordered_block_diagonal(400, block=16, border=16, seed=2)
    vb = np.stack([generic_values_csr(a, seed=s) for s in range(3)])
    plan = repro_torch.analyze(a, repro_torch.LUOptions(
        concurrency=64, numeric_backend=backend), device=cuda)
    levels = sum(any(plan.gather_maps[j] is not None for j in lv)
                 for lv in plan.schedule.levels)
    before = ops.panel_update_mapped.launches
    bf = plan.factorize_batch(vb)
    assert ops.panel_update_mapped.launches == before + levels
    rhs = np.random.default_rng(3).standard_normal((3, a.n))
    rhs4 = np.random.default_rng(4).standard_normal((3, a.n, 2))
    solved, solved4 = bf.solve_batch(rhs), bf.solve_batch(rhs4)
    for i in range(3):
        seq = plan.factorize(vb[i])
        assert torch.equal(seq.store.flat, bf.store.flat[i])
        for b, res in ((rhs, solved), (rhs4, solved4)):
            s1, s2 = seq.solve(b[i]), seq.solve(b[i])
            assert torch.equal(s1.x, s2.x)
            assert torch.equal(s1.x, res.x[i])
            assert s1.residuals == res.residuals[i]
            assert s1.refine_accepted == int(res.refine_accepted[i])
    col = a.n // 2
    vb[1, a.indptr[col] + np.searchsorted(a.row(col), col)] = np.nan
    with pytest.raises(repro_torch.ZeroPivotError) as err:
        plan.factorize_batch(vb)
    assert (err.value.k, err.value.system) == (col, 1)


# the shapes chip_smoke.py holds K5 at: the serve path's prefill and decode
# (smollm-135m, 8 requests, hp = 16 heads, hd = 64, 512 + 32 tokens) and a
# D = 128 prefill (qwen3's head size)
K5_SHAPES = [(8, 16, 512, 512, 64, True), (8, 16, 1, 544, 64, True),
             (2, 16, 256, 256, 128, True)]


def _attn_inputs(b, h, s, t, d, seed, device, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.standard_normal(sh).astype(np.float32),
                                 device=device).to(dtype)
                 for sh in ((b, h, s, d), (b, h, t, d), (b, h, t, d)))


# whisper-tiny's non-causal shapes (8 requests, 6 heads of 64 over its
# 1500 encoder positions, 23 key tiles and a ragged 24th): the encoder's
# self-attention, the cross-attention of a 4-token prompt, and a decode
# step against the cross cache
WHISPER_K5_SHAPES = [(8, 6, 1500, 1500, 64, False), (8, 6, 4, 1500, 64, False),
                     (8, 6, 1, 1500, 64, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,s,t,d,causal", K5_SHAPES + WHISPER_K5_SHAPES + [
    (1, 2, 70, 130, 16, True), (1, 3, 33, 47, 16, False)])
def test_flash_attention_kernel_matches_plain(cuda, b, h, s, t, d, causal):
    q, k, v = _attn_inputs(b, h, s, t, d, seed=s + t + d, device=cuda)
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    assert ops.flash_attention.launches == before + 1
    want = plain.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.float32
    # float32 sums over up to T keys in another order than cuBLAS's
    assert float((got - want).abs().max()) <= 2e-5


@pytest.mark.cuda
def test_flash_attention_kernel_bfloat16(cuda):
    q, k, v = _attn_inputs(2, 4, 128, 160, 64, seed=9, device=cuda,
                           dtype=torch.bfloat16)
    got = ops.flash_attention(q, k, v)
    want = plain.flash_attention_plain(q, k, v)
    assert got.dtype == torch.bfloat16
    # both round the float32 result to bfloat16 once (3e-2: the reference's
    # bfloat16 tolerance)
    assert float((got.float() - want.float()).abs().max()) <= 3e-2


def _gqa_cache_inputs(b, h, hkv, s, t_alloc, kv_len, d, seed, device,
                      dtype=torch.float32):
    """q (B, H, S, D), and k, v as strided (B, Hkv, T_alloc, D) views of
    (B, T_alloc, Hkv, D) caches whose slots >= kv_len hold NaN."""
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(rng.standard_normal((b, h, s, d)).astype(np.float32),
                        device=device).to(dtype)
    kv = []
    for _ in range(2):
        x = rng.standard_normal((b, t_alloc, hkv, d)).astype(np.float32)
        x[:, kv_len:] = np.nan
        kv.append(torch.as_tensor(x, device=device).to(dtype).transpose(1, 2))
    return q, kv[0], kv[1]


# grouped heads over a cache read in place: smollm's 9 of 16 query heads on
# 3 KV heads, a group of 4 with no padding, and no grouping; prefill and
# decode; the kernel must not read past kv_len (NaN there)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("b,h,live,hkv,s,t_alloc,kv_len,causal", [
    (2, 16, 9, 3, 70, 200, 150, True), (2, 16, 9, 3, 1, 200, 150, True),
    (1, 8, 8, 2, 1, 300, 257, True), (1, 4, 4, 4, 33, 96, 47, False)])
def test_flash_attention_kernel_grouped_cache(cuda, dtype, d, b, h, live,
                                              hkv, s, t_alloc, kv_len,
                                              causal):
    q, k, v = _gqa_cache_inputs(b, h, hkv, s, t_alloc, kv_len, d,
                                seed=s + kv_len + d, device=cuda, dtype=dtype)
    kw = {"causal": causal, "kv_len": kv_len, "live_heads": live}
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, **kw)
    assert ops.flash_attention.launches == before + 1
    want = plain.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == dtype
    assert bool(torch.isfinite(got).all())
    assert not bool(got[:, live:].any())          # padded heads exactly 0
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    assert float((got.float() - want.float()).abs().max()) <= tol


# internvl2-26b's grouped shapes: 48 query heads on 8 KV heads (a group of
# 6) at D = 128, the 768-position prefill (256 patches + 512 tokens) and a
# decode step over 790 of the 800 cache slots
@pytest.mark.cuda
@pytest.mark.parametrize("s,t_alloc,kv_len", [(768, 768, 768),
                                              (1, 800, 790)])
def test_flash_attention_kernel_internvl_group_of_six(cuda, s, t_alloc,
                                                      kv_len):
    q, k, v = _gqa_cache_inputs(8, 48, 8, s, t_alloc, kv_len, 128,
                                seed=s + kv_len, device=cuda)
    kw = {"causal": True, "kv_len": kv_len, "live_heads": 48}
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, **kw)
    assert ops.flash_attention.launches == before + 1
    want = plain.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 2e-5


def _k5_excess(got, q, k, v, kw):
    """max |K5 - plain| beyond the output's rounding: the plain version in
    float32 on the same inputs, less one bfloat16 rounding (2^-8 of the
    value) for a bfloat16 output."""
    want = plain.flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    step = 2.0 ** -8 if got.dtype == torch.bfloat16 else 0.0
    return float(((got.float() - want).abs() - step * want.abs()).max())


# gemma3-4b's head size, D = 256: 8 live query heads of 16 on 4 KV heads;
# a prefill, a decode over a cache whose unused slots hold NaN, a decode
# over a full ring, windowed prefills and a windowed decode
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,t_alloc,kv_len,window", [
    (200, 200, 200, None), (1, 300, 257, None), (1, 128, 128, None),
    (200, 200, 200, 64), (70, 300, 257, 100), (1, 300, 257, 100)])
def test_flash_attention_kernel_d256(cuda, dtype, s, t_alloc, kv_len,
                                     window):
    q, k, v = _gqa_cache_inputs(2, 16, 4, s, t_alloc, kv_len, 256,
                                seed=s + kv_len, device=cuda, dtype=dtype)
    kw = {"causal": True, "kv_len": kv_len, "live_heads": 8,
          "window": window}
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, **kw)
    assert ops.flash_attention.launches == before + 1
    assert got.shape == q.shape and got.dtype == dtype
    assert not bool(got[:, 8:].any())
    # float32 sums in another order than cuBLAS's, then (bfloat16) the
    # output's one rounding
    assert _k5_excess(got, q, k, v, kw) <= 2e-5


# the windowed prefill at the window / tile alignments chip_smoke.py
# checks at gemma3's shapes (tiles of 64 query rows and 32 keys): a
# multiple of the key tile, not a multiple, below the query tile, one
# key, queries the last 70 of 300 keys; and a window >= kv_len (= S), which
# is the unwindowed call bitwise
@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 64, 256])
@pytest.mark.parametrize("s,kv_len,window", [
    (300, 300, 128), (300, 300, 100), (300, 300, 40), (300, 300, 1),
    (70, 300, 100), (300, 300, 512)])
def test_flash_attention_kernel_window(cuda, d, s, kv_len, window):
    q, k, v = _gqa_cache_inputs(1, 16, 4, s, kv_len + 20, kv_len, d,
                                seed=s + window + d, device=cuda)
    kw = {"causal": True, "kv_len": kv_len, "live_heads": 8}
    got = ops.flash_attention(q, k, v, window=window, **kw)
    assert _k5_excess(got, q, k, v, {**kw, "window": window}) <= 2e-5
    if window >= kv_len:
        assert torch.equal(got, ops.flash_attention(q, k, v, **kw))


@pytest.mark.cuda
def test_gemma3_serving_on_card_matches_cpu(cuda):
    """gemma3-4b reduced to one 17-layer period (window 8): a 12-token
    prompt (past the window) and 8 teacher-forced decode steps, the rings
    wrapping, on the card (K5 in every layer) against the same parameters
    on the CPU: hidden states within 1e-4."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.kernels.plain import fp32_highest
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(get_config("gemma3-4b").reduced(), n_layers=17)
    host = tf.init_params(cfg, seed=0, device="cpu")
    card = tf.to_device(host, cuda)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 20)))
    out = {}
    ops.reset_launches()
    for dev, params in (("cuda", card), ("cpu", host)):
        with torch.inference_mode(), fp32_highest():
            h, caches, _ = tf.forward(params, cfg, toks[:, :12].to(dev),
                                      mode="prefill", cache_len=20)
            hs = [h[:, -1]]
            for t in range(12, 20):
                h, caches, _ = tf.forward(params, cfg,
                                          toks[:, t:t + 1].to(dev),
                                          mode="decode", caches=caches)
                hs.append(h[:, 0])
        out[dev] = torch.stack(hs).cpu()
        if dev == "cuda":
            counts = ops.launch_counts()
    assert caches[0]["l0"]["self"]["k"].shape[2] == cfg.sliding_window
    assert counts["flash_attention"] == 9 * cfg.n_layers
    assert sum(counts.values()) == counts["flash_attention"]
    assert float((out["cuda"] - out["cpu"]).abs().max()) <= 1e-4


def _deepseek_small():
    """Reduced deepseek-v3-671b, one layer, widened to 16 experts top-4
    at deepseek-v3's capacity factor, so that the prefill drops pairs."""
    import dataclasses

    from repro_torch.configs.base import get_config

    cfg = get_config("deepseek-v3-671b").reduced()
    return dataclasses.replace(
        cfg, n_layers=1, d_model=128, n_heads=8, n_kv_heads=8,
        moe=dataclasses.replace(cfg.moe, n_experts=16, top_k=4,
                                capacity_factor=1.25))


@pytest.mark.cuda
def test_mla_and_moe_layers_on_card_match_cpu(cuda):
    """The MLA mixer (a 12-token prefill and 4 decode steps) and the MoE
    FFN (24 tokens a row, some pairs dropped) on the card against the same
    weights on the CPU: routing (expert ids, positions, keep mask) equal,
    outputs within 1e-5 of the largest."""
    from repro_torch.kernels.plain import fp32_highest
    from repro_torch.models import attention, moe
    from repro_torch.models import transformer as tf

    cfg = _deepseek_small()
    gen = torch.Generator().manual_seed(0)
    host = {"mla": attention.init_mla(gen, cfg), "moe": moe.init_moe(gen, cfg)}
    card = tf.to_device(host, cuda)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32))
    out = {}
    ops.reset_launches()
    for key, dev, p in (("card", cuda, card), ("host", "cpu", host)):
        xd = x.to(dev)
        with torch.inference_mode(), fp32_highest():
            y, (ckv, krope) = attention.mla_forward(
                p["mla"], xd[:, :12], cfg, return_latent=True)
            c = attention.fill_mla_cache(attention.init_mla_cache(
                cfg, 2, 16, device=dev), ckv, krope)
            ys = [y]
            for t in range(12, 16):
                y, c = attention.mla_decode(p["mla"], xd[:, t:t + 1], c, cfg)
                ys.append(y)
            logits = xd @ p["moe"]["router"]
            r = moe.route(logits, moe._capacity(24, cfg), cfg.moe.top_k)
            f, metrics = moe.moe_forward(p["moe"], xd, cfg)
        out[key] = ([y.cpu() for y in ys], [t.cpu() for t in r], f.cpu(),
                    float(metrics["moe_drop_frac"]), logits.cpu())
    assert not any(ops.launch_counts().values())
    (ys_c, r_c, f_c, drop_c, lg), (ys_h, r_h, f_h, drop_h, _) = (
        out["card"], out["host"])
    top = torch.topk(lg, cfg.moe.top_k + 1, dim=-1).values
    gap = float((top[..., :-1] - top[..., 1:]).min() / lg.abs().max())
    assert gap > 1e-4, f"a near-tie in the inputs: top-k gap {gap}"
    for a, b in zip(ys_c, ys_h):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    for i in (0, 2, 3):                        # expert, pos, keep
        assert torch.equal(r_c[i], r_h[i])
    assert drop_c == drop_h > 0
    assert float((f_c - f_h).abs().max()) <= 1e-5 * float(f_h.abs().max())


@pytest.mark.cuda
def test_deepseek_serving_on_card_matches_cpu(cuda):
    """Reduced deepseek-v3-671b (two MLA + MoE layers) served on the card
    and on the CPU with the same parameters: the same greedy tokens, the
    same drop fractions, no kernel of the port launched."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf

    cfg = get_config("deepseek-v3-671b").reduced()
    host = tf.init_params(cfg, seed=0, device="cpu")
    card = tf.to_device(host, cuda)
    ops.reset_launches()
    res = {key: serve.serve(cfg, requests=2, prompt_len=16, gen_len=6,
                            device=dev, params=params)
           for key, dev, params in (("card", cuda, card),
                                    ("host", "cpu", host))}
    assert not any(ops.launch_counts().values())
    np.testing.assert_array_equal(res["card"]["tokens"],
                                  res["host"]["tokens"])
    for key in ("moe_drop_frac_prefill", "moe_drop_frac_decode"):
        assert res["card"][key] == res["host"][key] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["whisper-tiny", "internvl2-26b"])
def test_encdec_and_vlm_serving_on_card_matches_cpu(cuda, name):
    """Reduced whisper-tiny (frames through the encoder and cross-attention)
    and reduced internvl2-26b (8 patches prepended) served on the card and
    on the CPU with the same parameters: the same greedy tokens, and K5
    launched once per encoder layer in the prefill and once per self- and
    cross-attention of every decoder layer in the prefill and in every
    decode step, no other kernel."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf

    cfg = get_config(name).reduced()
    host = tf.init_params(cfg, seed=0, device="cpu")
    card = tf.to_device(host, cuda)
    res = {}
    for key, dev, params in (("card", cuda, card), ("host", "cpu", host)):
        ops.reset_launches()
        res[key] = serve.serve(cfg, requests=2, prompt_len=6, gen_len=5,
                               device=dev, params=params)
        if key == "card":
            counts = ops.launch_counts()
    per_step = 2 * cfg.n_layers if cfg.encdec else cfg.n_layers
    enc = cfg.encdec.n_enc_layers if cfg.encdec else 0
    assert counts["flash_attention"] == enc + per_step * 5
    assert sum(counts.values()) == counts["flash_attention"]
    np.testing.assert_array_equal(res["card"]["tokens"],
                                  res["host"]["tokens"])


@pytest.mark.cuda
def test_init_params_draws_on_card(cuda):
    """``init_params`` draws on the card from the card's generator: every
    leaf on the card, the same numbers for the same seed, other numbers
    for another, each weight at the scale of the CPU draw's."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as tf

    cfg = get_config("gemma3-4b").reduced()
    a, b = (tf.init_params(cfg, seed=0, device=cuda) for _ in range(2))
    c = tf.init_params(cfg, seed=1, device=cuda)
    host = tf.init_params(cfg, seed=0, device="cpu")
    for x, y, z, h in zip(*(tf._leaves(p) for p in (a, b, c, host))):
        assert x.device.type == "cuda" and x.shape == h.shape
        assert torch.equal(x, y)
        if h.numel() >= 256 and float(h.std()) > 0:
            assert not torch.equal(x, z)
            ratio = float(x.std()) / float(h.std())
            assert 0.8 <= ratio <= 1.25, (x.shape, ratio)


@pytest.mark.cuda
def test_smollm_prefill_on_card_matches_cpu(cuda):
    """Full-width smollm-135m prefill through K5 on the card against the
    same parameters on the CPU (plain attention): same greedy tokens, last
    hidden state and logits within float32 tolerance."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.train.steps import make_prefill_step

    cfg = get_config("smollm-135m")
    params = tf.init_params(cfg, seed=0, device=cuda)
    host = tf.to_device(params, "cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 128)))
    step = make_prefill_step(cfg, cache_len=136)
    before = ops.flash_attention.launches
    tok_card, caches, _ = step(params, {"tokens": toks.to(cuda)})
    assert ops.flash_attention.launches == before + cfg.n_layers
    tok_host, _, _ = step(host, {"tokens": toks})
    assert torch.equal(tok_card.cpu(), tok_host)
    assert caches[0]["l0"]["self"]["k"].shape == (2, cfg.n_kv_heads, 136, 64)
    with torch.inference_mode():
        h_card, _, _ = tf.forward(params, cfg, toks.to(cuda), mode="prefill")
        h_host, _, _ = tf.forward(host, cfg, toks, mode="prefill")
        lg_card = tf.logits_last(params, cfg, h_card).cpu()
        lg_host = tf.logits_last(host, cfg, h_host)
    assert float((h_card.cpu() - h_host).abs().max()) <= 1e-3
    assert float((lg_card - lg_host).abs().max()) <= 1e-3 * float(
        lg_host.abs().max())


@pytest.mark.cuda
def test_kernel_path_on_card_matches_cpu(cuda):
    """analyze -> factorize -> solve with every kernel on the card gives the
    CPU run's structure bitwise and its factors within float32 tolerance."""
    import repro_torch
    from repro_torch.sparse import bordered_block_diagonal
    from repro_torch.sparse.numeric import generic_values_csr

    a = bordered_block_diagonal(400, block=16, border=16, seed=2)
    values = generic_values_csr(a)
    opts = repro_torch.LUOptions(concurrency=64, backend="kernel",
                                 numeric_backend="kernel")
    ops.reset_launches()
    card = repro_torch.analyze(a, opts, device=cuda)
    f_card = card.factorize(values)
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in ("minmax_relax", "column_fingerprints",
                                       "panel_update_mapped"))
    host = repro_torch.analyze(a, opts, device="cpu")
    f_host = host.factorize(values)
    assert np.array_equal(card.sym.supernodes, host.sym.supernodes)
    assert np.array_equal(card.pattern.rowind, host.pattern.rowind)
    scale = float(f_host.store.flat.abs().max())
    assert float((f_card.store.flat.cpu() - f_host.store.flat).abs().max()
                 ) <= 1e-4 * scale
    b = np.random.default_rng(0).standard_normal(a.n)
    assert f_card.solve(b).residual <= 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["numpy", "kernel"])
def test_sweep_on_card_segment_batch_bitwise(cuda, backend):
    """On the card one mapped launch per level gives the factors of one
    launch per panel bitwise, on both numeric backends, and launches once
    per level with trailing updates."""
    import dataclasses

    import repro_torch
    from repro_torch.sparse import bordered_block_diagonal
    from repro_torch.sparse.numeric import generic_values_csr

    a = bordered_block_diagonal(400, block=16, border=16, seed=2)
    values = generic_values_csr(a)
    plan = repro_torch.analyze(a, repro_torch.LUOptions(
        concurrency=64, numeric_backend=backend), device=cuda)
    before = ops.panel_update_mapped.launches
    batched = plan.factorize(values)
    levels = sum(any(plan.gather_maps[j] is not None for j in lv)
                 for lv in plan.schedule.levels)
    assert ops.panel_update_mapped.launches == before + levels
    single = dataclasses.replace(plan, options=plan.options.replace(
        segment_batch=False)).factorize(values)
    assert torch.equal(batched.store.flat, single.store.flat)


def _rwkv6_inputs(b, l, h, k, seed, device, zero_state=False):
    """r, k, v, w (B, L, H, K), u (H, K), state (B, H, K, K)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, l, h, k)) for _ in range(3)]
    arrs.append(rng.uniform(0.5, 0.999, (b, l, h, k)))
    arrs.append(rng.standard_normal((h, k)) * 0.3)
    arrs.append(np.zeros((b, h, k, k)) if zero_state
                else rng.standard_normal((b, h, k, k)))
    return tuple(torch.as_tensor(a.astype(np.float32), device=device)
                 for a in arrs)


def _mamba_inputs(b, l, di, n, seed, device, zero_state=False):
    """x, dt (B, L, di), b_t, c_t (B, L, N), a (di, N), d (di,), h0."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, l, di)),
            np.abs(rng.standard_normal((b, l, di))) * 0.05,
            rng.standard_normal((b, l, n)), rng.standard_normal((b, l, n)),
            -(np.abs(rng.standard_normal((di, n))) + 0.1),
            rng.standard_normal(di),
            np.zeros((b, di, n)) if zero_state
            else rng.standard_normal((b, di, n))]
    return tuple(torch.as_tensor(a.astype(np.float32), device=device)
                 for a in arrs)


def _scan_err(got, want):
    """max |got - want| over the output and the final state, relative to
    max(1, max |want|): the recurrences sum K or N float32 terms per step
    in another order than the plain version, and the state grows with L."""
    return max(float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
               for g, w in zip(got, want))


# K7 at rwkv6-7b's serve shapes (8 requests, 64 heads of 64; prefill 512,
# decode 1), at the reduced configurations' head size 16 with ragged L, and
# at the edges of its layout: L one past and one short of a 32-step tile,
# one (b, h) block, K = 16 with an odd head count
@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h,k,zero", [
    (8, 512, 64, 64, True), (8, 1, 64, 64, False), (2, 77, 3, 64, False),
    (2, 45, 4, 16, False), (1, 1, 4, 16, True), (2, 33, 3, 64, False),
    (2, 31, 2, 64, True), (1, 40, 1, 64, False), (2, 33, 3, 16, False)])
def test_rwkv6_scan_kernel_matches_plain(cuda, b, l, h, k, zero):
    args = _rwkv6_inputs(b, l, h, k, seed=l + h + k, device=cuda,
                         zero_state=zero)
    state = args[-1].clone()
    before = ops.rwkv6_scan.launches
    got = ops.rwkv6_scan(*args)
    assert ops.rwkv6_scan.launches == before + 1
    want = plain.rwkv6_scan_plain(*args)
    torch.cuda.synchronize()
    assert got[0].shape == (b, l, h, k) and got[1].shape == (b, h, k, k)
    assert torch.equal(args[-1], state)          # the state is not written
    assert _scan_err(got, want) <= 1e-4


# K6 at the jamba period's serve shapes (8 requests, di = 16384, N = 16;
# prefill 512, decode 1), at the reduced configurations' N = 4, and with a
# partial last block of channels (di = 300, 130) at N = 4 and 16
@pytest.mark.cuda
@pytest.mark.parametrize("b,l,di,n,zero", [
    (8, 512, 16384, 16, True), (8, 1, 16384, 16, False),
    (2, 77, 300, 16, False), (2, 45, 128, 4, False), (1, 1, 128, 4, True),
    (2, 17, 300, 4, False), (2, 17, 130, 4, False),
    (3, 33, 130, 16, True)])
def test_mamba_scan_kernel_matches_plain(cuda, b, l, di, n, zero):
    args = _mamba_inputs(b, l, di, n, seed=l + di + n, device=cuda,
                         zero_state=zero)
    state = args[-1].clone()
    before = ops.mamba_scan.launches
    got = ops.mamba_scan(*args)
    assert ops.mamba_scan.launches == before + 1
    want = plain.mamba_scan_plain(*args)
    torch.cuda.synchronize()
    assert got[0].shape == (b, l, di) and got[1].shape == (b, di, n)
    assert torch.equal(args[-1], state)
    assert _scan_err(got, want) <= 1e-4


# one call over L steps against L - 1 steps and then one decode step from
# the state they returned
@pytest.mark.cuda
@pytest.mark.parametrize("kernel,shape", [
    ("rwkv6", (2, 40, 3, 64)), ("rwkv6", (2, 33, 3, 16)),
    ("mamba", (2, 40, 300, 16)), ("mamba", (2, 33, 130, 4))])
def test_scan_kernels_chain_prefill_and_decode(cuda, kernel, shape):
    inputs, scan = ((_rwkv6_inputs, ops.rwkv6_scan) if kernel == "rwkv6"
                    else (_mamba_inputs, ops.mamba_scan))
    args = inputs(*shape, seed=7, device=cuda)
    seqs, fixed = args[:4], args[4:-1]     # (B, L, ...) inputs, the weights
    whole, s_whole = scan(*args)
    head, s_head = scan(*(x[:, :-1].contiguous() for x in seqs), *fixed,
                        args[-1])
    last, s_last = scan(*(x[:, -1:].contiguous() for x in seqs), *fixed,
                        s_head)
    torch.cuda.synchronize()
    assert _scan_err((torch.cat([head, last], 1), s_last),
                     (whole, s_whole)) <= 1e-4


def _unaligned(t):
    """A contiguous copy of t whose data starts 4 bytes past a 16-byte
    boundary (a view into a larger buffer, as a slice of a fused
    projection would be)."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 4
    return out


# the sequences as views that are not 16-byte aligned: the kernels copy
# them 4 bytes at a time
@pytest.mark.cuda
@pytest.mark.parametrize("kernel,shape", [
    ("rwkv6", (2, 37, 3, 64)), ("rwkv6", (2, 20, 3, 16)),
    ("mamba", (2, 37, 300, 16)), ("mamba", (2, 20, 128, 4))])
def test_scan_kernels_take_unaligned_views(cuda, kernel, shape):
    inputs, scan, ref = (
        (_rwkv6_inputs, ops.rwkv6_scan, plain.rwkv6_scan_plain)
        if kernel == "rwkv6" else
        (_mamba_inputs, ops.mamba_scan, plain.mamba_scan_plain))
    args = inputs(*shape, seed=11, device=cuda)
    args = tuple(_unaligned(x) for x in args[:4]) + args[4:]
    got = scan(*args)
    want = ref(*args)
    torch.cuda.synchronize()
    assert _scan_err(got, want) <= 1e-4


@pytest.mark.cuda
def test_scan_kernels_raise_on_what_they_do_not_take(cuda):
    r, k, v, w, u, s = _rwkv6_inputs(1, 4, 2, 32, seed=0, device=cuda)
    with pytest.raises(ValueError, match="built for K"):
        ops.rwkv6_scan(r, k, v, w, u, s)
    r, k, v, w, u, s = _rwkv6_inputs(1, 4, 2, 16, seed=0, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ops.rwkv6_scan(r.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                       w, u, s)
    with pytest.raises(ValueError, match="float32"):
        ops.rwkv6_scan(r.double(), k, v, w, u, s)
    with pytest.raises(ValueError, match="needs u"):
        ops.rwkv6_scan(r, k, v, w, u, s[:1, :1])
    x, dt, bt, ct, a, d, h0 = _mamba_inputs(1, 4, 64, 8, seed=0, device=cuda)
    with pytest.raises(ValueError, match="built for N"):
        ops.mamba_scan(x, dt, bt, ct, a, d, h0)
    x, dt, bt, ct, a, d, h0 = _mamba_inputs(1, 4, 64, 4, seed=0, device=cuda)
    with pytest.raises(ValueError, match="share one device"):
        ops.mamba_scan(x, dt, bt, ct, a.cpu(), d, h0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rwkv6-7b", "jamba-dense"])
def test_ssm_serving_on_card_matches_cpu(cuda, name):
    """Reduced rwkv6-7b and the reduced jamba period with dense FFNs:
    prefill + 3 teacher-forced decode steps on the card (K7 or K6 and K5)
    against the same parameters on the CPU (plain scans): hidden states
    and final recurrent states within 1e-4."""
    from repro_torch.configs.base import dense_period, get_config
    from repro_torch.kernels.plain import fp32_highest
    from repro_torch.models import transformer as tf

    if name == "jamba-dense":
        cfg = dense_period(get_config("jamba-1.5-large-398b")).reduced()
    else:
        cfg = get_config(name).reduced()
    host = tf.init_params(cfg, seed=0, device="cpu")
    card = tf.to_device(host, cuda)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 20)))
    out = {}
    ops.reset_launches()
    for dev, params in (("cuda", card), ("cpu", host)):
        with torch.inference_mode(), fp32_highest():
            h, caches, _ = tf.forward(params, cfg, toks[:, :17].to(dev),
                                      mode="prefill", cache_len=20)
            hs = [h[:, -1]]
            for t in range(17, 20):
                h, caches, _ = tf.forward(params, cfg,
                                          toks[:, t:t + 1].to(dev),
                                          mode="decode", caches=caches)
                hs.append(h[:, 0])
        states = [leaf.cpu() for cg in caches for ce in cg.values()
                  if "state" in ce for key, leaf in ce["state"].items()
                  if key != "idx"]
        out[dev] = (torch.stack(hs).cpu(), states)
        if dev == "cuda":
            counts = ops.launch_counts()
    n_ssm = sum(m != "attn" for m, _ in cfg.pattern) * cfg.n_groups
    kernel = "rwkv6_scan" if name == "rwkv6-7b" else "mamba_scan"
    assert counts[kernel] == 4 * n_ssm
    assert counts["flash_attention"] == 4 * (cfg.n_layers - n_ssm)
    (h_card, s_card), (h_host, s_host) = out["cuda"], out["cpu"]
    assert float((h_card - h_host).abs().max()) <= 1e-4
    for a, b in zip(s_card, s_host):
        assert float((a - b).abs().max()) <= 1e-4 * max(1.0, float(
            b.abs().max()))


# -- the robust tier, blocking and the serving engine on the card ---------

def _tiny_diag_system(n=60, band=4):
    """A system whose first pivot is exactly 0.0 (no elimination update
    reaches column 0): the perturbation's test case."""
    from repro_torch.sparse import banded_random
    from repro_torch.sparse.numeric import generic_values_csr

    a = banded_random(n, band=band, seed=9)
    vals = generic_values_csr(a, seed=9)
    rows = np.repeat(np.arange(n), np.diff(a.indptr))
    vals[np.flatnonzero((rows == 0) & (a.indices == 0))[0]] = 0.0
    return a, vals


@pytest.mark.cuda
def test_perturbation_on_card_matches_cpu(cuda):
    """Tiny-pivot perturbation on the card bumps and counts what the CPU
    port bumps (sequential and per system), the bumped pivot exactly the
    threshold, the factors within float64 roundoff of the CPU's."""
    import repro_torch
    from repro_torch.sparse.numeric import PERTURB_EPS, generic_values_csr

    a, bad = _tiny_diag_system()
    opts = repro_torch.LUOptions(supernode_relax=2, perturb=True)
    got = {}
    for dev in (cuda, "cpu"):
        plan = repro_torch.analyze(a, opts, device=dev)
        f = plan.factorize(bad)
        vb = np.stack([generic_values_csr(a, seed=9), bad,
                       generic_values_csr(a, seed=9)])
        got[str(dev)] = (f, plan.factorize_batch(vb))
    (fc, bc), (fh, bh) = got[str(cuda)], got["cpu"]
    assert fc.perturbed_pivots == fh.perturbed_pivots == 1
    assert bc.perturbed_pivots.tolist() == bh.perturbed_pivots.tolist() \
        == [0, 1, 0]
    thr = PERTURB_EPS * np.abs(bad).max()
    assert float(fc.store.blocks[0][0, 0]) == thr
    assert float(bc.store.blocks[0][1, 0, 0]) == thr
    scale = float(fh.store.flat.abs().max())
    assert float((fc.store.flat.cpu() - fh.store.flat).abs().max()) \
        <= 1e-12 * scale
    assert fc.quality().verdict == fh.quality().verdict == "suspect"


@pytest.mark.cuda
def test_transposed_solve_on_card_matches_cpu(cuda):
    import repro_torch
    from repro_torch.numeric.solve import solve_factored_transposed
    from repro_torch.sparse import banded_random
    from repro_torch.sparse.numeric import generic_values_csr

    a = banded_random(80, band=5, seed=5)
    vals = generic_values_csr(a, seed=5)
    b = np.random.default_rng(5).standard_normal(a.n)
    z = {}
    for dev in (cuda, "cpu"):
        f = repro_torch.analyze(a, repro_torch.LUOptions(supernode_relax=2),
                                device=dev).factorize(vals)
        z[str(dev)] = solve_factored_transposed(
            f.num, torch.as_tensor(b, device=dev)).cpu()
    zc, zh = z[str(cuda)], z["cpu"]
    assert float((zc - zh).abs().max()) <= 1e-12 * float(zh.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("robust", [False, True])
def test_engine_on_card_is_sequential_bitwise(cuda, robust):
    """The serving engine on the card: every request bitwise the
    sequential API on the card, padded slots dropped."""
    import repro_torch
    from repro_torch.serve import SolverEngine
    from repro_torch.sparse import circuit_like, matrices
    from repro_torch.sparse.numeric import generic_values_csr

    if robust:
        a = matrices.shuffled_dominant(160, band=5, seed=2)
        base = matrices.shuffled_dominant_values_csr(a, band=5, seed=2)
        opts = repro_torch.LUOptions(concurrency=64, supernode_relax=2,
                                     pivot="static", perturb=True)
        vals = [base * (1.0 + 0.1 * i) for i in range(5)]
    else:
        a = circuit_like(200, seed=7)
        opts = repro_torch.LUOptions(concurrency=64, supernode_relax=2)
        vals = [generic_values_csr(a, seed=i) for i in range(5)]
    rng = np.random.default_rng(0)
    rhs = [rng.standard_normal(a.n) for _ in range(5)]
    eng = SolverEngine(opts, batch_slots=4, device=cuda)
    rids = [eng.submit(a, v, b) for v, b in zip(vals, rhs)]
    results = eng.flush()
    assert [r.rid for r in results] == rids
    assert eng.stats["batches"] == 2 and eng.stats["padded_slots"] == 3
    plan = repro_torch.analyze(a, opts, values=vals[0], device=cuda)
    for r, v, b in zip(results, vals, rhs):
        seq = plan.factorize(v).solve(b)
        assert r.x.device.type == cuda.type
        assert torch.equal(r.x, seq.x) and r.residual == seq.residuals[-1]


@pytest.mark.cuda
@pytest.mark.parametrize("f32", [False, True])
def test_mapped_update_at_blocked_widths_is_dense_k3(cuda, f32):
    """The mapped K3/K4 at a blocked plan's widest levels (merged panels
    of N and K up to 256, explicit-zero rows): every slice bitwise dense
    K3 on its gathered operands, the whole within tolerance of the plain
    version."""
    import repro_torch
    from repro_torch.sparse import bordered_block_diagonal
    from repro_torch.sparse.numeric import generic_values_csr

    a = bordered_block_diagonal(2000, block=16, border=64, seed=3)
    values = generic_values_csr(a)
    plan = repro_torch.analyze(a, repro_torch.LUOptions(
        concurrency=256, numeric_backend="kernel" if f32 else "numpy"),
        device=cuda)
    blocked = repro_torch.replan(plan, plan.options.replace(blocking=True))
    f = blocked.factorize(values)
    upd = blocked._device_state(cuda)[2]
    tiles = upd.tiles.cpu().numpy()
    recs = tiles[(tiles[:, 6] == 0) & (tiles[:, 7] == 0)]
    assert recs[:, 4].max() > 64 and recs[:, 5].max() > 64
    # the widest level's slices and the deepest one's
    bounds = upd.level_tiles.tolist()
    levels = [(int(tiles[lo:hi, 4].max()), int(tiles[lo:hi, 5].max()), li)
              for li, (lo, hi) in enumerate(zip(bounds, bounds[1:]))
              if hi > lo]
    rng = np.random.default_rng(1)
    flat = f.store.flat.cpu().numpy()
    lmap = upd.lmap.cpu().numpy()
    for li in {max(levels)[2], max(levels, key=lambda t: t[1])[2]}:
        lvl_tiles = tiles[bounds[li]:bounds[li + 1]]
        lrecs = lvl_tiles[(lvl_tiles[:, 6] == 0) & (lvl_tiles[:, 7] == 0)]
        u = rng.standard_normal(int((lrecs[:, 4] * lrecs[:, 5]).sum()))
        got = torch.as_tensor(flat, device=cuda)
        u_d = torch.as_tensor(u, device=cuda)
        tiles_d = torch.as_tensor(lvl_tiles, device=cuda)
        ops.panel_update_mapped(got, u_d, upd.lmap, tiles_d, f32=f32)
        want = torch.as_tensor(flat, device=cuda)
        plain.panel_update_mapped_plain(want, u_d, upd.lmap, tiles_d,
                                        f32=f32)
        eps = 2e-6 if f32 else 1e-14
        tol = (eps * int(lrecs[:, 5].max()) * np.abs(flat).max()
               * np.abs(u).max())
        assert float((got - want).abs().max()) <= tol
        for rec in lrecs:
            acc_off, m, n, k = int(rec[0]), *(int(x) for x in rec[3:6])
            acc, lp, up = (torch.as_tensor(x, device=cuda)
                           for x in _mapped_operands(flat, u, lmap, rec))
            dense = (ops.panel_update(acc.float(), lp.float(),
                                      up.float()).double()
                     if f32 else ops.panel_update(acc, lp, up))
            assert torch.equal(got[acc_off:acc_off + m * n].view(m, n),
                               dense)


def _bbd_400():
    from repro_torch.sparse import bordered_block_diagonal

    return bordered_block_diagonal(400, block=16, border=16, seed=2)


def _structure(plan):
    return (plan.sym.l_counts, plan.sym.u_counts, plan.sym.supernodes,
            plan.pattern.indptr, plan.pattern.rowind,
            plan.sym.fingerprints.hsum, plan.sym.fingerprints.hxor)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["ell", "kernel"])
def test_dynamic_scheduler_stream_slots_on_card(cuda, backend):
    """Four executor slots on one card, each a worker thread with its own
    CUDA stream: the dynamic analyze's structure is bitwise the static
    one's, every chunk completes, and on the kernel backend K1 and K2 run
    on the slots' streams."""
    import repro_torch
    from repro_torch.core.gsofa import prepare_graph
    from repro_torch.runtime.scheduler import DynamicScheduler
    from repro_torch.supernodes import ColumnFingerprints

    a = _bbd_400()
    opts = repro_torch.LUOptions(concurrency=32, backend=backend)
    static = repro_torch.analyze(a, opts, device=cuda)
    dyn = repro_torch.analyze(a, opts.replace(runtime="dynamic"), device=cuda)
    for got, want in zip(_structure(dyn), _structure(static)):
        assert np.array_equal(got, want)
    assert dyn.sym.runtime["completed"] == dyn.sym.runtime["chunks"]
    graph = prepare_graph(a, dense_block=128 if backend == "kernel" else None,
                          device=cuda)
    fp = ColumnFingerprints(n=a.n)
    ops.reset_launches()
    sched = DynamicScheduler(graph, devices=[torch.device("cuda", 0)] * 4,
                             concurrency=32, backend=backend,
                             on_chunk=fp.update)
    out = sched.run()
    counts = ops.launch_counts()
    assert out["completed"] == out["chunks"] == 13
    assert np.array_equal(out["l_counts"], static.sym.l_counts)
    assert np.array_equal(fp.hsum, static.sym.fingerprints.hsum)
    assert counts["column_fingerprints"] == 13
    assert (counts["minmax_relax"] > 0) == (backend == "kernel")


def _cuda_world_rank(rank, world):
    """A rank of a gloo world on the card (every rank on cuda:0 when there
    is one card): the sharded analyze, factors and a solve, on the host."""
    import repro_torch
    from repro_torch.launch.mesh import make_flat_mesh
    from repro_torch.sparse.numeric import generic_values_csr

    a = _bbd_400()
    mesh = make_flat_mesh()
    plan = repro_torch.analyze(a, repro_torch.LUOptions(
        concurrency=32, backend="kernel"), mesh=mesh)
    f = plan.factorize(generic_values_csr(a))
    x = f.solve(np.ones(a.n)).x
    return {"device": str(mesh.device), "plan_device": plan.device,
            "structure": [np.asarray(t) for t in _structure(plan)],
            "flat": f.store.flat.cpu().numpy(), "x": x.cpu().numpy(),
            "dist": plan.sym.dist, "n_devices": plan.n_devices}


@pytest.mark.cuda
def test_gloo_world_of_two_ranks_on_card(cuda, tmp_path):
    """Two ranks over gloo, each on ``cuda:(rank % device_count)``: both
    get the single-process plan's structure, factors and solve bitwise."""
    import repro_torch
    from _torch_world import run_world
    from repro_torch.sparse.numeric import generic_values_csr

    a = _bbd_400()
    plan = repro_torch.analyze(a, repro_torch.LUOptions(
        concurrency=32, backend="kernel"), device=cuda)
    f = plan.factorize(generic_values_csr(a))
    x = f.solve(np.ones(a.n)).x.cpu().numpy()
    outs = run_world(2, _cuda_world_rank, workdir=tmp_path / "world")
    n_cards = torch.cuda.device_count()
    for rank, out in enumerate(outs):
        assert out["device"] == f"cuda:{rank % n_cards}"
        assert out["n_devices"] == 2 and out["dist"]["n_shards"] == 2
        for got, want in zip(out["structure"], _structure(plan)):
            assert np.array_equal(got, want)
        assert np.array_equal(out["flat"], f.store.flat.cpu().numpy())
        assert np.array_equal(out["x"], x)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["numpy", "kernel"])
def test_place_four_on_card_bitwise(cuda, backend):
    """``plan.place(4)`` on the card: factors and solves bitwise the
    unplaced plan's, the mapped K3/K4 still once per level."""
    import repro_torch
    from repro_torch.sparse.numeric import generic_values_csr

    a = _bbd_400()
    values = generic_values_csr(a)
    b = np.random.default_rng(0).standard_normal((a.n, 2))
    plan = repro_torch.analyze(a, repro_torch.LUOptions(
        concurrency=64, numeric_backend=backend), device=cuda)
    base = plan.factorize(values)
    before = ops.panel_update_mapped.launches
    placed = plan.place(4).factorize(values)
    levels = sum(any(plan.gather_maps[j] is not None for j in lv)
                 for lv in plan.schedule.levels)
    assert ops.panel_update_mapped.launches == before + levels
    assert torch.equal(placed.store.flat, base.store.flat)
    assert torch.equal(placed.solve(b).x, base.solve(b).x)
    assert torch.equal(placed.solve(b, batched=False).x,
                       base.solve(b, batched=False).x)


# K5's backward: (B, H, live, Hkv, S, T, D, causal, window) at every head
# size, causal, non-causal with S != T (cross-attention), windowed, grouped
# with padded heads; short query sets over long key ranges, where the dq
# kernel splits its key walk into chunks (K5_BWD_SPLIT: 16 and 64 queries
# over 1500 keys, 48 causal over 1000, and at D = 128 and 256; the dk/dv
# kernel splits its walk over query tiles where the grid is short, as at
# most of the other cases); S and T off the kernels' tiles (16, 32 and 64
# rows).  float32 sums in another order keep dq, dk, dv within 2e-5 of the
# largest gradient of their kind, and a bfloat16 gradient within that
# beyond its one rounding (2^-8 of the value)
K5_BWD_CASES = [
    (2, 4, 3, 3, 70, 70, 16, True, None),
    (2, 6, 6, 2, 37, 101, 16, False, None),
    (1, 4, 4, 2, 130, 130, 64, True, 17),
    (2, 16, 9, 3, 200, 200, 64, True, None),
    (1, 4, 4, 1, 100, 300, 128, False, None),
    (1, 8, 6, 1, 150, 150, 128, True, None),
    (1, 4, 2, 1, 100, 100, 256, True, 40),
    (1, 2, 2, 2, 64, 130, 256, False, None),
    (2, 4, 4, 2, 90, 133, 16, True, 50),
    (1, 6, 5, 5, 77, 93, 128, True, None),
    (1, 4, 4, 2, 16, 1500, 64, False, None),
    (2, 6, 6, 6, 64, 1500, 64, False, None),
    (1, 4, 3, 1, 48, 1000, 64, True, None),
    (1, 4, 4, 2, 40, 600, 128, True, 100),
    (1, 2, 2, 1, 20, 700, 256, False, None),
]
K5_BWD_SPLIT = K5_BWD_CASES[10:]
K5_BWD_TOL = 2e-5


def _k5_bwd_inputs(case, dtype, cuda, seed=0):
    b, h, live, hkv, s, t, d, causal, window = case
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, do = (torch.randn(b, h, s, d, generator=g, device=cuda).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, hkv, t, d, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    return q, k, v, do, {"causal": causal, "live_heads": live,
                         "window": window}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", K5_BWD_CASES)
def test_flash_attention_backward_kernel_matches_plain(cuda, dtype, case):
    q, k, v, do, kw = _k5_bwd_inputs(case, dtype, cuda)
    out0 = ops.flash_attention(q, k, v, **kw)
    out, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    assert torch.equal(out, out0)
    before = ops.flash_attention_backward.launches
    got = ops.flash_attention_backward(q, k, v, out, do, lse, **kw)
    assert ops.flash_attention_backward.launches == before + 1
    want = plain.flash_attention_backward_plain(
        q.float(), k.float(), v.float(), out.float(), do.float(), lse, **kw)
    torch.cuda.synchronize()
    step = 2.0 ** -8 if dtype == torch.bfloat16 else 0.0
    for x, w in zip(got, want):
        assert x.dtype == dtype and x.shape == w.shape
        excess = float(((x.float() - w).abs() - step * w.abs()).max())
        assert excess <= K5_BWD_TOL * float(w.abs().max())
    live = kw["live_heads"]
    if live < q.shape[1]:
        assert not got[0][:, live:].any()


def _chunks(case, dtype, kv):
    """How many chunks the dq (kv = 0) or the dk/dv (kv = 1) kernel splits
    its walk into at ``case``."""
    from repro_torch.kernels import _build

    b, _, live, hkv, s, t, d, _, _ = case
    return _build.launcher("flash_attention_bwd_chunks")(
        b, hkv, live, s, t, d, int(dtype == torch.bfloat16), kv)


@pytest.mark.cuda
@pytest.mark.parametrize("case", K5_BWD_SPLIT)
def test_flash_attention_backward_splits_short_query_sets(cuda, case):
    """The short query sets take the split dq walk (more than one
    chunk)."""
    for dtype in (torch.float32, torch.bfloat16):
        assert _chunks(case, dtype, 0) > 1


@pytest.mark.cuda
def test_flash_attention_backward_walks_whole_where_the_grid_is_full(cuda):
    """dq walks whole at smollm's train shape and dk/dv at whisper's
    encoder; dk/dv splits a few KV heads' many query tiles."""
    smollm = (8, 16, 9, 3, 1024, 1024, 64, True, None)
    encoder = (8, 6, 6, 6, 1500, 1500, 64, False, None)
    assert _chunks(smollm, torch.float32, 0) == 1
    assert _chunks(encoder, torch.float32, 1) == 1
    assert _chunks(K5_BWD_CASES[3], torch.float32, 1) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", [K5_BWD_CASES[3], K5_BWD_SPLIT[1]],
                         ids=["dkdv_split", "dq_split"])
def test_flash_attention_backward_kernel_is_deterministic(cuda, case):
    q, k, v, do, kw = _k5_bwd_inputs(case, torch.float32, cuda)
    out, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    first = ops.flash_attention_backward(q, k, v, out, do, lse, **kw)
    for _ in range(3):
        again = ops.flash_attention_backward(q, k, v, out, do, lse, **kw)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_flash_attention_train_under_checkpoint_on_card(cuda):
    """The autograd Function through a non-reentrant checkpoint: its
    forward runs twice (the recompute), its backward once, and the
    gradients are bitwise the run without the checkpoint."""
    q, k, v, do, kw = _k5_bwd_inputs(K5_BWD_CASES[2], torch.float32, cuda)
    grads = []
    for remat in (False, True):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]

        def f(a, b, c):
            return ops.flash_attention_train(a * 1.5, b, c, **kw)

        fwd = ops.flash_attention.launches
        bwd = ops.flash_attention_backward.launches
        out = (torch.utils.checkpoint.checkpoint(f, *leaves,
                                                 use_reentrant=False)
               if remat else f(*leaves))
        grads.append(torch.autograd.grad(out, leaves, do))
        assert ops.flash_attention.launches - fwd == (2 if remat else 1)
        assert ops.flash_attention_backward.launches - bwd == 1
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["smollm-135m", "whisper-tiny"])
def test_train_step_on_card_matches_cpu(cuda, name):
    """One reduced train step on the card (K5 forward and backward in
    every attention layer) against the same step on the CPU with the same
    parameters: loss and grad_norm within 1e-5 relative, the parameters
    after the update within 2 lr (an Adam step is nearly a sign step)."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.data import make_batch_for
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import AdamWConfig, init_adamw
    from repro_torch.train.steps import make_train_step

    cfg = get_config(name).reduced()
    acfg = AdamWConfig(lr=1e-3, warmup_steps=0)
    host = tf.init_params(cfg, seed=0, device="cpu")
    card = tf.to_device(host, cuda)
    batch = {k: torch.as_tensor(v) for k, v in make_batch_for(
        cfg, ShapeConfig("s", 32, 4, "train")).items()}
    batch = {k: v.long() if v.dtype == torch.int32 else v
             for k, v in batch.items()}
    step = make_train_step(cfg, acfg=acfg, micro_steps=1)
    ops.reset_launches()
    card, _, m_card = step(card, init_adamw(card),
                           {k: v.to(cuda) for k, v in batch.items()})
    counts = ops.launch_counts()
    attn = cfg.n_layers * (2 if cfg.encdec else 1) + (
        cfg.encdec.n_enc_layers if cfg.encdec else 0)
    remat = cfg.n_layers * (2 if cfg.encdec else 1)   # the decoder's groups
    assert counts["flash_attention"] == attn + remat
    assert counts["flash_attention_backward"] == attn
    host, _, m_host = step(host, init_adamw(host), batch)
    for key in ("loss", "grad_norm"):
        assert abs(float(m_card[key]) - float(m_host[key])) <= 1e-5 * abs(
            float(m_host[key]))
    for a, b in zip(tf._leaves(card), tf._leaves(host)):
        assert float((a.cpu() - b).abs().max()) <= 2 * acfg.lr


def _grad_errs(got, want):
    """Each gradient's max |got - want| relative to its largest entry."""
    return [float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            for g, w in zip(got, want)]


def _upstream(shapes, seed, device):
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.standard_normal(sh).astype(np.float32),
                                 device=device) for sh in shapes)


def _bwd_case(kernel, shape, zero, device, seed=0):
    """(backward wrapper, plain backward, its arguments): the scan's
    inputs and normal upstream gradients of its output and final state."""
    if kernel == "rwkv6":
        args = _rwkv6_inputs(*shape, seed=seed, device=device,
                             zero_state=zero)
        ups = _upstream((args[0].shape, args[5].shape), seed + 1, device)
        return (ops.rwkv6_scan_backward, plain.rwkv6_scan_backward_plain,
                args + ups)
    args = _mamba_inputs(*shape, seed=seed, device=device, zero_state=zero)
    ups = _upstream((args[0].shape, args[6].shape), seed + 1, device)
    return (ops.mamba_scan_backward, plain.mamba_scan_backward_plain,
            args + ups)


# K7's and K6's backwards at the train paths' full widths (rwkv6-7b: 8 x
# 512, 64 heads of 64; the jamba period: 8 x 512, di = 16384, N = 16), at
# the reduced configurations' K = 16 and N = 4, one step, one tile, a
# ragged last tile, and a partial block of channels: every gradient within
# 1e-4 of its largest (float32 sums over K, N, di or L in another order;
# ex2.approx in K6), and two calls bitwise equal.  K7's chunks of 16 steps:
# one short of a chunk, one chunk, one past it, ragged last chunks at K = 16
# and 64; K6's blocks of 128 channels (two a thread, c and c + 64): a last
# block with 2 and with 44 live channels at N = 4 and 16
SCAN_BWD_CASES = [
    ("rwkv6", (8, 512, 64, 64), True), ("rwkv6", (2, 45, 4, 16), False),
    ("rwkv6", (2, 33, 3, 64), False), ("rwkv6", (1, 1, 2, 64), False),
    ("rwkv6", (2, 8, 2, 16), True),
    ("rwkv6", (2, 15, 3, 64), False), ("rwkv6", (2, 16, 2, 64), False),
    ("rwkv6", (1, 17, 2, 64), False), ("rwkv6", (2, 17, 3, 16), True),
    ("rwkv6", (2, 40, 2, 64), False), ("rwkv6", (1, 55, 2, 16), False),
    ("mamba", (8, 512, 16384, 16), True), ("mamba", (2, 45, 128, 4), False),
    ("mamba", (2, 77, 300, 16), False), ("mamba", (1, 1, 130, 4), False),
    ("mamba", (3, 8, 256, 16), True),
    ("mamba", (2, 21, 130, 16), False), ("mamba", (2, 19, 300, 4), False),
    ("mamba", (1, 9, 172, 16), True)]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,shape,zero", SCAN_BWD_CASES)
def test_scan_backward_kernels_match_plain(cuda, kernel, shape, zero):
    fn, ref, args = _bwd_case(kernel, shape, zero, cuda, seed=sum(shape))
    before = fn.launches
    got = fn(*args)
    again = fn(*args)
    assert fn.launches == before + 2
    want = ref(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert [g.shape for g in got] == [w.shape for w in want]
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert max(_grad_errs(got, want)) <= 1e-4


# decays that underflow to 0: w = 0 over a stretch of steps (rwkv6) and
# exp(dt A) = 0 (dt A below -104, mamba); the kernels never divide by the
# decay, so the gradients stay finite and match the plain backward.  The
# stretches start mid-chunk (K7's chunks of 16, K6's tiles of 8) and cross
# a chunk's end
@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["rwkv6", "mamba"])
@pytest.mark.parametrize("start,stop", [(10, 20), (21, 35)])
def test_scan_backward_kernels_finite_where_the_decay_underflows(
        cuda, kernel, start, stop):
    shape = (2, 37, 3, 64) if kernel == "rwkv6" else (2, 37, 300, 16)
    fn, ref, args = _bwd_case(kernel, shape, False, cuda, seed=5)
    if kernel == "rwkv6":
        args[3][:, start:stop] = 0.0
    else:
        args[1][:, start:stop] = 200.0
    got, want = fn(*args), ref(*args)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert max(_grad_errs(got, want)) <= 1e-4


@pytest.mark.cuda
def test_scan_backward_kernels_raise_on_what_they_do_not_take(cuda):
    fn, _, args = _bwd_case("rwkv6", (1, 4, 2, 32), False, cuda)
    with pytest.raises(ValueError, match="built for K"):
        fn(*args)
    fn, _, args = _bwd_case("rwkv6", (1, 4, 2, 16), False, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fn(*args[:6], args[6].transpose(1, 2).contiguous().transpose(1, 2),
           args[7])
    fn, _, args = _bwd_case("mamba", (1, 4, 64, 8), False, cuda)
    with pytest.raises(ValueError, match="built for N"):
        fn(*args)
    fn, _, args = _bwd_case("mamba", (1, 4, 64, 4), False, cuda)
    with pytest.raises(ValueError, match="share one device"):
        fn(*args[:7], args[7].cpu(), args[8])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["rwkv6", "mamba"])
def test_scan_train_under_checkpoint_on_card(cuda, kernel):
    """The autograd Function through a non-reentrant checkpoint: its
    forward runs twice, its backward once, and the gradients are bitwise
    the run without the checkpoint."""
    shape = (2, 40, 3, 64) if kernel == "rwkv6" else (2, 40, 300, 16)
    fn, _, args = _bwd_case(kernel, shape, False, cuda)
    train = ops.rwkv6_scan_train if kernel == "rwkv6" else ops.mamba_scan_train
    fwd = ops.rwkv6_scan if kernel == "rwkv6" else ops.mamba_scan
    n_in = len(args) - 2
    grads = []
    for remat in (False, True):
        leaves = [x.clone().requires_grad_(True) for x in args[:n_in]]

        def f(first, *rest):
            out, final = train(first * 1.5, *rest)
            return (out * args[n_in]).sum() + (final * args[n_in + 1]).sum()

        n_fwd, n_bwd = fwd.launches, fn.launches
        loss = (torch.utils.checkpoint.checkpoint(f, *leaves,
                                                  use_reentrant=False)
                if remat else f(*leaves))
        grads.append(torch.autograd.grad(loss, leaves))
        assert fwd.launches - n_fwd == (2 if remat else 1)
        assert fn.launches - n_bwd == 1
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rwkv6-7b", "jamba-1.5-large-398b"])
def test_ssm_train_step_on_card_matches_cpu(cuda, name):
    """One reduced train step on the card (K7 or K6 and K5, forward and
    backward) against the same step on the CPU with the same parameters:
    loss and grad_norm within 1e-5 relative, the parameters after the
    update within 2 lr.  The launches a step follow the remat rule: a
    layer's forward once, once more for its group's checkpoint and once
    more for its own (jamba's layers are checkpointed inside their
    group's), its backward once; with the checkpoints' early stop off, so
    each recompute runs whole."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.data import make_batch_for
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import AdamWConfig, init_adamw
    from repro_torch.train.steps import make_train_step

    cfg = get_config(name).reduced()
    acfg = AdamWConfig(lr=1e-3, warmup_steps=0)
    host = tf.init_params(cfg, seed=0, device="cpu")
    card = tf.to_device(host, cuda)
    batch = {k: torch.as_tensor(v).long() for k, v in make_batch_for(
        cfg, ShapeConfig("s", 32, 4, "train")).items()}
    step = make_train_step(cfg, acfg=acfg, micro_steps=1)
    ops.reset_launches()
    with torch.utils.checkpoint.set_checkpoint_early_stop(False):
        card, _, m_card = step(card, init_adamw(card),
                               {k: v.to(cuda) for k, v in batch.items()})
    counts = ops.launch_counts()
    mixers = [m for m, _ in cfg.pattern] * cfg.n_groups
    runs = 1 + (cfg.remat and cfg.n_groups > 1) + cfg.layer_remat
    for scan, mixer in (("rwkv6_scan", "rwkv6"), ("mamba_scan", "mamba"),
                        ("flash_attention", "attn")):
        layers = mixers.count(mixer)
        assert counts[scan] == runs * layers, (scan, counts)
        bwd = ("flash_attention_backward" if mixer == "attn"
               else f"{scan}_backward")
        assert counts[bwd] == layers, (bwd, counts)
    host, _, m_host = step(host, init_adamw(host), batch)
    for key in ("loss", "grad_norm"):
        assert abs(float(m_card[key]) - float(m_host[key])) <= 1e-5 * abs(
            float(m_host[key]))
    for a, b in zip(tf._leaves(card), tf._leaves(host)):
        assert float((a.cpu() - b).abs().max()) <= 2 * acfg.lr


@pytest.mark.cuda
def test_meta_scratch_sizes_are_the_kernel_librarys(cuda):
    """The ``meta`` branch sizes K7's and K6's backward scratch from
    ``kernels/work.py``'s constants; the built libraries say the same."""
    from repro_torch.kernels import _build, work

    saved = _build.launcher("rwkv6_scan_bwd_saved")
    for length in (1, 15, 16, 17, 512, 4097):
        assert saved(length) == -(-length // work.K7_BWD_CHUNK)
    layout = _build.launcher("mamba_scan_bwd_layout")
    assert (layout(0), layout(1)) == (work.MAMBA_BWD_TILE,
                                      work.MAMBA_BWD_WIDTH)


@pytest.mark.cuda
@pytest.mark.parametrize("name,reduced", [("smollm-135m", True),
                                         ("smollm-135m", False),
                                         ("whisper-tiny", True),
                                         ("whisper-tiny", False),
                                         ("rwkv6-7b", True),
                                         ("jamba-1.5-large-398b", True)])
def test_dry_run_plans_a_train_step_on_card(cuda, name, reduced):
    """``launch/dryrun.py::run_cell`` of a train step (2 x 128 tokens;
    every model reduced, smollm and whisper also at full width) against
    the step on the card: the same launches, and what the planned peak
    adds to the held state within 20 % of what ``max_memory_allocated``
    adds to the memory held before a step (after a first step, which
    makes the libraries' workspaces).  A reduced step's transient is a
    megabyte or two: an op the plan ran through its decomposition where
    the card runs its own kernel (``silu_backward``) once made reduced
    smollm-135m's plan 2.12 MB against 1.75 MB on an H100 80GB HBM3."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.data import make_batch_for
    from repro_torch.launch import dryrun
    from repro_torch.launch.train import device_batch
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import init_adamw
    from repro_torch.train.steps import make_train_step

    cfg = get_config(name)
    cfg = cfg.reduced() if reduced else cfg
    shape = ShapeConfig("s", 128, 2, "train")
    plan = dryrun.run_cell(cfg, shape, capacity_bytes=1e12, micro_steps=1,
                           with_costs=False)
    params = tf.init_params(cfg, device=cuda)
    opt = init_adamw(params)
    batch = device_batch(make_batch_for(cfg, shape), torch.float32, cuda)
    step = make_train_step(cfg, micro_steps=1)
    step(params, opt, batch)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    step(params, opt, batch)
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated() - held
    assert {k: n for k, n in ops.launch_counts().items() if n} == \
        plan["launches"]
    planned = plan["memory"]["peak_bytes"] - plan["memory"]["held_bytes"]
    assert abs(planned / grew - 1) <= 0.2, (planned, grew)
