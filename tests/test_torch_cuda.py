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
    assert all(n > 0 for n in ops.launch_counts().values())
    host = repro_torch.analyze(a, opts, device="cpu")
    f_host = host.factorize(values)
    assert np.array_equal(card.sym.supernodes, host.sym.supernodes)
    assert np.array_equal(card.pattern.rowind, host.pattern.rowind)
    scale = float(f_host.store.flat.abs().max())
    assert float((f_card.store.flat.cpu() - f_host.store.flat).abs().max()
                 ) <= 1e-4 * scale
    b = np.random.default_rng(0).standard_normal(a.n)
    assert f_card.solve(b).residual <= 1e-10
