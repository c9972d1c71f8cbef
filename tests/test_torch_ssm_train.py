"""repro_torch's SSM training path against repro's, on the CPU: the plain
backwards of the rwkv6 scan (K7) and the selective scan (K6) against
``jax.vjp`` of the reference's recurrences (``repro.models.rwkv6.
_recurrence`` and ``repro.models.mamba._selective_scan``), from a zero and
a non-zero state with a non-zero final-state cotangent; the autograd
Functions ``Rwkv6Scan`` and ``MambaScan`` against ``torch.autograd``
through the plain forwards; decays that underflow to 0; the mixers' train
mode against ``jax.vjp`` of the reference's mixers; and a float64 model of
the chunked form of K7's backward kernel (``csrc/rwkv6_scan_bwd.cu``)
against both the plain backward and the reference's vjp.  The CUDA
kernels themselves run only on a card (``test_torch_cuda.py``).

Tolerance: each gradient within 1e-5 of its largest entry (float32 sums
over K, N or di in another order than XLA's)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import mamba as jmamba
from repro.models import rwkv6 as jrwkv6
from repro_torch.configs.base import get_config
from repro_torch.kernels import ops, plain
from repro_torch.models import mamba, rwkv6
from repro_torch.models.layers import _normal

# tiny shapes, several pytest workers: one intra-op thread each
torch.set_num_threads(1)

TOL = 1e-5
RWKV6_NAMES = ("dr", "dk", "dv", "dw", "du", "dstate")
MAMBA_NAMES = ("dx", "ddt", "db", "dc", "da", "dd_skip", "dh0")


def _rwkv_inputs(b, l, h, k, seed, *, zero_state):
    """r, k, v, w (B, L, H, K), u (H, K), state (B, H, K, K), and the
    cotangents do (B, L, H, K), ds (B, H, K, K), as float32 numpy."""
    rng = np.random.default_rng(seed)
    r, kk, v = (rng.standard_normal((b, l, h, k)) for _ in range(3))
    w = rng.uniform(0.5, 0.999, (b, l, h, k))
    u = rng.standard_normal((h, k)) * 0.3
    s = (np.zeros((b, h, k, k)) if zero_state
         else rng.standard_normal((b, h, k, k)))
    do = rng.standard_normal((b, l, h, k))
    ds = rng.standard_normal((b, h, k, k))
    return [a.astype(np.float32) for a in (r, kk, v, w, u, s, do, ds)]


def _mamba_inputs(b, l, di, n, seed, *, zero_state):
    """x, dt (B, L, di), b_t, c_t (B, L, N), a (di, N) < 0, d (di,), h0
    (B, di, N), and the cotangents dy (B, L, di), dh (B, di, N)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, l, di)),
            np.abs(rng.standard_normal((b, l, di))) * 0.5,
            rng.standard_normal((b, l, n)), rng.standard_normal((b, l, n)),
            -(np.abs(rng.standard_normal((di, n))) + 0.1),
            rng.standard_normal(di),
            np.zeros((b, di, n)) if zero_state
            else rng.standard_normal((b, di, n)),
            rng.standard_normal((b, l, di)),
            rng.standard_normal((b, di, n))]
    return [a.astype(np.float32) for a in arrs]


def _t(arrs):
    return [torch.as_tensor(a.copy()) for a in arrs]


def _assert_grads(got, want, names, tol=TOL):
    """Each gradient within ``tol`` of its largest entry, finite, of the
    reference's shape."""
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        g = g.detach().numpy()
        assert g.shape == w.shape, name
        assert np.isfinite(g).all(), name
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= tol * scale, (name, err, scale)


def _rwkv_vjp(arrs):
    out, vjp = jax.vjp(jrwkv6._recurrence, *map(jnp.asarray, arrs[:6]))
    return out, vjp((jnp.asarray(arrs[6]), jnp.asarray(arrs[7])))


def _mamba_vjp(arrs):
    out, vjp = jax.vjp(jmamba._selective_scan, *map(jnp.asarray, arrs[:7]))
    return out, vjp((jnp.asarray(arrs[7]), jnp.asarray(arrs[8])))


# the reduced configurations' head size 16 and rwkv6-7b's 64, one step,
# a ragged length, one (b, h)
@pytest.mark.parametrize("b,l,h,k", [(2, 9, 3, 16), (1, 1, 2, 16),
                                     (2, 16, 2, 64), (1, 13, 1, 4)])
@pytest.mark.parametrize("zero_state", [True, False])
def test_rwkv6_backward_plain_matches_jax_vjp(b, l, h, k, zero_state):
    arrs = _rwkv_inputs(b, l, h, k, seed=b + l + h + k,
                        zero_state=zero_state)
    _, want = _rwkv_vjp(arrs)
    got = plain.rwkv6_scan_backward_plain(*_t(arrs))
    _assert_grads(got, want, RWKV6_NAMES)


# the reduced configurations' N = 4, jamba's 16, one step, a ragged length
@pytest.mark.parametrize("b,l,di,n", [(2, 9, 24, 4), (1, 1, 8, 4),
                                      (2, 16, 32, 16), (1, 13, 5, 3)])
@pytest.mark.parametrize("zero_state", [True, False])
def test_mamba_backward_plain_matches_jax_vjp(b, l, di, n, zero_state):
    arrs = _mamba_inputs(b, l, di, n, seed=b + l + di + n,
                         zero_state=zero_state)
    _, want = _mamba_vjp(arrs)
    got = plain.mamba_scan_backward_plain(*_t(arrs))
    _assert_grads(got, want, MAMBA_NAMES)


def _autograd_pair(scan_train, scan_plain, arrs, n_in):
    """The gradients of sum(out * d_out) + sum(final * d_final) through
    the Function (``scan_train``) and through ``torch.autograd`` of the
    plain forward."""
    grads = []
    for scan in (scan_train, scan_plain):
        leaves = [x.requires_grad_(True) for x in _t(arrs[:n_in])]
        out, final = scan(*leaves)
        d_out, d_final = _t(arrs[n_in:])
        loss = (out * d_out).sum() + (final * d_final).sum()
        grads.append(torch.autograd.grad(loss, leaves))
    return grads


@pytest.mark.parametrize("zero_state", [True, False])
def test_rwkv6_function_matches_autograd_of_plain(zero_state):
    arrs = _rwkv_inputs(2, 11, 2, 16, seed=5, zero_state=zero_state)
    got, want = _autograd_pair(ops.rwkv6_scan_train, plain.rwkv6_scan_plain,
                               arrs, 6)
    _assert_grads(got, [w.numpy() for w in want], RWKV6_NAMES)


@pytest.mark.parametrize("zero_state", [True, False])
def test_mamba_function_matches_autograd_of_plain(zero_state):
    arrs = _mamba_inputs(2, 11, 20, 4, seed=5, zero_state=zero_state)
    got, want = _autograd_pair(ops.mamba_scan_train, plain.mamba_scan_plain,
                               arrs, 7)
    _assert_grads(got, [w.numpy() for w in want], MAMBA_NAMES)


@pytest.mark.parametrize("kernel", ["rwkv6", "mamba"])
def test_unused_final_state_gets_a_zero_gradient(kernel):
    """Only the output reaches the loss: the Function's gradients equal the
    backward with a zero final-state cotangent."""
    if kernel == "rwkv6":
        arrs = _rwkv_inputs(2, 7, 2, 16, seed=3, zero_state=False)
        fn, bwd, n_in = (ops.rwkv6_scan_train, ops.rwkv6_scan_backward, 6)
    else:
        arrs = _mamba_inputs(2, 7, 12, 4, seed=3, zero_state=False)
        fn, bwd, n_in = (ops.mamba_scan_train, ops.mamba_scan_backward, 7)
    leaves = [x.requires_grad_(True) for x in _t(arrs[:n_in])]
    out, _ = fn(*leaves)
    d_out = _t(arrs[n_in:])[0]
    got = torch.autograd.grad((out * d_out).sum(), leaves)
    zero = torch.zeros_like(leaves[-1])
    want = bwd(*(x.detach() for x in leaves), d_out, zero)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# decays that underflow: w exactly 0, subnormal and 1e-30 (w_t = exp(
# -exp(w_log)) is 0 in float32 from w_log ~ 4.5), and exp(dt A) of dt A
# below -104 (0 in float32): the backwards stay finite and match jax
@pytest.mark.parametrize("w_fill", [0.0, 1e-40, 1e-30])
def test_rwkv6_backward_is_finite_where_w_underflows(w_fill):
    arrs = _rwkv_inputs(2, 10, 2, 16, seed=9, zero_state=False)
    arrs[3][:, 2:6] = np.float32(w_fill)        # a stretch of dead decay
    arrs[3][1, :, 1, :3] = np.float32(w_fill)   # and whole keys of a head
    _, want = _rwkv_vjp(arrs)
    got = plain.rwkv6_scan_backward_plain(*_t(arrs))
    _assert_grads(got, want, RWKV6_NAMES)
    got_fn, _ = _autograd_pair(ops.rwkv6_scan_train, plain.rwkv6_scan_plain,
                               arrs, 6)
    _assert_grads(got_fn, want, RWKV6_NAMES)


@pytest.mark.parametrize("dt_big", [200.0, 1e4])
def test_mamba_backward_is_finite_where_the_decay_underflows(dt_big):
    arrs = _mamba_inputs(2, 10, 12, 4, seed=9, zero_state=False)
    arrs[1][:, 3:5] = np.float32(dt_big)        # exp(dt A) = 0 there
    arrs[4][:6] = np.float32(-1e3)              # and A very negative
    _, want = _mamba_vjp(arrs)
    for g in want:
        assert np.isfinite(np.asarray(g)).all()
    got = plain.mamba_scan_backward_plain(*_t(arrs))
    _assert_grads(got, want, MAMBA_NAMES)


def test_scans_of_length_zero_pass_the_state_gradient_through():
    arrs = _rwkv_inputs(2, 0, 2, 16, seed=1, zero_state=False)
    got = ops.rwkv6_scan_backward(*_t(arrs))
    assert torch.equal(got[5], torch.as_tensor(arrs[7]))
    assert got[4].abs().max() == 0 and got[0].shape == (2, 0, 2, 16)
    arrs = _mamba_inputs(2, 0, 12, 4, seed=1, zero_state=False)
    got = ops.mamba_scan_backward(*_t(arrs))
    assert torch.equal(got[6], torch.as_tensor(arrs[8]))
    assert got[4].abs().max() == 0 and got[5].abs().max() == 0


def test_backwards_reject_bad_shapes():
    arrs = _t(_rwkv_inputs(1, 4, 2, 16, seed=0, zero_state=True))
    with pytest.raises(ValueError, match="do"):
        ops.rwkv6_scan_backward(*arrs[:6], arrs[6][:, :3], arrs[7])
    with pytest.raises(ValueError, match="ds_final"):
        ops.rwkv6_scan_backward(*arrs[:7], arrs[7][..., :8])
    with pytest.raises(ValueError, match="needs u"):
        ops.rwkv6_scan_backward(*arrs[:4], arrs[4][:1], *arrs[5:])
    arrs = _t(_mamba_inputs(1, 4, 8, 4, seed=0, zero_state=True))
    with pytest.raises(ValueError, match="dy"):
        ops.mamba_scan_backward(*arrs[:7], arrs[7][..., :4], arrs[8])
    with pytest.raises(ValueError, match="dh_final"):
        ops.mamba_scan_backward(*arrs[:8], arrs[8][:, :4])
    with pytest.raises(ValueError, match="need a"):
        ops.mamba_scan_backward(*arrs[:4], arrs[4][:4], *arrs[5:])


def test_cpu_backwards_count_no_kernel_launch():
    ops.reset_launches()
    ops.rwkv6_scan_backward(*_t(_rwkv_inputs(1, 3, 2, 16, seed=0,
                                             zero_state=True)))
    ops.mamba_scan_backward(*_t(_mamba_inputs(1, 3, 8, 4, seed=0,
                                              zero_state=True)))
    assert not any(ops.launch_counts().values())


def _mixer_params(mixer, cfg, seed):
    """The port's mixer parameters drawn from a CPU generator, with the
    decay and mix parameters moved off their constant init so every
    gradient leaf is exercised; and the same as the reference's tree."""
    gen = torch.Generator().manual_seed(seed)
    init = rwkv6.init_rwkv6 if mixer == "rwkv6" else mamba.init_mamba
    params = init(gen, cfg)
    for name in ("w_base", "dt_bias", "conv_b", "d_skip"):
        if name in params:
            params[name] = params[name] + _normal(
                gen, params[name].shape, 0.1, torch.float32)
    ref = jax.tree.map(lambda t: jnp.asarray(t.numpy().copy()), params)
    return params, ref


def _leaf_items(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_items(v, f"{path}/{k}")
    else:
        yield path, tree


# the mixers' train mode (the Function inside the whole mixer: the token
# shift and decay LoRA of rwkv6, the conv, dt, B and C projections of
# mamba) against jax.vjp of the reference's mixer, from its zero state
@pytest.mark.parametrize("mixer", ["rwkv6", "mamba"])
def test_mixer_train_mode_gradient_matches_reference(mixer):
    name = "rwkv6-7b" if mixer == "rwkv6" else "jamba-1.5-large-398b"
    jcfg, cfg = jget_config(name).reduced(), get_config(name).reduced()
    params, ref = _mixer_params(mixer, cfg, seed=4)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    dout = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    fwd = rwkv6.rwkv6_forward if mixer == "rwkv6" else mamba.mamba_forward
    jfwd = (jrwkv6.rwkv6_forward if mixer == "rwkv6"
            else jmamba.mamba_forward)

    out_ref, vjp = jax.vjp(lambda p, xx: jfwd(p, xx, jcfg)[0], ref,
                           jnp.asarray(x))
    g_ref, gx_ref = vjp(jnp.asarray(dout))
    leaves = {path: t.requires_grad_(True)
              for path, t in _leaf_items(params)}
    xt = torch.as_tensor(x).requires_grad_(True)
    ops.reset_launches()
    out, _ = fwd(params, xt, cfg, train=True)
    grads = torch.autograd.grad((out * torch.as_tensor(dout)).sum(),
                                [*leaves.values(), xt])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref),
                               rtol=1e-5, atol=1e-5)
    want = dict(_leaf_items(g_ref))
    for (path, _), g in zip(leaves.items(), grads[:-1]):
        _assert_grads([g], [want[path]], [path], tol=1e-4)
    _assert_grads([grads[-1]], [gx_ref], ["x"], tol=1e-4)
    assert not any(ops.launch_counts().values())


def _rwkv6_backward_chunked(r, k, v, w, u, state, do, ds, chunk):
    """K7's backward in the chunked form of ``csrc/rwkv6_scan_bwd.cu``, in
    float64: a forward sweep saves the state before each chunk of
    ``chunk`` steps (S <- P(0, C) S + Kt^T V); the walk back takes each
    chunk's products Y = S_c DO^T, X = G_e V^T, M = V DO^T, the decay
    products P(a, b) = prod_{a <= tau < b} w_tau formed by multiplication
    only, the per-key recurrences W_t[s] = G_t v_s and Q_t = rowsum(G_t *
    S_c), and A[t][s] = sum_i r_s[i] P(t+1, s)[i] k_t[i].  A ragged last
    chunk is padded with steps that change nothing (r, k, v, do 0, w 1)."""
    r, k, v, w, u, state, do, ds = (x.double() for x in (
        r, k, v, w, u, state, do, ds))
    b, l, h, kk = r.shape
    nc = -(-l // chunk)
    pad = nc * chunk - l

    def padded(x, fill):
        x = x.transpose(1, 2)                     # (B, H, L, K)
        ext = torch.full((b, h, pad, kk), fill, dtype=x.dtype)
        return torch.cat([x, ext], 2).reshape(b, h, nc, chunk, kk)

    rr, kc, vc, dc = (padded(x, 0.0) for x in (r, k, v, do))
    wc = padded(w, 1.0)
    cols = torch.arange(chunk)

    def prefix(wch):
        """P(0, t) for t = 0 .. C: (B, H, C + 1, K)."""
        out = [torch.ones_like(wch[..., 0, :])]
        for t in range(chunk):
            out.append(out[-1] * wch[..., t, :])
        return torch.stack(out, -2)

    def suffix(wch):
        """P(t+1, C) for t = 0 .. C - 1."""
        out = [torch.ones_like(wch[..., 0, :])]
        for t in range(chunk - 1, 0, -1):
            out.append(out[-1] * wch[..., t, :])
        return torch.stack(out[::-1], -2)

    def kap(kch, wch):
        """kap[s][t] = P(t+1, s) k_t for t < s, else 0: (B, H, C, C, K)."""
        out = torch.zeros(kch.shape[:-2] + (chunk, chunk, kk),
                          dtype=kch.dtype)
        for t in range(chunk):
            run = kch[..., t, :]
            for s in range(t + 1, chunk):
                out[..., s, t, :] = run
                run = run * wch[..., s, :]
        return out

    saved, s_cur = [], state
    for c in range(nc):
        saved.append(s_cur)
        kt = suffix(wc[:, :, c])[..., :, :] * kc[:, :, c]
        s_cur = (prefix(wc[:, :, c])[..., chunk, :, None] * s_cur
                 + kt.transpose(-1, -2) @ vc[:, :, c])
    g = ds
    grads = torch.zeros((4, b, h, nc, chunk, kk), dtype=r.dtype)
    du = torch.zeros((b, h, kk), dtype=r.dtype)
    for c in reversed(range(nc)):
        rc_, kc_, vc_, wc_, dc_ = (x[:, :, c] for x in (rr, kc, vc, wc, dc))
        sc = saved[c]
        pre = prefix(wc_)
        kp = kap(kc_, wc_)
        y = sc @ dc_.transpose(-1, -2)              # (B, H, K, C)
        x = g @ vc_.transpose(-1, -2)
        m = vc_ @ dc_.transpose(-1, -2)             # m[s][t] = v_s . do_t
        diag = m.diagonal(dim1=-2, dim2=-1)         # v_t . do_t
        # dr_t = P(0, t) Y[., t] + sum_{s<t} kap_t[s] M[s][t]
        dr = (pre[..., :chunk, :] * y.transpose(-1, -2)
              + torch.einsum("bhtsi,bhst->bhti", kp, m)
              + u[None, :, None] * kc_ * diag[..., None])
        # the W and Q recurrences back through the chunk
        wv = x.clone()                              # W_{C-1}[i][s]
        qv = (g * sc).sum(-1)
        dk = torch.zeros_like(dr)
        dw = torch.zeros_like(dr)
        for t in reversed(range(chunk)):
            dk[..., t, :] = wv[..., t] + u * rc_[..., t, :] * diag[..., t,
                                                                   None]
            dw[..., t, :] = (pre[..., t, :] * qv
                             + (kp[..., t, :, :].transpose(-1, -2)
                                * wv * (cols < t)).sum(-1))
            wv = (wc_[..., t, :, None] * wv
                  + rc_[..., t, :, None] * m[..., :, t][..., None, :]
                  * (cols < t))
            qv = wc_[..., t, :] * qv + rc_[..., t, :] * y[..., t]
        # A[t][s] = sum_i kap_s[t][i] r_s[i] (t < s), u k_t r_t (t = s)
        a = torch.einsum("bhsti,bhsi->bhts", kp, rc_)
        a = a + torch.diag_embed((u[None, :, None] * kc_ * rc_).sum(-1))
        kt = suffix(wc_) * kc_
        dv = kt @ g + a @ dc_
        du += (rc_ * kc_ * diag[..., None]).sum(-2)
        g = (pre[..., chunk, :, None] * g
             + (pre[..., :chunk, :] * rc_).transpose(-1, -2) @ dc_)
        for n, d in enumerate((dr, dk, dv, dw)):
            grads[n, :, :, c] = d
    outs = [grads[n].reshape(b, h, nc * chunk, kk)[:, :, :l].transpose(1, 2)
            for n in range(4)]
    return (*outs, du.sum(0), g)


# the chunked algorithm of K7's backward kernel against the plain backward
# and the reference's vjp: chunks of 1, 4 and 16, a length below, equal to
# and one past a chunk, K = 4, 16 and 64, from a zero and a non-zero state
@pytest.mark.parametrize("chunk", [1, 4, 16])
@pytest.mark.parametrize("b,l,h,k", [(1, 3, 2, 4), (2, 16, 1, 16),
                                     (1, 17, 1, 64), (2, 4, 2, 16)])
@pytest.mark.parametrize("zero_state", [True, False])
def test_rwkv6_chunked_backward_matches_plain_and_jax(chunk, b, l, h, k,
                                                      zero_state):
    arrs = _rwkv_inputs(b, l, h, k, seed=b + l + h + k + chunk,
                        zero_state=zero_state)
    got = _rwkv6_backward_chunked(*_t(arrs), chunk=chunk)
    _assert_grads([x.float() for x in got],
                  plain.rwkv6_scan_backward_plain(*_t(arrs)), RWKV6_NAMES)
    _, want = _rwkv_vjp(arrs)
    _assert_grads([x.float() for x in got], want, RWKV6_NAMES)


# w = 0 over a stretch that crosses a chunk boundary (and whole keys of a
# head): the chunked form's products only shrink to 0, nothing divides
@pytest.mark.parametrize("chunk", [4, 16])
@pytest.mark.parametrize("w_fill", [0.0, 1e-40])
def test_rwkv6_chunked_backward_where_w_underflows(chunk, w_fill):
    arrs = _rwkv_inputs(2, 37, 2, 16, seed=11, zero_state=False)
    arrs[3][:, chunk - 2:chunk + 3] = np.float32(w_fill)
    arrs[3][1, :, 1, :3] = np.float32(w_fill)
    got = [x.float() for x in _rwkv6_backward_chunked(*_t(arrs),
                                                      chunk=chunk)]
    _, want = _rwkv_vjp(arrs)
    _assert_grads(got, want, RWKV6_NAMES)
    _assert_grads(got, plain.rwkv6_scan_backward_plain(*_t(arrs)),
                  RWKV6_NAMES)
