"""repro_torch's SSM serving path against repro's, on the CPU: the plain
rwkv6 scan (K7) and selective scan (K6) against the Pallas kernels
(interpret mode), their oracles and the models' own recurrences, final
states included; the rwkv6 and mamba mixers in prefill and decode; and
prefill + greedy decode of reduced rwkv6-7b and of the reduced jamba period
with dense FFNs, with the reference's parameters carried over by
``params_from_jax``.  The CUDA kernels themselves run only on a card
(``test_torch_cuda.py``).

Tolerances: 1e-4 for the scans, as ``tests/test_ssm_kernels.py`` holds the
Pallas kernels to their oracles (float32 sums over K or N in another
order); 1e-4 for hidden states after the whole reduced model, as
``test_torch_lm.py`` (float32 products summed in another order, through
every layer)."""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.kernels import ops as jops
from repro.models import mamba as jmamba
from repro.models import rwkv6 as jrwkv6
from repro.models import transformer as jtf
from repro_torch.configs.base import dense_period, get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import mamba, rwkv6
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_jax
from repro_torch.train.steps import make_decode_step, make_prefill_step

# tiny shapes, several pytest workers: one intra-op thread each keeps
# torch's pool from oversubscribing the CPU
torch.set_num_threads(1)

TOL = 1e-4


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def jamba_dense(get):
    """jamba-1.5-large-398b cut by ``dense_period`` (the serve
    configuration's cut), reduced."""
    return dense_period(get("jamba-1.5-large-398b")).reduced()


def _configs(name):
    if name == "jamba-dense":
        return jamba_dense(jget_config), jamba_dense(get_config)
    return jget_config(name).reduced(), get_config(name).reduced()


def _params(jcfg):
    jparams = jtf.init_params(jax.random.key(0), jcfg, jnp.float32)
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


def _rwkv_inputs(b, l, h, k, seed):
    """r, k, v, w (B, L, H, K), u (H, K), a state (B, H, K, K)."""
    rng = np.random.default_rng(seed)
    r, kk, v = (rng.standard_normal((b, l, h, k)).astype(np.float32)
                for _ in range(3))
    w = rng.uniform(0.5, 0.999, (b, l, h, k)).astype(np.float32)
    u = (rng.standard_normal((h, k)) * 0.3).astype(np.float32)
    s = rng.standard_normal((b, h, k, k)).astype(np.float32)
    return r, kk, v, w, u, s


def _mamba_inputs(b, l, di, n, seed):
    """x, dt (B, L, di), b_t, c_t (B, L, N), a (di, N), d (di,), a state
    (B, di, N)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, di)).astype(np.float32)
    dt = (np.abs(rng.standard_normal((b, l, di))) * 0.05).astype(np.float32)
    bt, ct = (rng.standard_normal((b, l, n)).astype(np.float32)
              for _ in range(2))
    a = -(np.abs(rng.standard_normal((di, n))) + 0.1).astype(np.float32)
    d = rng.standard_normal(di).astype(np.float32)
    h0 = rng.standard_normal((b, di, n)).astype(np.float32)
    return x, dt, bt, ct, a, d, h0


# ---------------------------------------------------------------------------
# the plain scans (what the wrappers run for CPU tensors)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,l,h,k", [(1, 16, 1, 16), (2, 40, 3, 16),
                                     (1, 33, 2, 64)])
def test_rwkv6_scan_plain_matches_pallas_from_zero(b, l, h, k):
    """From a zero state against the Pallas kernel (interpret mode, heads
    folded into the batch, L = 40 and 33 not a multiple of its 32-step
    block) and its oracle."""
    r, kk, v, w, u, _ = _rwkv_inputs(b, l, h, k, seed=l + h + k)

    def fold(x):                               # (B, L, H, K) -> (BH, L, K)
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, l, k))

    ju = jnp.asarray(np.tile(u, (b, 1)))
    kernel = jops.rwkv6_scan(fold(r), fold(kk), fold(v), fold(w), ju,
                             block_t=32)
    ref = jops.rwkv6_scan_ref(fold(r), fold(kk), fold(v), fold(w), ju)
    o, s = ops.rwkv6_scan(_t(r), _t(kk), _t(v), _t(w), _t(u),
                          torch.zeros((b, h, k, k)))
    assert o.shape == (b, l, h, k) and s.shape == (b, h, k, k)
    got = o.numpy().transpose(0, 2, 1, 3).reshape(b * h, l, k)
    _close(got, kernel)
    _close(got, ref)


@pytest.mark.parametrize("b,l,di,n", [(1, 16, 64, 4), (2, 37, 96, 16),
                                      (3, 20, 128, 8)])
def test_mamba_scan_plain_matches_pallas_from_zero(b, l, di, n):
    """From a zero state against the Pallas kernel (interpret mode; L = 37
    and 20 not a multiple of its 16-step block) and its oracle."""
    x, dt, bt, ct, a, d, _ = _mamba_inputs(b, l, di, n, seed=l + di + n)
    jargs = tuple(jnp.asarray(t) for t in (x, dt, bt, ct, a, d))
    kernel = jops.mamba_scan(*jargs, block_d=32, block_t=16)
    ref = jops.mamba_scan_ref(*jargs)
    y, h = ops.mamba_scan(_t(x), _t(dt), _t(bt), _t(ct), _t(a), _t(d),
                          torch.zeros((b, di, n)))
    assert y.shape == (b, l, di) and h.shape == (b, di, n)
    _close(y.numpy(), kernel)
    _close(y.numpy(), ref)


@pytest.mark.parametrize("l", [1, 24])
def test_rwkv6_scan_plain_matches_model_recurrence(l):
    """From a non-zero state against ``repro.models.rwkv6._recurrence``:
    output and final state; the input state is not written."""
    r, kk, v, w, u, s0 = _rwkv_inputs(2, l, 3, 16, seed=l)
    want_o, want_s = jrwkv6._recurrence(*(jnp.asarray(t) for t in
                                          (r, kk, v, w, u, s0)))
    state = _t(s0)
    o, s = ops.rwkv6_scan(_t(r), _t(kk), _t(v), _t(w), _t(u), state)
    _close(o.numpy(), want_o)
    _close(s.numpy(), want_s)
    assert np.array_equal(state.numpy(), s0)


@pytest.mark.parametrize("l", [1, 24])
def test_mamba_scan_plain_matches_model_scan(l):
    """From a non-zero state against ``repro.models.mamba._selective_scan``:
    output and final state; the input state is not written."""
    x, dt, bt, ct, a, d, h0 = _mamba_inputs(2, l, 32, 4, seed=l)
    want_y, want_h = jmamba._selective_scan(*(jnp.asarray(t) for t in
                                              (x, dt, bt, ct, a, d, h0)))
    state = _t(h0)
    y, h = ops.mamba_scan(_t(x), _t(dt), _t(bt), _t(ct), _t(a), _t(d), state)
    _close(y.numpy(), want_y)
    _close(h.numpy(), want_h)
    assert np.array_equal(state.numpy(), h0)


def test_scans_of_length_zero_return_the_state():
    r, kk, v, w, u, s0 = (_t(x) for x in _rwkv_inputs(1, 0, 2, 16, seed=0))
    o, s = ops.rwkv6_scan(r, kk, v, w, u, s0)
    assert o.shape == (1, 0, 2, 16) and torch.equal(s, s0) and s is not s0
    x, dt, bt, ct, a, d, h0 = (_t(t) for t in _mamba_inputs(1, 0, 8, 4, 0))
    y, h = ops.mamba_scan(x, dt, bt, ct, a, d, h0)
    assert y.shape == (1, 0, 8) and torch.equal(h, h0) and h is not h0


def test_scans_reject_bad_shapes():
    r, kk, v, w, u, s0 = (_t(x) for x in _rwkv_inputs(1, 4, 2, 16, seed=0))
    with pytest.raises(ValueError, match="share one shape"):
        ops.rwkv6_scan(r, kk[:, :3], v, w, u, s0)
    with pytest.raises(ValueError, match="needs u"):
        ops.rwkv6_scan(r, kk, v, w, u[:1], s0)
    with pytest.raises(ValueError, match="needs u"):
        ops.rwkv6_scan(r, kk, v, w, u, s0[:, :, :8])
    x, dt, bt, ct, a, d, h0 = (_t(t) for t in _mamba_inputs(1, 4, 8, 4, 0))
    with pytest.raises(ValueError, match="share one shape"):
        ops.mamba_scan(x, dt, bt, ct[..., :3], a, d, h0)
    with pytest.raises(ValueError, match="need a"):
        ops.mamba_scan(x, dt, bt, ct, a, d, h0[:, :4])
    with pytest.raises(ValueError, match="takes x, dt"):
        ops.mamba_scan(x[0], dt[0], bt, ct, a, d, h0)


def test_softplus_matches_jax_above_torch_threshold():
    """F.softplus returns x itself above x = 20; jax.nn.softplus computes
    log1p(exp(-|x|)) + max(x, 0).  Above 20 they agree to one float32 ulp;
    below it the two libraries' exp and log1p differ by up to 2 ulp."""
    x = np.concatenate([np.linspace(-30, 30, 601),
                        np.linspace(19.5, 90, 200)]).astype(np.float32)
    got = torch.nn.functional.softplus(_t(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps[x > 20].max() <= 1
    assert ulps.max() <= 2


# ---------------------------------------------------------------------------
# the mixers
# ---------------------------------------------------------------------------

def _state_np(state):
    return {k: v for k, v in state.items() if k != "idx"}


@pytest.mark.parametrize("mixer", ["rwkv6", "mamba"])
def test_mixer_prefill_then_decode_matches_reference(mixer):
    """Prefill of 10 tokens from the zero state, then two L = 1 decode
    steps against the returned state (the conv state included for mamba):
    outputs and every state leaf within 1e-4 of the reference's."""
    jmod, mod = {"rwkv6": (jrwkv6, rwkv6), "mamba": (jmamba, mamba)}[mixer]
    jcfg, cfg = _configs("rwkv6-7b" if mixer == "rwkv6" else "jamba-dense")
    jp = getattr(jmod, f"init_{mixer}")(jax.random.key(3), jcfg)
    p = jax.tree.map(_t, jp)
    fwd, jfwd = getattr(mod, f"{mixer}_forward"), getattr(jmod,
                                                          f"{mixer}_forward")
    x = np.random.default_rng(4).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    want, jstate = jfwd(jp, jnp.asarray(x[:, :10]), jcfg)
    got, state = fwd(p, _t(x[:, :10]), cfg)
    _close(got.numpy(), want)
    for t in (10, 11):
        want, jstate = getattr(jmod, f"{mixer}_decode")(
            jp, jnp.asarray(x[:, t:t + 1]), jstate, jcfg)
        got, state = getattr(mod, f"{mixer}_decode")(p, _t(x[:, t:t + 1]),
                                                     state, cfg)
        _close(got.numpy(), want)
        assert state["idx"] == int(jstate["idx"]) == t + 1
        for key, leaf in _state_np(state).items():
            _close(leaf.numpy(), jstate[key])


def test_conv_causal_is_the_shifted_sum():
    """Against the reference's ``_conv_causal`` with a non-zero conv state:
    bitwise (the same adds in the same order)."""
    rng = np.random.default_rng(8)
    x, state = (rng.standard_normal(sh).astype(np.float32)
                for sh in ((2, 7, 16), (2, 3, 16)))
    w, b = (rng.standard_normal(sh).astype(np.float32)
            for sh in ((4, 16), (16,)))
    want_y, want_s = jmamba._conv_causal(*(jnp.asarray(t)
                                           for t in (x, state, w, b)))
    y, s = mamba._conv_causal(_t(x), _t(state), _t(w), _t(b))
    np.testing.assert_array_equal(y.numpy(), np.asarray(want_y))
    np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))


# ---------------------------------------------------------------------------
# the whole model through the serving steps
# ---------------------------------------------------------------------------

def _final_states(caches):
    """[(group, layer, leaf name, array)] of every recurrent state leaf."""
    return [(g, name, key, leaf)
            for g, cg in enumerate(caches) for name, ce in cg.items()
            if "state" in ce
            for key, leaf in _state_np(ce["state"]).items()]


@pytest.mark.parametrize("name", ["rwkv6-7b", "jamba-dense"])
def test_prefill_and_greedy_decode_match_reference(name):
    """Prefill of 12 tokens plus 4 greedy decode steps through
    ``make_prefill_step`` / ``make_decode_step``: the prefill's hidden
    states within 1e-4 and the same tokens as the reference at every step;
    then every recurrent state leaf (and the jamba attention layer's KV
    cache) within 1e-4."""
    jcfg, cfg = _configs(name)
    jparams, params = _params(jcfg)
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 12))
    cache_len = 16

    jh, jcaches, _ = jtf.forward(jparams, jcfg, jnp.asarray(toks, jnp.int32),
                                 mode="prefill", cache_len=cache_len,
                                 scan=False)
    with torch.inference_mode():
        h, _, _ = tf.forward(params, cfg, _t(toks), mode="prefill")
    _close(h.numpy(), jh)
    jtok = np.asarray(jnp.argmax(jtf.logits_last(jparams, jcfg, jh), -1))
    tok, caches, _ = make_prefill_step(cfg, cache_len=cache_len)(
           params, {"tokens": _t(toks)})
    np.testing.assert_array_equal(tok.numpy(), jtok)
    decode = make_decode_step(cfg)
    for _ in range(4):
        jh, jcaches, _ = jtf.forward(jparams, jcfg,
                                     jnp.asarray(jtok)[:, None],
                                     mode="decode", caches=jcaches,
                                     scan=False)
        jtok = np.asarray(jnp.argmax(jtf.logits_last(jparams, jcfg, jh), -1))
        tok, caches, _ = decode(params, caches, tok[:, None])
        np.testing.assert_array_equal(tok.numpy(), jtok)
    n_ssm = sum(m != "attn" for m, _ in cfg.pattern)
    states = _final_states(caches)
    assert len(states) == 2 * n_ssm * cfg.n_groups
    for g, lname, key, leaf in states:
        _close(leaf.numpy(), jcaches[lname]["state"][key][g])
    if name == "jamba-dense":
        for g, cg in enumerate(caches):
            for key in ("k", "v"):
                _close(cg["l0"]["self"][key].numpy(),
                       jcaches["l0"]["self"][key][g])


@pytest.mark.parametrize("name", ["rwkv6-7b", "jamba-dense"])
def test_decode_matches_teacher_forcing(name):
    """Within the port: decoding 3 given tokens one at a time against the
    prefill's states gives the hidden states of a prefill of the whole
    sequence, and the same final states."""
    _, cfg = _configs(name)
    params = tf.init_params(cfg, seed=1, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab, (2, 11)))
    with torch.inference_mode():
        _, caches, _ = tf.forward(params, cfg, toks[:, :8], mode="prefill",
                                  cache_len=11)
        dec = []
        for t in range(8, 11):
            h, caches, _ = tf.forward(params, cfg, toks[:, t:t + 1],
                                      mode="decode", caches=caches)
            dec.append(h[:, 0])
        h_full, full, _ = tf.forward(params, cfg, toks, mode="prefill")
    _close(torch.stack(dec, 1).numpy(), h_full[:, 8:].numpy(), 2e-5)
    for (g, lname, key, leaf), (_, _, _, want) in zip(
            _final_states(caches), _final_states(full)):
        _close(leaf.numpy(), want.numpy(), 2e-5)


def _pairs(port, ref, g=None):
    """(port leaf, reference leaf) pairs of two trees with the same keys;
    ``g`` picks one group of the reference's stacked groups."""
    if isinstance(ref, dict):
        assert set(port) == set(ref)
        for key in ref:
            yield from _pairs(port[key], ref[key], g)
    else:
        yield port, (ref if g is None else ref[g])


@pytest.mark.parametrize("name", ["rwkv6-7b", "jamba-dense"])
def test_params_from_jax_keeps_every_leaf(name):
    """Every leaf of the reference's tree (``u``, ``mix``, ``o_norm``,
    ``a_log``, ``conv_w``, ...) arrives with its values, and the port's own
    init builds the same keys and shapes."""
    jcfg, cfg = _configs(name)
    jparams, params = _params(jcfg)
    ref = jax.tree.map(np.asarray, jparams)
    assert tf.n_params(params) == jtf.n_params(jparams)
    own = tf.init_params(cfg, seed=0, device="cpu")
    assert len(params["groups"]) == len(own["groups"]) == cfg.n_groups
    pairs = [p for key in ref if key != "groups"
             for p in _pairs(params[key], ref[key])]
    for g in range(cfg.n_groups):
        pairs += list(_pairs(params["groups"][g], ref["groups"], g))
        for mine, carried in _pairs(own["groups"][g], params["groups"][g]):
            assert mine.shape == carried.shape
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), want)


# the parameters of the dense configurations as the port drew them when
# the whole tree moved to the device at the end: sha256 of every leaf's
# bytes in tree order, seed 0
PARAM_DIGESTS = {("smollm-135m", True): "0c4fbcd8e099d2c844c66a2d1c3d411b",
                 ("qwen3-1.7b", True): "3eb2b7001a465c21d5808edcdeff6b88",
                 ("smollm-135m", False): "d2f7aa3ba23bcaa26513d0ca268e73ff"}


@pytest.mark.parametrize("name,reduced", sorted(PARAM_DIGESTS))
def test_init_params_per_leaf_draws_the_whole_tree_draw(name, reduced):
    """``init_params`` moves each layer to the device as it is drawn; the
    draws and their order are those of the whole-tree draw, bitwise."""
    cfg = get_config(name)
    params = tf.init_params(cfg.reduced() if reduced else cfg, seed=0,
                            device="cpu")
    h = hashlib.sha256()
    for leaf in tf._leaves(params):
        h.update(leaf.contiguous().numpy().tobytes())
    assert h.hexdigest()[:32] == PARAM_DIGESTS[(name, reduced)]


def test_serve_runs_rwkv6_on_cpu(capsys):
    serve.main(["--arch", "rwkv6-7b", "--reduced", "--device", "cpu",
                "--requests", "2", "--prompt-len", "8", "--gen-len", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("prefill: 2 x 8 tokens")
    assert lines[2].startswith("sample continuation (request 0): [")


def test_serving_counts_no_kernel_launch_on_cpu():
    """On the CPU the wrappers run the plain scans and count nothing."""
    cfg = jamba_dense(get_config)
    ops.reset_launches()
    res = serve.serve(cfg, requests=1, prompt_len=5, gen_len=2,
                      device="cpu")
    assert res["tokens"].shape == (1, 2)
    assert all(n == 0 for n in ops.launch_counts().values())
