"""repro_torch's sliding-window (local) attention against repro's, on the
CPU: K5's plain version with a window against the reference's masked
``_sdpa`` and, at D = 256, against the Pallas kernel (interpret mode); the
local GQA layer, its ring cache (prefill fill and decode across the wrap);
and prefill + greedy decode of gemma3-4b reduced to one 17-layer period
(window 8, head size 16), with the reference's parameters carried over by
``params_from_jax``.  The CUDA kernel itself runs only on a card
(``test_torch_cuda.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro_torch.configs.base import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import attention
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_jax
from repro_torch.train.steps import make_decode_step, make_prefill_step

# tiny shapes, several pytest workers: one intra-op thread each
torch.set_num_threads(1)

ARCH = "gemma3-4b"


def _t(x):
    return torch.as_tensor(np.array(x))


def _configs(padded_heads=None):
    """(reference config, port config): gemma3-4b reduced, cut to one
    17-layer period (14 local, 3 global layers; window 8, hd 16),
    optionally with padded query heads."""
    jcfg, cfg = (dataclasses.replace(c.reduced(), n_layers=17)
                 for c in (jget_config(ARCH), get_config(ARCH)))
    if padded_heads:
        jcfg = dataclasses.replace(jcfg, padded_heads=padded_heads)
        cfg = dataclasses.replace(cfg, padded_heads=padded_heads)
    return jcfg, cfg


def _params(jcfg):
    """(reference params, the port's copy of them on the CPU)."""
    jparams = jtf.init_params(jax.random.key(0), jcfg, jnp.float32)
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


def _gqa_params(jcfg):
    jp = jattn.init_gqa(jax.random.key(1), jcfg)
    return jp, {k: (_t(w) if not isinstance(w, dict)
                    else {"scale": _t(w["scale"])}) for k, w in jp.items()}


# ---------------------------------------------------------------------------
# K5's plain version with a window
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [1, 3, 8, 40])
@pytest.mark.parametrize("b,h,live,hkv,s,t,d", [
    (1, 4, 4, 4, 12, 12, 16),      # prefill, S = T
    (2, 8, 6, 2, 9, 20, 16),       # queries the last 9 of 20, padded heads
    (1, 6, 6, 3, 1, 17, 16),       # one decode query
    (1, 4, 2, 1, 10, 10, 256),     # gemma3's head size, grouped and padded
])
def test_windowed_plain_matches_reference_mask(window, b, h, live, hkv, s,
                                               t, d):
    """The reference's local attention: K/V repeated for each group and
    zero-padded to H, ``_sdpa`` under ``_causal_mask(s, t, window)``.  A
    window of at least T is the unwindowed call, bitwise."""
    rng = np.random.default_rng(window + s + t + d)
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, hkv, t, d)).astype(np.float32)
            for _ in range(2))
    pad = ((0, 0), (0, h - live), (0, 0), (0, 0))
    kk, vv = (jnp.pad(jnp.repeat(jnp.asarray(x), live // hkv, axis=1), pad)
              for x in (k, v))
    want = jattn._sdpa(jnp.asarray(q), kk, vv,
                       jattn._causal_mask(s, t, window), d ** -0.5)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True,
                              live_heads=live, window=window)
    assert got.shape == (b, h, s, d) and not got[:, live:].any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    if window >= t:
        full = ops.flash_attention(_t(q), _t(k), _t(v), causal=True,
                                   live_heads=live)
        assert torch.equal(got, full)


@pytest.mark.parametrize("s,t", [(16, 16), (8, 24), (1, 20)])
def test_plain_at_d256_matches_pallas(s, t):
    """K5's plain version at gemma3's head size against the reference's
    Pallas kernel in interpret mode and its oracle."""
    rng = np.random.default_rng(s + t)
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((1, 2, s, 256), (1, 2, t, 256), (1, 2, t, 256)))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    kernel = jops.flash_attention(jq, jk, jv, causal=True, block_q=8,
                                  block_k=8)
    ref = jops.flash_attention_ref(jq, jk, jv, causal=True)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True)
    for want in (kernel, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


def test_window_arguments_are_checked():
    q = torch.zeros(1, 2, 4, 16)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, q, q, window=-1)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, q, q, causal=False, window=2)


# ---------------------------------------------------------------------------
# the local GQA layer and its ring cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("padded", [None, 8])
def test_local_gqa_forward_matches_reference(padded):
    jcfg, cfg = _configs(padded)
    jp, p = _gqa_params(jcfg)
    x = np.random.default_rng(2).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    window = cfg.sliding_window
    want, (wk, wv) = jattn.gqa_forward(jp, jnp.asarray(x), jcfg,
                                       window=window, return_kv=True)
    got, (k, v) = attention.gqa_forward(p, _t(x), cfg, window=window,
                                        return_kv=True)
    for g, w in ((got, want), (k, wk), (v, wv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("s", [5, 8, 13])   # S < t, S = t, S > t (t = 8)
def test_ring_fill_and_decode_match_reference(s):
    """A local layer's prefill fills its ring as the reference's does (the
    slots that hold a position equal), then 10 decode steps cross the
    wrap with outputs within 1e-5 of ``gqa_decode(window=...)``."""
    jcfg, cfg = _configs()
    jp, p = _gqa_params(jcfg)
    window, steps = cfg.sliding_window, 10
    max_len = s + steps
    x = np.random.default_rng(3 + s).standard_normal(
        (2, max_len, cfg.d_model)).astype(np.float32)
    _, (jk, jv) = jattn.gqa_forward(jp, jnp.asarray(x[:, :s]), jcfg,
                                    window=window, return_kv=True)
    jc = jattn.fill_gqa_cache(
        jattn.init_gqa_cache(jcfg, 2, max_len, window=window), jk, jv,
        window=window)
    _, (k, v) = attention.gqa_forward(p, _t(x[:, :s]), cfg, window=window,
                                      return_kv=True)
    c = attention.fill_gqa_cache(
        attention.init_gqa_cache(cfg, 2, max_len, window=window), k, v,
        window=window)
    assert c["k"].shape == jc["k"].shape == (2, cfg.n_kv_heads, window,
                                             cfg.hd)
    assert c["idx"] == s
    held = np.asarray(jc["pos"][0]) >= 0
    assert held.sum() == min(s, window)
    for name in ("k", "v"):
        np.testing.assert_allclose(c[name][:, :, held].numpy(),
                                   np.asarray(jc[name])[:, :, held],
                                   rtol=1e-6, atol=1e-6)
    for i in range(s, max_len):
        jy, jc = jattn.gqa_decode(jp, jnp.asarray(x[:, i:i + 1]), jc, jcfg,
                                  window=window)
        y, c = attention.gqa_decode(p, _t(x[:, i:i + 1]), c, cfg,
                                    window=window)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5)
    assert c["idx"] == max_len
    for name in ("k", "v"):
        np.testing.assert_allclose(c[name].numpy(), np.asarray(jc[name]),
                                   rtol=1e-6, atol=1e-6)


def test_global_cache_fills_and_a_ring_wraps():
    _, cfg = _configs()
    p = tf.init_layer(torch.Generator().manual_seed(0), cfg, "local", "mlp",
                      torch.float32)["mixer"]
    x = torch.randn(1, 1, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    glob = attention.init_gqa_cache(cfg, 1, 3)
    ring = attention.init_gqa_cache(cfg, 1, 3, window=cfg.sliding_window)
    assert ring["k"].shape[2] == 3          # min(max_len, window)
    for _ in range(3):
        _, glob = attention.gqa_decode(p, x, glob, cfg)
    with pytest.raises(ValueError, match="full"):
        attention.gqa_decode(p, x, glob, cfg)
    for _ in range(7):                      # a ring never fills
        _, ring = attention.gqa_decode(p, x, ring, cfg,
                                       window=cfg.sliding_window)
    assert ring["idx"] == 7


# ---------------------------------------------------------------------------
# gemma3 reduced: the whole serving path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prompt,steps,padded", [
    (12, 4, None),      # the prompt is longer than the window: the ring
                        # wraps in the prefill
    (5, 6, None),       # the ring wraps at decode step 4
    (12, 4, 8),         # padded query heads
])
def test_gemma3_prefill_and_decode_match_reference(prompt, steps, padded):
    """Prefill plus greedy decode: hidden states within 1e-4 and the same
    tokens as ``repro.models.transformer.forward``."""
    jcfg, cfg = _configs(padded)
    jparams, params = _params(jcfg)
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, prompt))
    cache_len = prompt + steps

    jh, jcaches, _ = jtf.forward(jparams, jcfg, jnp.asarray(toks, jnp.int32),
                                 mode="prefill", cache_len=cache_len,
                                 scan=False)
    jtok = np.asarray(jnp.argmax(jtf.logits_last(jparams, jcfg, jh), -1))
    with torch.inference_mode():
        h, caches, _ = tf.forward(params, cfg, _t(toks), mode="prefill",
                                  cache_len=cache_len)
        tok = tf.logits_last(params, cfg, h).argmax(-1)
    for i, (mixer, _) in enumerate(cfg.pattern):
        t = caches[0][f"l{i}"]["self"]["k"].shape[2]
        assert t == (min(cache_len, cfg.sliding_window) if mixer == "local"
                     else cache_len)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(tok.numpy(), jtok)
    for _ in range(steps):
        jh, jcaches, _ = jtf.forward(jparams, jcfg, jnp.asarray(jtok)[:, None],
                                     mode="decode", caches=jcaches,
                                     scan=False)
        jtok = np.asarray(jnp.argmax(jtf.logits_last(jparams, jcfg, jh), -1))
        with torch.inference_mode():
            h, caches, _ = tf.forward(params, cfg, tok[:, None], mode="decode",
                                      caches=caches)
            tok = tf.logits_last(params, cfg, h).argmax(-1)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(tok.numpy(), jtok)


def test_gemma3_params_from_jax_keep_every_parameter():
    jcfg, cfg = _configs(padded_heads=8)
    jparams, params = _params(jcfg)
    assert tf.n_params(params) == jtf.n_params(jparams)
    own = tf.init_params(cfg, seed=0, device="cpu")
    assert tf.n_params(own) == tf.n_params(params)
    for i in (0, 5):                                   # a local, a global
        for name, w in params["groups"][0][f"l{i}"]["mixer"].items():
            assert own["groups"][0][f"l{i}"]["mixer"][name].shape == w.shape


def test_gemma3_decode_matches_teacher_forcing():
    """Within the port: each decode step across the ring's wrap gives the
    last hidden state of a (windowed) prefill of the sequence so far."""
    _, cfg = _configs()
    params = tf.init_params(cfg, seed=1, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab, (2, 14)))
    prefill = make_prefill_step(cfg, cache_len=15)
    decode = make_decode_step(cfg)
    _, caches, _ = prefill(params, {"tokens": toks[:, :6]})
    for i in range(6, 14):                       # idx 8 wraps the ring
        with torch.inference_mode():
            h_dec, caches, _ = tf.forward(params, cfg, toks[:, i:i + 1],
                                          mode="decode", caches=caches)
            h_full, _, _ = tf.forward(params, cfg, toks[:, :i + 1],
                                      mode="prefill")
        np.testing.assert_allclose(h_dec[:, 0].numpy(), h_full[:, -1].numpy(),
                                   rtol=2e-5, atol=2e-5)
    nxt, caches, _ = decode(params, caches, toks[:, -1:])
    assert nxt.shape == (2,) and caches[0]["l0"]["self"]["idx"] == 15


def test_gemma3_serve_runs_on_cpu(capsys):
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                "--requests", "2", "--prompt-len", "10", "--gen-len", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("prefill: 2 x 10 tokens")
    assert lines[1].startswith("decode:  2 x 3 tokens")
    assert lines[2].startswith("sample continuation (request 0): [")
