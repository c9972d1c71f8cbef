"""repro_torch's LM serving path against repro's, on the CPU: the plain
flash attention against the Pallas kernel (interpret mode) and its oracle,
the layers, GQA, and prefill + greedy decode of reduced dense configs with
the reference's parameters carried over by ``params_from_jax``.  The CUDA
kernel K5 itself runs only on a card (``test_torch_cuda.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro_torch.configs.base import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import attention, layers
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_jax
from repro_torch.train.optimizer import init_adamw
from repro_torch.train.steps import (
    make_decode_step, make_prefill_step, make_train_step,
)

# tiny shapes, several pytest workers: one intra-op thread each keeps
# torch's pool from oversubscribing the CPU
torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.array(x))


def _shapes(tree, path=""):
    """{key path: shape} of a nested dict / list of tensors."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {path: tuple(tree.shape)}
    return {k: v for key, sub in items
            for k, v in _shapes(sub, f"{path}/{key}").items()}


def _qkv(shape_q, shape_kv, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(sh).astype(np.float32)
                 for sh in (shape_q, shape_kv, shape_kv))


# ---------------------------------------------------------------------------
# K5's plain version (what the wrapper runs for CPU tensors)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,s,t,d", [
    (1, 1, 8, 8, 16), (1, 2, 16, 16, 32), (2, 2, 64, 64, 64),
    (1, 1, 8, 32, 16),      # decode-style: queries are the last 8 of 32
    (1, 1, 1, 40, 64),      # single-token decode
    (1, 2, 24, 24, 48),     # non-power-of-two d
])
def test_flash_attention_plain_matches_pallas(b, h, s, t, d):
    q, k, v = _qkv((b, h, s, d), (b, h, t, d), seed=b + h + s + t + d)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    kernel = np.asarray(jops.flash_attention(jq, jk, jv, causal=True,
                                             block_q=8, block_k=16))
    ref = np.asarray(jops.flash_attention_ref(jq, jk, jv, causal=True))
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), kernel, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_dtypes(dtype):
    q, k, v = _qkv((1, 2, 32, 64), (1, 2, 32, 64), seed=3)
    jq, jk, jv = (jnp.asarray(x, dtype) for x in (q, k, v))
    tq, tk, tv = (_t(x).to(getattr(torch, dtype)) for x in (q, k, v))
    kernel = jops.flash_attention(jq, jk, jv, block_q=8, block_k=16)
    ref = jops.flash_attention_ref(jq, jk, jv)
    got = ops.flash_attention(tq, tk, tv)
    assert got.dtype == getattr(torch, dtype)
    tol = 2e-5 if dtype == "float32" else 3e-2
    for want in (kernel, ref):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


def test_flash_attention_plain_noncausal_and_scale():
    q, k, v = _qkv((1, 1, 16, 32), (1, 1, 48, 32), seed=4)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    kernel = jops.flash_attention(jq, jk, jv, causal=False, block_q=8,
                                  block_k=16)
    ref = jops.flash_attention_ref(jq, jk, jv, causal=False)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)
    scaled = ops.flash_attention(_t(q), _t(k), _t(v), causal=False,
                                 scale=0.3)
    want = jops.flash_attention_ref(jq, jk, jv, causal=False, scale=0.3)
    np.testing.assert_allclose(scaled.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("s", [1, 4])
def test_flash_attention_plain_noncausal_few_queries(s):
    """Cross-attention's shapes: 1 (decode) or 4 (a prompt) queries over
    T = 40 keys, not a multiple of 8, none masked."""
    q, k, v = _qkv((2, 3, s, 16), (2, 3, 40, 16), seed=5 + s)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    want = jops.flash_attention_ref(jq, jk, jv, causal=False)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_flash_attention_rejects_bad_shapes():
    q, k, v = (torch.zeros(sh) for sh in ((1, 2, 8, 16), (1, 2, 4, 16),
                                          (1, 2, 4, 16)))
    with pytest.raises(ValueError, match="T >= S"):
        ops.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="disagree"):
        ops.flash_attention(q, torch.zeros(1, 2, 8, 32),
                            torch.zeros(1, 2, 8, 32))
    with pytest.raises(ValueError, match="k, v"):
        ops.flash_attention(q, torch.zeros(1, 2, 8, 16),
                            torch.zeros(1, 2, 9, 16))


def _gqa_reference(q, k, v, live, kv_len, causal):
    """The JAX model's path: the first kv_len cache rows, each KV head
    repeated for its group (``jnp.repeat``), zero heads up to H, through
    the Pallas kernel (interpret mode) and its oracle."""
    h, hkv = q.shape[1], k.shape[1]
    kk, vv = (jnp.repeat(jnp.asarray(x[:, :, :kv_len]), live // hkv, axis=1)
              for x in (k, v))
    pad = ((0, 0), (0, h - live), (0, 0), (0, 0))
    kk, vv = jnp.pad(kk, pad), jnp.pad(vv, pad)
    jq = jnp.asarray(q)
    kernel = jops.flash_attention(jq, kk, vv, causal=causal, block_q=8,
                                  block_k=16)
    return np.asarray(kernel), np.asarray(
        jops.flash_attention_ref(jq, kk, vv, causal=causal))


@pytest.mark.parametrize("b,h,live,hkv,s,t_alloc,kv_len,d,causal", [
    (1, 6, 6, 6, 8, 24, 20, 16, True),      # Hkv = H, a cache tail
    (2, 6, 6, 3, 8, 32, 32, 16, True),      # Hkv = H / 2
    (1, 6, 6, 2, 1, 40, 33, 16, True),      # Hkv = H / 3, decode
    (1, 6, 6, 2, 5, 40, 33, 16, False),     # Hkv = H / 3, not causal
    (1, 8, 6, 2, 16, 48, 40, 32, False),    # padded heads
    (2, 16, 9, 3, 1, 24, 17, 64, True),     # smollm's heads, decode
    (1, 16, 9, 3, 12, 12, 12, 64, True),    # smollm's heads, prefill
])
def test_flash_attention_grouped_plain_matches_pallas(b, h, live, hkv, s,
                                                      t_alloc, kv_len, d,
                                                      causal):
    """K5's grouped interface on the CPU against the reference's repeat +
    zero-pad + Pallas path; the cache slots past kv_len hold NaN and must
    not be read; the padded heads are exactly zero."""
    q, k, v = _qkv((b, h, s, d), (b, hkv, t_alloc, d),
                   seed=h + live + hkv + s + kv_len + d)
    kernel, ref = _gqa_reference(q, k, v, live, kv_len, causal)
    k[:, :, kv_len:] = np.nan
    v[:, :, kv_len:] = np.nan
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              kv_len=kv_len, live_heads=live)
    assert got.shape == (b, h, s, d) and got.dtype == torch.float32
    assert not got[:, live:].any()
    np.testing.assert_allclose(got.numpy(), kernel, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)


def test_flash_attention_grouped_arguments_are_checked():
    q, k = torch.zeros(1, 6, 4, 16), torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError, match="live_heads"):
        ops.flash_attention(q, k, k)                  # 4 does not divide 6
    with pytest.raises(ValueError, match="live_heads"):
        ops.flash_attention(q, k, k, live_heads=7)    # more than H
    k = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="kv_len"):
        ops.flash_attention(q, k, k, kv_len=9)
    with pytest.raises(ValueError, match="T >= S"):
        ops.flash_attention(q, k, k, kv_len=3)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rmsnorm_rope_mlp_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                           1e-6)
    got = layers.rmsnorm({"scale": _t(scale)}, _t(x), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)

    pos = rng.integers(0, 600, size=(2, 5)).astype(np.int32)
    for theta in (1e4, 1e6):
        want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        got = layers.apply_rope(_t(x), _t(pos), theta)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)

    p = {name: rng.standard_normal(sh).astype(np.float32) * 0.2
         for name, sh in (("w_gate", (16, 24)), ("w_up", (16, 24)),
                          ("w_down", (24, 16)))}
    want = jlayers.mlp({k: jnp.asarray(w) for k, w in p.items()},
                       jnp.asarray(x))
    got = layers.mlp({k: _t(w) for k, w in p.items()}, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# GQA and the whole serving path, reference parameters carried over
# ---------------------------------------------------------------------------

def _configs(name, padded_heads=None):
    """(reference config, port config): the reduced config, optionally
    with padded query heads."""
    jcfg, cfg = jget_config(name).reduced(), get_config(name).reduced()
    if padded_heads:
        jcfg = dataclasses.replace(jcfg, padded_heads=padded_heads)
        cfg = dataclasses.replace(cfg, padded_heads=padded_heads)
    return jcfg, cfg


def _params(jcfg):
    """(reference params, the port's copy of them on the CPU)."""
    jparams = jtf.init_params(jax.random.key(0), jcfg, jnp.float32)
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


@pytest.mark.parametrize("name,padded", [
    ("smollm-135m", None), ("smollm-135m", 8), ("qwen3-1.7b", None)])
def test_gqa_forward_matches_reference(name, padded):
    jcfg, cfg = _configs(name, padded)
    jp = jattn.init_gqa(jax.random.key(1), jcfg)
    p = {k: (_t(w) if not isinstance(w, dict) else {"scale": _t(w["scale"])})
         for k, w in jp.items()}
    x = np.random.default_rng(2).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    want, (wk, wv) = jattn.gqa_forward(jp, jnp.asarray(x), jcfg,
                                       return_kv=True)
    got, (k, v) = attention.gqa_forward(p, _t(x), cfg, return_kv=True)
    for g, w in ((got, want), (k, wk), (v, wv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("name", ["smollm-135m", "qwen3-1.7b"])
def test_prefill_and_decode_match_reference(name):
    """Prefill plus 4 greedy decode steps: hidden states within 1e-4 and
    the same tokens as ``repro.models.transformer.forward``."""
    jcfg, cfg = _configs(name)
    jparams, params = _params(jcfg)
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 12))
    cache_len = 16

    jh, jcaches, _ = jtf.forward(jparams, jcfg, jnp.asarray(toks, jnp.int32),
                                 mode="prefill", cache_len=cache_len,
                                 scan=False)
    jtok = np.asarray(jnp.argmax(jtf.logits_last(jparams, jcfg, jh), -1))
    with torch.inference_mode():
        h, caches, _ = tf.forward(params, cfg, _t(toks), mode="prefill",
                                  cache_len=cache_len)
        tok = tf.logits_last(params, cfg, h).argmax(-1)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(tok.numpy(), jtok)
    for _ in range(4):
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


def test_params_from_jax_keeps_every_parameter():
    jcfg, cfg = _configs("smollm-135m", padded_heads=8)
    jparams, params = _params(jcfg)
    assert tf.n_params(params) == jtf.n_params(jparams)
    assert len(params["groups"]) == cfg.n_groups
    g1 = params["groups"][1]["l0"]["mixer"]["wq"]
    np.testing.assert_array_equal(
        g1.numpy(), np.asarray(jparams["groups"]["l0"]["mixer"]["wq"][1]))
    # the port's own init builds the same tree, padded heads zero
    own = tf.init_params(cfg, seed=0, device="cpu")
    assert _shapes(own) == _shapes(params)
    wq = own["groups"][0]["l0"]["mixer"]["wq"]
    assert not wq[:, cfg.n_heads * cfg.hd:].any()


def test_decode_matches_teacher_forcing():
    """Within the port: decoding one token against the prefill caches gives
    the last hidden state of a prefill of the extended sequence."""
    cfg = get_config("qwen3-1.7b").reduced()
    params = tf.init_params(cfg, seed=1, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab, (2, 9)))
    prefill, decode = make_prefill_step(cfg, cache_len=12), \
        make_decode_step(cfg)
    tok, caches, _ = prefill(params, {"tokens": toks})
    assert tok.dtype == torch.int32 and caches[0]["l0"]["self"]["idx"] == 9
    nxt, caches, _ = decode(params, caches, tok[:, None])
    assert caches[0]["l0"]["self"]["idx"] == 10
    with torch.inference_mode():
        h_dec, _, _ = tf.forward(params, cfg, tok[:, None].long(),
                                 mode="decode",
                                 caches=prefill(params, {"tokens": toks})[1])
        h_full, _, _ = tf.forward(params, cfg,
                                  torch.cat([toks, tok[:, None].long()], 1),
                                  mode="prefill")
    np.testing.assert_allclose(h_dec[:, 0].numpy(), h_full[:, -1].numpy(),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", ["whisper-tiny", "internvl2-26b",
                                  "rwkv6-7b", "jamba-1.5-large-398b"])
def test_every_config_serves_and_trains(name):
    """Every configuration serves and trains: the train-mode forward runs
    (with its frames or patches for whisper and internvl; through K7's and
    K6's plain backwards for the rwkv6 and mamba layers) and is
    differentiable in the first layer's mixer, and a train step is
    finite."""
    cfg = get_config(name).reduced()
    params = tf.init_params(cfg, seed=0, device="cpu")
    toks = torch.zeros(1, 3, dtype=torch.long)
    extra = ({"frames": torch.zeros(1, cfg.encdec.enc_len, cfg.d_model)}
             if cfg.encdec else
             {"patches": torch.zeros(1, cfg.n_patches, cfg.d_model)}
             if cfg.n_patches else {})
    mixer = params["groups"][0]["l0"]["mixer"]
    wq = mixer["wr" if "wr" in mixer else "wq"].requires_grad_(True)
    hidden, caches, aux = tf.forward(params, cfg, toks, mode="train",
                                     **extra)
    assert caches is None and aux.shape == (2,)
    assert hidden.shape == (1, 3 + cfg.n_patches, cfg.d_model)
    (grad,) = torch.autograd.grad(hidden.square().sum(), [wq])
    assert torch.isfinite(grad).all() and grad.abs().max() > 0
    wq.requires_grad_(False)
    batch = {"tokens": toks, "labels": torch.ones(
        1, 3 + cfg.n_patches, dtype=torch.long), **extra}
    _, _, metrics = make_train_step(cfg, micro_steps=1)(
        params, init_adamw(params), batch)
    assert all(np.isfinite(float(v)) for v in metrics.values())


def test_serve_defaults_to_the_card_and_runs_on_cpu(capsys):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(["--arch", "smollm-135m", "--reduced"])
    serve.main(["--arch", "smollm-135m", "--reduced", "--device", "cpu",
                "--requests", "2", "--prompt-len", "8", "--gen-len", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("prefill: 2 x 8 tokens")
    assert lines[1].startswith("decode:  2 x 3 tokens")
    assert lines[2].startswith("sample continuation (request 0): [")
    # training an rwkv6 model runs on the CPU too (it raised before K7's
    # backward was ported)
    cfg = get_config("rwkv6-7b").reduced()
    hidden, caches, _ = tf.forward(tf.init_params(cfg, device="cpu"), cfg,
                                   torch.zeros(1, 2, dtype=torch.long),
                                   mode="train")
    assert caches is None and hidden.shape == (1, 2, cfg.d_model)
