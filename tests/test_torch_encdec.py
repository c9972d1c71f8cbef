"""repro_torch's encoder-decoder path (whisper-tiny) against repro's, on the
CPU: the sinusoidal position table, the bidirectional encoder, non-causal
GQA, cross-attention and its cache, and prefill + greedy decode of reduced
whisper-tiny (2 encoder and 2 decoder layers over 16 frames) with the
reference's parameters carried over by ``params_from_jax``; and ``serve()``
drawing its frames in the reference's order.  K5 runs as its plain version
here; on a card it runs in ``test_torch_cuda.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro_torch.configs.base import get_config
from repro_torch.launch import serve
from repro_torch.models import attention
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_jax
from repro_torch.train.steps import make_decode_step, make_prefill_step

# tiny shapes, several pytest workers: one intra-op thread each
torch.set_num_threads(1)

ARCH = "whisper-tiny"
TOL = 1e-5


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _configs(**changes):
    """(reference config, port config): whisper-tiny reduced (d 64, 4
    heads of 16, 2 encoder layers over enc_len 16, 2 decoder layers)."""
    return tuple(dataclasses.replace(c.reduced(), **changes)
                 for c in (jget_config(ARCH), get_config(ARCH)))


def _params(jcfg):
    """(reference params, the port's copy of them on the CPU)."""
    jparams = jtf.init_params(jax.random.key(0), jcfg, jnp.float32)
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


def _layer_params(jp):
    return {k: (_t(w) if not isinstance(w, dict) else {"scale": _t(w["scale"])})
            for k, w in jp.items()}


def _frames(cfg, b, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.encdec.enc_len, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("length,d", [(16, 64), (1500, 384)])
def test_sinusoidal_matches_reference(length, d):
    got = tf._sinusoidal(length, d)
    assert got.dtype == torch.float32 and got.shape == (length, d)
    _close(got, jtf._sinusoidal(length, d), 1e-6)


def test_encode_matches_reference():
    jcfg, cfg = _configs()
    jparams, params = _params(jcfg)
    frames = _frames(cfg, 2, seed=1)
    want = jtf.encode(jparams, jcfg, jnp.asarray(frames), scan=False)
    got = tf.encode(params, cfg, _t(frames))
    assert isinstance(params["encoder"]["layers"], list)
    _close(got, want)


def test_noncausal_gqa_matches_reference():
    jcfg, cfg = _configs()
    jp = jattn.init_gqa(jax.random.key(1), jcfg)
    x = np.random.default_rng(2).standard_normal(
        (2, 11, cfg.d_model)).astype(np.float32)
    want = jattn.gqa_forward(jp, jnp.asarray(x), jcfg, causal=False)
    got = attention.gqa_forward(_layer_params(jp), _t(x), cfg, causal=False)
    _close(got, want)


@pytest.mark.parametrize("changes", [
    {}, {"qk_norm": True}, {"padded_heads": 8}, {"n_kv_heads": 2}])
def test_cross_attention_matches_reference(changes):
    """cross_forward over a 16-position encoder output, the cross cache
    it leaves, and cross_decode of one token against that cache."""
    jcfg, cfg = _configs(**changes)
    jp = jattn.init_cross(jax.random.key(3), jcfg)
    p = _layer_params(jp)
    rng = np.random.default_rng(4)
    x, x1, enc = (rng.standard_normal((2, n, cfg.d_model)).astype(np.float32)
                  for n in (5, 1, cfg.encdec.enc_len))
    want = jattn.cross_forward(jp, jnp.asarray(x), jnp.asarray(enc), jcfg)
    jcache = jattn.make_cross_cache(jp, jnp.asarray(enc), jcfg)
    fresh = attention.init_cross_cache(cfg, 2)
    got, cache = attention.cross_forward(p, _t(x), _t(enc), cfg, fresh)
    _close(got, want)
    assert cache["k"] is fresh["k"] and set(cache) == {"k", "v"}
    for key in ("k", "v"):
        assert cache[key].shape == jcache[key].shape
        _close(cache[key], jcache[key])
    _close(attention.cross_decode(p, _t(x1), cache, cfg),
           jattn.cross_decode(jp, jnp.asarray(x1), jcache, jcfg))
    again = attention.make_cross_cache(p, _t(enc), cfg,
                                       attention.init_cross_cache(cfg, 2))
    assert torch.equal(again["k"], cache["k"])


def test_cross_cache_of_another_length_raises():
    _, cfg = _configs()
    p = attention.init_cross(torch.Generator().manual_seed(0), cfg)
    enc = torch.zeros(1, cfg.encdec.enc_len + 1, cfg.d_model)
    with pytest.raises(ValueError, match="enc_len"):
        attention.make_cross_cache(p, enc, cfg,
                                   attention.init_cross_cache(cfg, 1))


def _greedy(h, params, cfg):
    return tf.logits_last(params, cfg, h).argmax(-1)


def test_prefill_and_decode_match_reference():
    """Prefill: hidden states and both caches of every layer; then 6
    greedy decode steps: hidden states and tokens, and the cross caches
    passed through unchanged."""
    jcfg, cfg = _configs()
    jparams, params = _params(jcfg)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (2, 4))
    frames = _frames(cfg, 2, seed=6)
    cache_len = 4 + 6

    jh, jc, _ = jtf.forward(jparams, jcfg, jnp.asarray(toks, jnp.int32),
                            frames=jnp.asarray(frames), mode="prefill",
                            cache_len=cache_len, scan=False)
    with torch.inference_mode():
        h, caches, _ = tf.forward(params, cfg, _t(toks), mode="prefill",
                                  cache_len=cache_len, frames=_t(frames))
    _close(h, jh)
    for g, cg in enumerate(caches):
        assert set(cg["l0"]) == set(jc["l0"]) == {"self", "cross"}
        assert cg["l0"]["self"]["idx"] == int(jc["l0"]["self"]["idx"][g]) == 4
        for kind in ("self", "cross"):
            for key in ("k", "v"):
                _close(cg["l0"][kind][key], jc["l0"][kind][key][g])
    cross_k = caches[0]["l0"]["cross"]["k"].clone()

    jtok = np.asarray(jnp.argmax(jtf.logits_last(jparams, jcfg, jh), -1))
    tok = _greedy(h, params, cfg)
    np.testing.assert_array_equal(tok.numpy(), jtok)
    for _ in range(6):
        jh, jc, _ = jtf.forward(jparams, jcfg, jnp.asarray(jtok)[:, None],
                                mode="decode", caches=jc, scan=False)
        jtok = np.asarray(jnp.argmax(jtf.logits_last(jparams, jcfg, jh), -1))
        with torch.inference_mode():
            h, caches, _ = tf.forward(params, cfg, tok[:, None],
                                      mode="decode", caches=caches)
        tok = _greedy(h, params, cfg)
        _close(h, jh)
        np.testing.assert_array_equal(tok.numpy(), jtok)
    assert torch.equal(caches[0]["l0"]["cross"]["k"], cross_k)
    assert caches[0]["l0"]["self"]["idx"] == cache_len


def test_decode_matches_prefill_of_extended_sequence():
    """Within the port: one decode step against the prefill caches gives
    the last hidden state of a prefill of the extended sequence."""
    _, cfg = _configs()
    params = tf.init_params(cfg, seed=1, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab, (2, 6)))
    frames = _t(_frames(cfg, 2, seed=8))
    batch = {"tokens": toks, "frames": frames}
    prefill, decode = make_prefill_step(cfg, cache_len=9), \
        make_decode_step(cfg)
    tok, caches, _ = prefill(params, batch)
    with torch.inference_mode():
        h_dec, _, _ = tf.forward(params, cfg, tok[:, None].long(),
                                 mode="decode", caches=caches)
        h_full, _, _ = tf.forward(params, cfg,
                                  torch.cat([toks, tok[:, None].long()], 1),
                                  mode="prefill", frames=frames)
    _close(h_dec[:, 0], h_full[:, -1], 2e-5)
    nxt, _, _ = decode(params, prefill(params, batch)[1], tok[:, None])
    np.testing.assert_array_equal(nxt.numpy(),
                                  _greedy(h_full, params, cfg).numpy())


def test_params_from_jax_lists_encoder_layers():
    jcfg, cfg = _configs()
    jparams, params = _params(jcfg)
    assert tf.n_params(params) == jtf.n_params(jparams)
    layers = params["encoder"]["layers"]
    assert isinstance(layers, list) and len(layers) == cfg.encdec.n_enc_layers
    np.testing.assert_array_equal(
        layers[1]["mixer"]["wq"].numpy(),
        np.asarray(jparams["encoder"]["layers"]["mixer"]["wq"][1]))
    assert set(params["groups"][0]["l0"]) == {
        "norm1", "mixer", "ffn", "norm2", "cross", "norm_cross"}
    # the port's own init builds a tree of the same shapes
    own = tf.init_params(cfg, seed=0, device="cpu")
    assert tf.n_params(own) == tf.n_params(params)
    assert ({k: v.shape for k, v in _flat(own).items()}
            == {k: v.shape for k, v in _flat(params).items()})


def _flat(tree, path=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {path: tree}
    return {k: v for key, sub in items
            for k, v in _flat(sub, f"{path}/{key}").items()}


def _reference_serve(jparams, jcfg, batch, gen_len):
    """The reference's serve loop on the same inputs: prefill, then greedy
    decode, ``jtf.forward`` unrolled."""
    kw = {k: jnp.asarray(batch[k].numpy())
          for k in ("frames", "patches") if k in batch}
    s = batch["tokens"].shape[1]
    h, caches, _ = jtf.forward(
        jparams, jcfg, jnp.asarray(batch["tokens"].numpy(), jnp.int32),
        mode="prefill", cache_len=jcfg.n_patches + s + gen_len, scan=False,
        **kw)
    out = [jnp.argmax(jtf.logits_last(jparams, jcfg, h), -1)]
    for _ in range(gen_len - 1):
        h, caches, _ = jtf.forward(jparams, jcfg, out[-1][:, None],
                                   mode="decode", caches=caches, scan=False)
        out.append(jnp.argmax(jtf.logits_last(jparams, jcfg, h), -1))
    return np.stack([np.asarray(t) for t in out], axis=1)


def test_serve_draws_frames_in_reference_order_and_matches_reference():
    jcfg, cfg = _configs()
    jparams, params = _params(jcfg)
    res = serve.serve(cfg, requests=2, prompt_len=4, gen_len=5,
                      device="cpu", params=params)
    batch = serve.draw_batch(cfg, np.random.default_rng(0), 2, 4,
                             device="cpu")
    rng = np.random.default_rng(0)        # the reference's serve.py order
    np.testing.assert_array_equal(batch["tokens"].numpy(),
                                  rng.integers(0, cfg.vocab, (2, 4)))
    np.testing.assert_array_equal(
        batch["frames"].numpy(), np.asarray(jnp.asarray(rng.standard_normal(
            (2, cfg.encdec.enc_len, cfg.d_model)), jnp.float32)))
    assert "patches" not in batch
    np.testing.assert_array_equal(res["tokens"],
                                  _reference_serve(jparams, jcfg, batch, 5))


def test_prefill_without_frames_raises():
    _, cfg = _configs()
    params = tf.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="frames"):
        tf.forward(params, cfg, torch.zeros(1, 3, dtype=torch.long),
                   mode="prefill")
    with pytest.raises(ValueError, match="frames"):
        make_prefill_step(cfg)(params, {"tokens": torch.zeros(
            1, 3, dtype=torch.long)})


def test_serve_cli_prints_the_reference_lines(capsys):
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                "--requests", "2", "--prompt-len", "4", "--gen-len", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("prefill: 2 x 4 tokens")
    assert lines[1].startswith("decode:  2 x 3 tokens")
    assert lines[2].startswith("sample continuation (request 0): [")
