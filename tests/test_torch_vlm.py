"""repro_torch's VLM inputs (internvl2-26b) against repro's, on the CPU:
prefill with patch embeddings prepended to the tokens, then greedy decode,
of reduced internvl2-26b (8 patches, 2 layers, 4 query heads on 1 KV head)
with the reference's parameters carried over by ``params_from_jax``; and
``serve()`` drawing its patches in the reference's order, with caches that
hold the patches (a deliberate difference from the reference's
``serve.py``, which sizes them without)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import transformer as jtf
from repro_torch.configs.base import get_config
from repro_torch.launch import serve
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_jax
from repro_torch.train.steps import make_prefill_step

# tiny shapes, several pytest workers: one intra-op thread each
torch.set_num_threads(1)

ARCH = "internvl2-26b"
TOL = 1e-5


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _configs():
    """(reference config, port config): internvl2-26b reduced (d 64, 4
    query heads on 1 KV head of 16, 8 patches, 2 layers)."""
    return jget_config(ARCH).reduced(), get_config(ARCH).reduced()


def _params(jcfg):
    """(reference params, the port's copy of them on the CPU)."""
    jparams = jtf.init_params(jax.random.key(0), jcfg, jnp.float32)
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


def _patches(cfg, b, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.n_patches, cfg.d_model)).astype(np.float32)


def _greedy(h, params, cfg):
    return tf.logits_last(params, cfg, h).argmax(-1)


def test_prefill_and_decode_match_reference():
    """At cache_len = n_patches + S + steps: prefill hidden states (patch
    positions included), the caches and ``idx == n_patches + S``; then 6
    greedy decode steps: hidden states and tokens."""
    jcfg, cfg = _configs()
    jparams, params = _params(jcfg)
    s, steps = 5, 6
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, s))
    patches = _patches(cfg, 2, seed=2)
    cache_len = cfg.n_patches + s + steps

    jh, jc, _ = jtf.forward(jparams, jcfg, jnp.asarray(toks, jnp.int32),
                            patches=jnp.asarray(patches), mode="prefill",
                            cache_len=cache_len, scan=False)
    with torch.inference_mode():
        h, caches, _ = tf.forward(params, cfg, _t(toks), mode="prefill",
                                  cache_len=cache_len, patches=_t(patches))
    assert h.shape == (2, cfg.n_patches + s, cfg.d_model)
    _close(h, jh)
    for g, cg in enumerate(caches):
        c = cg["l0"]["self"]
        assert c["k"].shape[2] == cache_len
        assert c["idx"] == int(jc["l0"]["self"]["idx"][g]) == cfg.n_patches + s
        for key in ("k", "v"):
            _close(c[key], jc["l0"]["self"][key][g])

    jtok = np.asarray(jnp.argmax(jtf.logits_last(jparams, jcfg, jh), -1))
    tok = _greedy(h, params, cfg)
    np.testing.assert_array_equal(tok.numpy(), jtok)
    for _ in range(steps):
        jh, jc, _ = jtf.forward(jparams, jcfg, jnp.asarray(jtok)[:, None],
                                mode="decode", caches=jc, scan=False)
        jtok = np.asarray(jnp.argmax(jtf.logits_last(jparams, jcfg, jh), -1))
        with torch.inference_mode():
            h, caches, _ = tf.forward(params, cfg, tok[:, None],
                                      mode="decode", caches=caches)
        tok = _greedy(h, params, cfg)
        _close(h, jh)
        np.testing.assert_array_equal(tok.numpy(), jtok)
    assert caches[0]["l0"]["self"]["idx"] == cache_len


def _extended_prefill(params, cfg, batch, toks):
    """Hidden states of a prefill of the prompt extended by ``toks``."""
    with torch.inference_mode():
        return tf.forward(params, cfg,
                          torch.cat([batch["tokens"], toks.long()], 1),
                          mode="prefill", patches=batch["patches"])[0]


def test_decode_matches_prefill_of_extended_sequence():
    """Within the port: one decode step against the prefill caches gives
    the last hidden state of a prefill of the extended sequence."""
    _, cfg = _configs()
    params = tf.init_params(cfg, seed=1, device="cpu")
    batch = {"tokens": torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 6))), "patches": _t(_patches(cfg, 2, seed=4))}
    prefill = make_prefill_step(cfg, cache_len=cfg.n_patches + 6 + 2)
    tok, caches, _ = prefill(params, batch)
    with torch.inference_mode():
        h_dec, caches, _ = tf.forward(params, cfg, tok[:, None].long(),
                                      mode="decode", caches=caches)
    assert caches[0]["l0"]["self"]["idx"] == cfg.n_patches + 6 + 1
    h_full = _extended_prefill(params, cfg, batch, tok[:, None])
    _close(h_dec[:, 0], h_full[:, -1], 2e-5)


def test_serve_draws_patches_in_reference_order_and_matches_reference():
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
        batch["patches"].numpy(), np.asarray(jnp.asarray(rng.standard_normal(
            (2, cfg.n_patches, cfg.d_model)), jnp.float32)))
    assert "frames" not in batch
    # the reference's forward at a cache that holds the patches
    kw = {"patches": jnp.asarray(batch["patches"].numpy())}
    h, caches, _ = jtf.forward(
        jparams, jcfg, jnp.asarray(batch["tokens"].numpy(), jnp.int32),
        mode="prefill", cache_len=cfg.n_patches + 4 + 5, scan=False, **kw)
    want = [jnp.argmax(jtf.logits_last(jparams, jcfg, h), -1)]
    for _ in range(4):
        h, caches, _ = jtf.forward(jparams, jcfg, want[-1][:, None],
                                   mode="decode", caches=caches, scan=False)
        want.append(jnp.argmax(jtf.logits_last(jparams, jcfg, h), -1))
    np.testing.assert_array_equal(
        res["tokens"], np.stack([np.asarray(t) for t in want], axis=1))


def test_serve_keeps_the_patches_when_gen_len_is_below_n_patches():
    """gen_len 3 < 8 patches: the reference's ``serve.py`` would size its
    caches 4 + 3 = 7 slots for 12 prefill positions and drop the writes
    past the end; the port's hold 8 + 4 + 3, and each generated token is
    the greedy token of a prefill of the prompt extended by the ones
    before it."""
    _, cfg = _configs()
    params = tf.init_params(cfg, seed=2, device="cpu")
    res = serve.serve(cfg, requests=2, prompt_len=4, gen_len=3,
                      device="cpu", params=params)
    toks = torch.as_tensor(res["tokens"])
    batch = serve.draw_batch(cfg, np.random.default_rng(0), 2, 4,
                             device="cpu")
    h = _extended_prefill(params, cfg, batch, toks[:, :-1])
    logits = h[:, -3:].float() @ params["head"]["table"].float().T
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), res["tokens"])


def test_prefill_without_patches_raises():
    _, cfg = _configs()
    params = tf.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="patches"):
        tf.forward(params, cfg, torch.zeros(1, 3, dtype=torch.long),
                   mode="prefill")
    with pytest.raises(ValueError, match="patches"):
        make_prefill_step(cfg)(params, {"tokens": torch.zeros(
            1, 3, dtype=torch.long)})


def test_params_from_jax_keeps_every_parameter():
    jcfg, cfg = _configs()
    jparams, params = _params(jcfg)
    assert tf.n_params(params) == jtf.n_params(jparams)
    assert "encoder" not in params
    own = tf.init_params(cfg, seed=0, device="cpu")
    assert tf.n_params(own) == tf.n_params(params)


def test_serve_cli_prints_the_reference_lines(capsys):
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                "--requests", "2", "--prompt-len", "4", "--gen-len", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("prefill: 2 x 4 tokens")
    assert lines[1].startswith("decode:  2 x 3 tokens")
    assert lines[2].startswith("sample continuation (request 0): [")
