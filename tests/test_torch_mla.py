"""repro_torch's multi-head latent attention (MLA, ``models/attention.py``)
against repro's, on the CPU: ``init_mla``'s tree, ``mla_forward`` with its
latents, ``fill_mla_cache`` and ``mla_decode``, at ``reduced()``'s dims and
at a wider configuration with deepseek-v3's ratios (latent 4 x the nope
head size, rope half of it, q latent 3 x the kv latent), with the same
weights in both; and, within the port, decode against teacher forcing and
the cache's bounds.  The whole reduced deepseek-v3 model is in
``test_torch_moe.py``.

Tolerance: 2e-5 in float32 (the same products summed in another order)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import attention as jattn
from repro_torch.configs.base import get_config
from repro_torch.models import attention

# tiny shapes, several pytest workers: one intra-op thread each keeps
# torch's pool from oversubscribing the CPU
torch.set_num_threads(1)

TOL = 2e-5
# deepseek-v3-671b's MLA (d 7168, 128 heads, q/kv latents 1536 / 512,
# nope / rope / v 128 / 64 / 128) at 1/16 of its heads and 1/4 of its head
# sizes
WIDE = dict(d_model=512, n_heads=8, n_kv_heads=8)
WIDE_MLA = dict(q_lora_rank=384, kv_lora_rank=128, rope_head_dim=16,
                nope_head_dim=32, v_head_dim=32)


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _configs(width):
    out = []
    for get in (jget_config, get_config):
        cfg = get("deepseek-v3-671b").reduced()
        if width == "wide":
            cfg = dataclasses.replace(cfg, **WIDE, mla=dataclasses.replace(
                cfg.mla, **WIDE_MLA))
        out.append(cfg)
    return tuple(out)


def _params(jcfg):
    """(reference MLA parameters, the port's copy of them)."""
    jp = jattn.init_mla(jax.random.key(3), jcfg)
    tree = jax.tree.map(np.asarray, jp)
    return jp, {k: ({"scale": _t(v["scale"])} if isinstance(v, dict)
                    else _t(v)) for k, v in tree.items()}


def _reference(jcfg):
    """The reference's ``mla_forward`` (with the latents) and
    ``mla_decode``, each under ``jax.jit``."""
    return (jax.jit(lambda p, x: jattn.mla_forward(p, x, jcfg,
                                                   return_latent=True)),
            jax.jit(lambda p, x, c: jattn.mla_decode(p, x, c, jcfg)))


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("width", ["reduced", "wide"])
def test_init_mla_builds_the_reference_tree(width):
    jcfg, cfg = _configs(width)
    shapes = jax.tree.map(lambda a: tuple(a.shape), jax.eval_shape(
        lambda k: jattn.init_mla(k, jcfg), jax.random.key(0)))
    p = attention.init_mla(torch.Generator().manual_seed(0), cfg)
    assert jax.tree.map(lambda a: tuple(a.shape), p) == shapes
    assert torch.equal(p["kv_norm"]["scale"], torch.ones(
        cfg.mla.kv_lora_rank))


@pytest.mark.parametrize("width", ["reduced", "wide"])
def test_mla_forward_matches_reference(width):
    """A causal prefill: the output and both latents (c_kv, the rotated
    shared k_rope) within 2e-5."""
    jcfg, cfg = _configs(width)
    jp, p = _params(jcfg)
    x = _x(cfg, 2, 12, seed=1)
    want, (jckv, jkrope) = _reference(jcfg)[0](jp, jnp.asarray(x))
    got, (ckv, krope) = attention.mla_forward(p, _t(x), cfg,
                                              return_latent=True)
    assert ckv.shape == (2, 12, cfg.mla.kv_lora_rank)
    assert krope.shape == (2, 1, 12, cfg.mla.rope_head_dim)
    for g, w in ((got, want), (ckv, jckv), (krope, jkrope)):
        _close(g, w)
    _close(attention.mla_forward(p, _t(x), cfg), want)


@pytest.mark.parametrize("width", ["reduced", "wide"])
def test_mla_cache_and_decode_match_reference(width):
    """A 7-token prefill into a 12-slot cache, then 5 decode steps: the
    filled caches, every step's output and the caches after each step
    within 2e-5 of ``fill_mla_cache`` / ``mla_decode``, the port writing
    its cache in place."""
    jcfg, cfg = _configs(width)
    jp, p = _params(jcfg)
    x = _x(cfg, 2, 12, seed=2)
    forward, decode = _reference(jcfg)
    _, (jckv, jkrope) = forward(jp, jnp.asarray(x[:, :7]))
    jc = jattn.fill_mla_cache(jattn.init_mla_cache(jcfg, 2, 12), jckv,
                              jkrope)
    _, (ckv, krope) = attention.mla_forward(p, _t(x[:, :7]), cfg,
                                            return_latent=True)
    fresh = attention.init_mla_cache(cfg, 2, 12)
    c = attention.fill_mla_cache(fresh, ckv, krope)
    assert c["ckv"] is fresh["ckv"] and c["idx"] == 7 == int(jc["idx"])
    for i in range(7, 12):
        for key in ("ckv", "krope"):
            _close(c[key], jc[key])
        jy, jc = decode(jp, jnp.asarray(x[:, i:i + 1]), jc)
        y, c = attention.mla_decode(p, _t(x[:, i:i + 1]), c, cfg)
        _close(y, jy)
        assert c["idx"] == i + 1 == int(jc["idx"])
    for key in ("ckv", "krope"):
        _close(c[key], jc[key])


def test_mla_decode_matches_teacher_forcing():
    """Within the port: decoding position t against the cache of a prefill
    of ``[0, t)`` gives the last row of a prefill of ``[0, t]``."""
    _, cfg = _configs("wide")
    p = attention.init_mla(torch.Generator().manual_seed(1), cfg)
    x = _t(_x(cfg, 2, 10, seed=4))
    _, (ckv, krope) = attention.mla_forward(p, x[:, :6], cfg,
                                            return_latent=True)
    c = attention.fill_mla_cache(attention.init_mla_cache(cfg, 2, 10), ckv,
                                 krope)
    for t in range(6, 10):
        y, c = attention.mla_decode(p, x[:, t:t + 1], c, cfg)
        _close(y[:, 0], attention.mla_forward(p, x[:, :t + 1], cfg)[:, -1])


def test_mla_cache_bounds():
    _, cfg = _configs("reduced")
    p = attention.init_mla(torch.Generator().manual_seed(0), cfg)
    x = _t(_x(cfg, 1, 5, seed=5))
    _, (ckv, krope) = attention.mla_forward(p, x, cfg, return_latent=True)
    with pytest.raises(ValueError, match="does not fit"):
        attention.fill_mla_cache(attention.init_mla_cache(cfg, 1, 4), ckv,
                                 krope)
    c = attention.fill_mla_cache(attention.init_mla_cache(cfg, 1, 6), ckv,
                                 krope)
    _, c = attention.mla_decode(p, x[:, :1], c, cfg)
    with pytest.raises(ValueError, match="full"):
        attention.mla_decode(p, x[:, :1], c, cfg)
