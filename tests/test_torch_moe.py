"""repro_torch's MoE FFN (``models/moe.py``) and the MoE models against
repro's, on the CPU: the capacity, the routing (expert ids, positions and
keep mask bitwise, the dispatch buffer exactly), ``moe_forward``'s output
and metrics, a case with drops, and prefill + greedy decode of reduced
deepseek-v3-671b (MLA + MoE), moonshot-v1-16b-a3b (attention + MoE) and
jamba-1.5-large-398b with its expert layers, with the reference's
parameters carried over by ``params_from_jax``.  The reference models run
under ``jax.jit`` (one compile a shape, as the reference's serving steps
run them).

Tolerances: 2e-5 for float32 outputs and hidden states (products summed
in another order), 1e-6 for the metrics.  Routing is compared bitwise;
a test states the smallest gap between the k-th and (k+1)-th router logit
of its inputs, so that a flip at a near-tie could not pass unseen."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch.configs.base import get_config
from repro_torch.launch import serve
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_jax
from repro_torch.train.steps import make_decode_step, make_prefill_step

# tiny shapes, several pytest workers: one intra-op thread each keeps
# torch's pool from oversubscribing the CPU
torch.set_num_threads(1)

TOL, METRIC_TOL = 2e-5, 1e-6
MODELS = ["deepseek-v3-671b", "moonshot-v1-16b-a3b", "jamba-1.5-large-398b"]


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _tree(jtree):
    """A reference parameter tree as the port's tensors."""
    if isinstance(jtree, dict):
        return {k: _tree(v) for k, v in jtree.items()}
    return _t(jtree)


# name -> (architecture, MoE fields replaced in its reduced config)
CASES = {
    "moonshot": ("moonshot-v1-16b-a3b", {}),        # 4 experts top-2, shared
    "deepseek": ("deepseek-v3-671b", {}),
    "jamba": ("jamba-1.5-large-398b", {}),          # no shared expert
    "wide": ("deepseek-v3-671b", dict(n_experts=16, top_k=4, d_expert=48,
                                      capacity_factor=1.25)),
    "tight": ("moonshot-v1-16b-a3b", dict(n_experts=8, capacity_factor=0.25)),
}


def _configs(case):
    arch, changes = CASES[case]
    return tuple(_with_moe(get(arch).reduced(), **changes)
                 for get in (jget_config, get_config))


def _with_moe(cfg, **changes):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            **changes))


def _moe_inputs(case, b=2, s=24):
    jcfg, cfg = _configs(case)
    jp = jmoe.init_moe(jax.random.key(1), jcfg, jnp.float32)
    x = np.random.default_rng(len(case)).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, _tree(jax.tree.map(np.asarray, jp)), x


def _reference_moe(jp, x, jcfg):
    """The reference's router logits, top-k ids, per-row dispatch and
    ``moe_forward`` on ``x``, under one ``jax.jit``."""
    cap = jmoe._capacity(x.shape[1], jcfg)

    def run(jp, x):
        logits = x @ jp["router"]
        disp, meta = jax.vmap(lambda xr, lr: jmoe._dispatch_row(
            xr, lr, cap, jcfg.moe))(x, logits)
        expert = jax.lax.top_k(logits, jcfg.moe.top_k)[1]
        return logits, expert, disp, meta, jmoe.moe_forward(jp, x, jcfg)

    return jax.tree.map(np.asarray, jax.jit(run)(jp, jnp.asarray(x)))


def _min_topk_gap(logits, k):
    """The smallest gap between a token's k-th and (k+1)-th logit,
    relative to the largest logit."""
    top = np.sort(np.asarray(logits), axis=-1)[..., ::-1]
    return float((top[..., k - 1] - top[..., k]).min()
                 / np.abs(top).max())


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "moonshot-v1-16b-a3b",
                                  "jamba-1.5-large-398b"])
@pytest.mark.parametrize("reduced", [False, True])
def test_capacity_matches_reference(arch, reduced):
    jcfg, cfg = jget_config(arch), get_config(arch)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    for n in (1, 7, 24, 128, 512, 4096):
        assert moe._capacity(n, cfg) == jmoe._capacity(n, jcfg)
    if arch == "deepseek-v3-671b" and not reduced:
        # decode never drops; a 512-token prefill row has 24 slots for a
        # mean load of 16
        assert (moe._capacity(1, cfg), moe._capacity(512, cfg)) == (8, 24)


@pytest.mark.parametrize("case", sorted(CASES))
def test_routing_matches_reference(case):
    """Expert ids, positions, slots and keep mask bitwise, gates within
    1e-6, and the dispatch buffer exactly the reference's (B, E, C, d)
    with its first two axes swapped."""
    jcfg, cfg, jp, p, x = _moe_inputs(case)
    m = cfg.moe
    cap = moe._capacity(x.shape[1], cfg)
    jlogits, jexpert, jdisp, (je, jpos, jgates, jkeep), _ = _reference_moe(
        jp, x, jcfg)
    logits = _t(x) @ p["router"]
    _close(logits, jlogits, 1e-5)
    gap = _min_topk_gap(jlogits, m.top_k)
    assert gap > 1e-4, f"a near-tie in the inputs: top-k gap {gap}"

    r = moe.route(logits, cap, m.top_k)
    e_safe, p_safe = moe._slots(r, m.n_experts)
    np.testing.assert_array_equal(r.expert.numpy(), np.asarray(jexpert))
    np.testing.assert_array_equal(e_safe.numpy(), np.asarray(je))
    np.testing.assert_array_equal(p_safe.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(r.keep.numpy(), np.asarray(jkeep))
    _close(r.gates, jgates, METRIC_TOL)
    disp = moe.dispatch(_t(x), r, cap, m.n_experts)
    want = np.asarray(jdisp).transpose(1, 0, 2, 3).reshape(disp.shape)
    np.testing.assert_array_equal(disp.numpy(), want)
    if case == "tight":
        assert not r.keep.all()


def test_dispatch_fills_each_expert_from_slot_zero():
    """Under tight capacity the kept pairs take each expert's slots 0, 1,
    ... in (token, slot) order, no slot twice; every dropped pair ranks
    at or past the capacity."""
    _, cfg, _, p, x = _moe_inputs("tight", b=3, s=40)
    m = cfg.moe
    cap = moe._capacity(x.shape[1], cfg)
    r = moe.route(_t(x) @ p["router"], cap, m.top_k)
    assert not r.keep.all() and r.keep.any()
    for row in range(x.shape[0]):
        flat = r.expert[row].reshape(-1)
        for e in range(m.n_experts):
            mine = flat == e
            pos = r.pos[row][mine]
            np.testing.assert_array_equal(pos.numpy(), np.arange(len(pos)))
            np.testing.assert_array_equal(r.keep[row][mine].numpy(),
                                          pos.numpy() < cap)


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_forward_matches_reference(case):
    jcfg, cfg, jp, p, x = _moe_inputs(case)
    jy, jm = _reference_moe(jp, x, jcfg)[-1]
    y, mm = moe.moe_forward(p, _t(x), cfg)
    _close(y, jy)
    for key in ("moe_aux_loss", "moe_drop_frac"):
        _close(mm[key], jm[key], METRIC_TOL)
    drop = float(mm["moe_drop_frac"])
    if case == "tight":
        assert drop > 0
    elif case != "wide":
        assert drop == 0.0        # reduced(): a capacity factor of 8


def test_init_moe_keeps_the_router_float32():
    """The router is float32 whatever the dtype; the expert stacks are
    (E, d, f) / (E, f, d) as the reference's; the shared expert is one
    SwiGLU of width n_shared * d_expert."""
    for case in ("moonshot", "jamba"):
        jcfg, cfg = _configs(case)
        jp = jmoe.init_moe(jax.random.key(0), jcfg, jnp.bfloat16)
        p = moe.init_moe(torch.Generator().manual_seed(0), cfg,
                         torch.bfloat16)
        assert p["router"].dtype == torch.float32
        assert p["w_gate"].dtype == torch.bfloat16
        shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
        assert jax.tree.map(lambda a: tuple(a.shape), p) == shapes
        assert ("shared" in p) == bool(cfg.moe.n_shared)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

_RUNS = {}


def _reference_tree(params):
    """The port's parameters as the reference's tree of numpy arrays: the
    groups' leaves stacked on a leading ``n_groups`` axis."""
    tree = {k: jax.tree.map(np.asarray, v) for k, v in params.items()
            if k != "groups"}
    tree["groups"] = jax.tree.map(
        lambda *leaves: np.stack(leaves),
        *(jax.tree.map(np.asarray, g) for g in params["groups"]))
    return tree


def _reference_run(name, **moe_changes):
    """The reference's prefill (12 tokens, 16 cache slots) and 3 greedy
    decode steps under ``jax.jit``, on the port's seed-0 parameters in the
    reference's tree (``jax.eval_shape`` of its ``init_params`` gives the
    same keys, shapes and dtypes), and ``params_from_jax`` of that tree;
    computed once per model in a test process (the reference's own init
    compiles for seconds a model)."""
    key = (name, tuple(sorted(moe_changes.items())))
    if key in _RUNS:
        return _RUNS[key]
    jcfg, cfg = (_with_moe(get(name).reduced(), **moe_changes)
                 for get in (jget_config, get_config))
    tree = _reference_tree(tf.init_params(cfg, seed=0, device="cpu"))
    spec = jax.eval_shape(lambda k: jtf.init_params(k, jcfg, jnp.float32),
                          jax.random.key(0))
    assert (jax.tree.map(lambda a: (a.shape, a.dtype), spec)
            == jax.tree.map(lambda a: (a.shape, a.dtype), tree))
    jparams = jax.tree.map(jnp.asarray, tree)
    params = params_from_jax(tree, device="cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 12))
    prefill = jax.jit(lambda p, t: jtf.forward(
        p, jcfg, t, mode="prefill", cache_len=16))
    decode = jax.jit(lambda p, t, c: jtf.forward(
        p, jcfg, t, mode="decode", caches=c))
    steps = []
    h, caches, aux = prefill(jparams, jnp.asarray(toks, jnp.int32))
    for i in range(4):
        logits = jtf.logits_last(jparams, jcfg, h)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        steps.append((np.asarray(h), np.asarray(aux), np.asarray(logits),
                      np.asarray(tok)))
        if i < 3:
            h, caches, aux = decode(jparams, tok[:, None], caches)
    _RUNS[key] = (cfg, tree, params, toks, steps)
    return _RUNS[key]


@pytest.mark.parametrize("name", MODELS)
def test_prefill_and_decode_match_reference(name):
    """Prefill plus 3 greedy decode steps: hidden states and last logits
    within 2e-5, the same tokens and ``aux`` within 1e-6 of
    ``repro.models.transformer.forward``."""
    cfg, _, params, toks, steps = _reference_run(name)
    with torch.inference_mode():
        h, caches, aux = tf.forward(params, cfg, _t(toks), mode="prefill",
                                    cache_len=16)
        for i, (jh, jaux, jlogits, jtok) in enumerate(steps):
            logits = tf.logits_last(params, cfg, h)
            tok = logits.argmax(-1)
            _close(h, jh)
            _close(logits, jlogits)
            _close(aux, jaux, METRIC_TOL)
            np.testing.assert_array_equal(tok.numpy(), jtok)
            assert aux.dtype == torch.float32 and aux.shape == (2,)
            assert float(aux[1]) == 0.0                # reduced: no drops
            if i < 3:
                h, caches, aux = tf.forward(params, cfg, tok[:, None],
                                            mode="decode", caches=caches)


def test_tight_capacity_model_drops_and_matches_reference():
    """Reduced moonshot with a capacity factor of 0.5: the prefill drops
    pairs, and hidden states, tokens and ``aux`` still match the
    reference's through the decode steps (which never drop)."""
    cfg, _, params, toks, steps = _reference_run(
        "moonshot-v1-16b-a3b", capacity_factor=0.5)
    assert steps[0][1][1] > 0
    with torch.inference_mode():
        h, caches, aux = tf.forward(params, cfg, _t(toks), mode="prefill",
                                    cache_len=16)
        for i, (jh, jaux, _, jtok) in enumerate(steps):
            _close(h, jh)
            _close(aux, jaux, METRIC_TOL)
            tok = tf.logits_last(params, cfg, h).argmax(-1)
            np.testing.assert_array_equal(tok.numpy(), jtok)
            if i < 3:
                h, caches, aux = tf.forward(params, cfg, tok[:, None],
                                            mode="decode", caches=caches)
    assert float(steps[0][1][1]) > 0 and float(aux[1]) == 0.0


def _pairs(port, ref, g):
    if isinstance(ref, dict):
        assert set(port) == set(ref)
        for key in ref:
            yield from _pairs(port[key], ref[key], g)
    else:
        yield port, (ref if g is None else ref[g])


@pytest.mark.parametrize("name", MODELS)
def test_params_from_jax_keeps_every_leaf(name):
    """The MLA and MoE trees arrive whole from a tree of the reference's
    keys, shapes and dtypes: every leaf with its values, the expert stacks
    (E, d, f) per group, the router float32."""
    cfg, ref, params, _, _ = _reference_run(name)
    assert tf.n_params(params) == sum(a.size for a in jax.tree.leaves(ref))
    assert len(params["groups"]) == cfg.n_groups
    pairs = [pr for key in ref if key != "groups"
             for pr in _pairs(params[key], ref[key], None)]
    for g in range(cfg.n_groups):
        pairs += list(_pairs(params["groups"][g], ref["groups"], g))
    for got, want in pairs:
        assert got.dtype == torch.from_numpy(want).dtype
        np.testing.assert_array_equal(got.numpy(), want)
    moe_layers = [lp["ffn"] for gp in params["groups"] for lp in gp.values()
                  if "router" in lp["ffn"]]
    assert moe_layers
    m = cfg.moe
    for ffn in moe_layers:
        assert ffn["router"].dtype == torch.float32
        assert ffn["w_gate"].shape == (m.n_experts, cfg.d_model, m.d_expert)
        assert ffn["w_down"].shape == (m.n_experts, m.d_expert, cfg.d_model)


@pytest.mark.parametrize("name", MODELS)
def test_decode_matches_teacher_forcing(name):
    """Within the port: each decode step against the prefill caches gives
    the last hidden state of a prefill of the extended sequence (the
    reduced capacity factor never drops, so both route alike)."""
    cfg = get_config(name).reduced()
    params = tf.init_params(cfg, seed=1, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab, (2, 12)))
    _, caches, _ = make_prefill_step(cfg, cache_len=12)(
        params, {"tokens": toks[:, :9]})
    decode = make_decode_step(cfg)
    for t in range(9, 12):
        with torch.inference_mode():
            h_dec, caches, aux = tf.forward(params, cfg, toks[:, t:t + 1],
                                            mode="decode", caches=caches)
            h_full, _, aux_full = tf.forward(params, cfg, toks[:, :t + 1],
                                             mode="prefill")
        _close(h_dec[:, 0], h_full[:, -1])
        assert float(aux[1]) == float(aux_full[1]) == 0.0
    with pytest.raises(ValueError, match="full"):
        decode(params, caches, toks[:, :1])


@pytest.mark.parametrize("name", MODELS)
def test_serve_runs_on_cpu(name, capsys):
    """The CLI on the CPU when asked; without a card and without
    ``--device cpu`` it raises rather than move to the CPU."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(["--arch", name, "--reduced"])
    serve.main(["--arch", name, "--reduced", "--device", "cpu",
                "--requests", "2", "--prompt-len", "8", "--gen-len", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("prefill: 2 x 8 tokens")
    assert lines[1].startswith("decode:  2 x 3 tokens")
    assert lines[2].startswith("sample continuation (request 0): [")
    res = serve.serve(get_config(name).reduced(), requests=2, prompt_len=8,
                      gen_len=3, device="cpu")
    assert res["tokens"].shape == (2, 3)
    assert res["moe_drop_frac_prefill"] == res["moe_drop_frac_decode"] == 0
