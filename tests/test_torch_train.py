"""repro_torch's training substrate against repro's, on the CPU: K5's
backward (its plain version, which the CPU runs, against ``torch.autograd``
of the plain forward and ``jax.grad`` of the reference's ``_sdpa`` with its
masks, repeats and zero-padded heads), the data pipeline (bitwise), the
AdamW schedule and update, int8 gradient compression, and whole train
steps: three steps of reduced smollm-135m and qwen3-1.7b against the
reference's ``make_train_step`` on a 1 x 1 host mesh, and the reference's
own properties of the step (accumulation equals one step, the loss
descends, remat changes no number).  The model families' train-mode
forward, loss and gradients are in ``test_torch_train_models.py``; on a
card K5's backward runs in ``test_torch_cuda.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_config as jget_config
from repro.data import pipeline as jpipe
from repro.launch.mesh import compat_make_mesh
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.train import compress as jgc
from repro.train import optimizer as jopt
from repro.train.steps import make_train_step as jmake_train_step
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.data import pipeline
from repro_torch.kernels import ops, plain
from repro_torch.models import transformer as tf
from repro_torch.models.convert import opt_from_jax, params_from_jax
from repro_torch.train import compress as gc
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.steps import make_train_step

# tiny shapes, several pytest workers: one intra-op thread each
torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.array(x))


def _rng_f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# K5's backward (plain)
# ---------------------------------------------------------------------------

# (B, H, live, Hkv, S, T, D, causal, window)
BWD_CASES = {
    "causal": (2, 4, 4, 4, 9, 9, 16, True, None),
    "noncausal_cross": (2, 4, 4, 2, 5, 13, 16, False, None),
    "window": (1, 4, 4, 2, 20, 20, 16, True, 6),
    "group_padded": (2, 8, 6, 2, 11, 11, 16, True, None),
    "d256_window_padded": (1, 4, 2, 1, 12, 12, 256, True, 5),
}
# float32 sums in another order: dq, dk, dv within 2e-5 of the largest
# gradient of their kind
BWD_TOL = 2e-5


def _bwd_inputs(case, seed=0):
    b, h, live, hkv, s, t, d, causal, window = BWD_CASES[case]
    rng = np.random.default_rng(seed)
    q, do = _rng_f32(rng, b, h, s, d), _rng_f32(rng, b, h, s, d)
    k, v = _rng_f32(rng, b, hkv, t, d), _rng_f32(rng, b, hkv, t, d)
    kw = {"causal": causal, "live_heads": live, "window": window}
    return q, k, v, do, kw


def _rel_close(got, want, tol=BWD_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_plain_backward_matches_autograd(case):
    q, k, v, do, kw = _bwd_inputs(case)
    qt, kt, vt = (_t(x).requires_grad_(True) for x in (q, k, v))
    out, lse = plain.flash_attention_plain(qt, kt, vt, return_lse=True, **kw)
    want = torch.autograd.grad(out, (qt, kt, vt), _t(do))
    got = plain.flash_attention_backward_plain(
        _t(q), _t(k), _t(v), out.detach(), _t(do), lse.detach(), **kw)
    for g, w in zip(got, want):
        _rel_close(g, w)
    if kw["live_heads"] < q.shape[1]:
        assert not got[0][:, kw["live_heads"]:].any()


def _reference_attention(q, k, v, causal, live, window):
    """The reference's GQA attention core: K/V repeated to the live heads
    (``jnp.repeat``), zero-padded to all H, and ``_sdpa`` under its masks
    (``_causal_mask`` or all-visible)."""
    h, s, t = q.shape[1], q.shape[2], k.shape[2]
    rep = live // k.shape[1]
    pad = ((0, 0), (0, h - live), (0, 0), (0, 0))
    kk = jnp.pad(jattn._repeat_kv(k, rep), pad)
    vv = jnp.pad(jattn._repeat_kv(v, rep), pad)
    mask = (jattn._causal_mask(s, t, window) if causal
            else jnp.ones((1, 1, s, t), bool))
    return jattn._sdpa(q, kk, vv, mask, q.shape[-1] ** -0.5)


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_plain_backward_matches_jax_grad_of_reference(case):
    """K5's backward (the wrapper, on the CPU its plain version) through
    ``flash_attention_train`` against ``jax.grad`` of the reference's
    masked, repeated, zero-padded ``_sdpa``; dq of a padded head exactly
    zero."""
    q, k, v, do, kw = _bwd_inputs(case, seed=1)
    causal, live, window = kw["causal"], kw["live_heads"], kw["window"]

    def f(q_, k_, v_):
        out = _reference_attention(q_, k_, v_, causal, live, window)
        return jnp.sum(out * jnp.asarray(do))

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                            for x in (q, k, v)))
    qt, kt, vt = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = ops.flash_attention_train(qt, kt, vt, **kw)
    got = torch.autograd.grad(out, (qt, kt, vt), _t(do))
    for g, w in zip(got, want):
        _rel_close(g, w)
    assert not got[0][:, live:].any()


def test_forward_lse_is_base_two_and_leaves_the_output():
    q, k, v, _, kw = _bwd_inputs("group_padded")
    out0 = ops.flash_attention(_t(q), _t(k), _t(v), **kw)
    out, lse = ops.flash_attention(_t(q), _t(k), _t(v), return_lse=True,
                                   **kw)
    assert torch.equal(out, out0) and lse.dtype == torch.float32
    live = kw["live_heads"]
    assert lse.shape == q.shape[:3] and not lse[:, live:].any()
    # natural log-sum-exp of the reference's masked logits, times log2(e)
    rep = live // k.shape[1]
    logits = (np.einsum("bhsd,bhtd->bhst", q[:, :live],
                        np.repeat(k, rep, axis=1)) * q.shape[-1] ** -0.5)
    s, t = logits.shape[-2:]
    logits = np.where(np.tril(np.ones((s, t), bool)), logits, -np.inf)
    m = logits.max(-1, keepdims=True)
    want = (m[..., 0] + np.log(np.exp(logits - m).sum(-1))) / np.log(2.0)
    np.testing.assert_allclose(lse[:, :live].numpy(), want, rtol=1e-5,
                               atol=1e-5)


def test_backward_wrapper_checks_its_inputs():
    q, k, v, do, kw = _bwd_inputs("causal")
    out, lse = ops.flash_attention(_t(q), _t(k), _t(v), return_lse=True,
                                   **kw)
    with pytest.raises(ValueError, match="lse must be float32"):
        ops.flash_attention_backward(_t(q), _t(k), _t(v), out, _t(do),
                                     lse[:, :, :-1], **kw)
    with pytest.raises(ValueError, match="must have q's shape"):
        ops.flash_attention_backward(_t(q), _t(k), _t(v), out[:, :, :-1],
                                     _t(do), lse, **kw)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention_backward(_t(q), _t(k), _t(v), out, _t(do), lse,
                                     causal=False, window=3)


def test_flash_attention_train_under_checkpoint():
    """The autograd Function recomputed under a non-reentrant checkpoint
    gives the gradients of the plain run, bitwise."""
    q, k, v, do, kw = _bwd_inputs("window")
    grads = []
    for remat in (False, True):
        qt, kt, vt = (_t(x).requires_grad_(True) for x in (q, k, v))

        def f(a, b, c):
            return ops.flash_attention_train(a * 1.5, b, c, **kw)

        out = (torch.utils.checkpoint.checkpoint(f, qt, kt, vt,
                                                 use_reentrant=False)
               if remat else f(qt, kt, vt))
        grads.append(torch.autograd.grad(out, (qt, kt, vt), _t(do)))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# data pipeline, optimizer, compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["smollm-135m", "whisper-tiny",
                                  "internvl2-26b"])
def test_pipeline_batches_are_bitwise_the_references(name):
    cfg, jcfg = get_config(name).reduced(), jget_config(name).reduced()
    for seq, b, step in ((24, 3, 0), (40, 2, 7)):
        got = pipeline.make_batch_for(cfg, ShapeConfig("s", seq, b, "train"),
                                      seed=2, step=step)
        want = jpipe.make_batch_for(jcfg, JShapeConfig("s", seq, b, "train"),
                                    seed=2, step=step)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
    if cfg.n_patches:       # the patch positions are labelled 0
        assert not got["labels"][:, :cfg.n_patches].any()
    pipe = pipeline.SyntheticTextPipeline(cfg.vocab, 16, 6, seed=3, step=4)
    jp = jpipe.SyntheticTextPipeline(cfg.vocab, 16, 6, seed=3, step=4)
    for sl in (None, slice(2, 5)):
        a, b_ = pipe.next_batch(sl), jp.next_batch(sl)
        for key in b_:
            np.testing.assert_array_equal(a[key], b_[key])
    assert pipe.state() == jp.state() == {"step": 6, "seed": 3}


def test_schedule_matches_reference():
    for acfg in (opt_mod.AdamWConfig(),
                 opt_mod.AdamWConfig(lr=1e-3, warmup_steps=0,
                                     decay_steps=50, min_lr_frac=0.2)):
        jacfg = jopt.AdamWConfig(**dataclasses.asdict(acfg))
        for step in (0, 1, 37, 99, 100, 101, 5000, 9999, 10000, 20000):
            got = opt_mod.schedule(acfg, torch.tensor(step, dtype=torch.int32))
            want = jopt.schedule(jacfg, jnp.asarray(step, jnp.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6)


def _random_tree(rng):
    return {"a": {"w": _rng_f32(rng, 5, 3), "b": _rng_f32(rng, 3)},
            "z": _rng_f32(rng, 7)}


def test_adamw_update_matches_reference():
    """Three updates of a random tree (one gradient clipped, one not) in
    place against the reference's functional ones: parameters, state and
    metrics within float32 rounding."""
    rng = np.random.default_rng(0)
    acfg = opt_mod.AdamWConfig(lr=1e-2, warmup_steps=2, decay_steps=10)
    jacfg = jopt.AdamWConfig(**dataclasses.asdict(acfg))
    tree = _random_tree(rng)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = {"a": {k: _t(v) for k, v in tree["a"].items()},
              "z": _t(tree["z"])}
    jstate, state = jopt.init_adamw(jparams), opt_mod.init_adamw(params)
    for i, scale in enumerate((0.05, 3.0, 0.5)):
        g = jax.tree.map(lambda x: x * scale, _random_tree(rng))
        jparams, jstate, jm = jopt.adamw_update(
            jparams, jax.tree.map(jnp.asarray, g), jstate, jacfg)
        grads = {"a": {k: _t(v) for k, v in g["a"].items()}, "z": _t(g["z"])}
        same = params
        params, state, m = opt_mod.adamw_update(params, grads, state, acfg)
        assert params is same and int(state["count"]) == i + 1
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(m[key].numpy(), np.asarray(jm[key]),
                                       rtol=1e-6)
        for part, jpart in ((params, jparams), (state["master"],
                                                jstate["master"]),
                            (state["m"], jstate["m"]),
                            (state["v"], jstate["v"])):
            for a, b in opt_mod.tree_zip(part, jpart):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=2e-6, atol=1e-7)


def test_compress_decompress_is_bitwise_the_references():
    rng = np.random.default_rng(1)
    g = {"a": _rng_f32(rng, 64) * 3e-3, "b": _rng_f32(rng, 8, 5) * 40.0}
    err = {"a": _rng_f32(rng, 64) * 1e-5, "b": np.zeros((8, 5), np.float32)}
    deq, new_err = gc.compress_decompress(
        {k: _t(v) for k, v in g.items()}, {k: _t(v) for k, v in err.items()})
    jdeq, jerr = jgc.compress_decompress(jax.tree.map(jnp.asarray, g),
                                         jax.tree.map(jnp.asarray, err))
    for key in g:
        np.testing.assert_array_equal(deq[key].numpy(), np.asarray(jdeq[key]))
        np.testing.assert_array_equal(new_err[key].numpy(),
                                      np.asarray(jerr[key]))
    q, scale = gc.quantize(_t(g["b"]))
    jq, jscale = jgc.quantize(jnp.asarray(g["b"]))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    zeros = gc.init_error_feedback({"a": _t(g["a"]).bfloat16()})
    assert zeros["a"].dtype == torch.float32 and not zeros["a"].any()


# ---------------------------------------------------------------------------
# whole train steps
# ---------------------------------------------------------------------------

def _np(tree):
    """Copies, not views: the port updates its tensors in place, and
    ``jnp.asarray`` of a view may share the tensor's memory."""
    return jax.tree.map(lambda t: np.array(t, copy=True), tree)


def _reference_tree(params):
    """The port's parameters as the reference's tree of numpy arrays (new
    memory): the groups' (and encoder layers') leaves stacked on a leading
    axis."""
    def stack(layers):
        return jax.tree.map(lambda *xs: np.stack(xs),
                            *(_np(g) for g in layers))

    tree = {k: _np(v) for k, v in params.items()
            if k not in ("groups", "encoder")}
    tree["groups"] = stack(params["groups"])
    if "encoder" in params:
        tree["encoder"] = {"layers": stack(params["encoder"]["layers"]),
                           "norm": _np(params["encoder"]["norm"])}
    return tree


def _leaf_pairs(port, ref_tree, convert=params_from_jax):
    """(path, port leaf, reference leaf converted to the port's tree)."""
    ref = convert(jax.tree.map(np.asarray, ref_tree), device="cpu")

    def walk(a, b, path):
        if isinstance(a, dict):
            for k in a:
                yield from walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            for i, (x, y) in enumerate(zip(a, b)):
                yield from walk(x, y, f"{path}/{i}")
        else:
            yield path, a, b

    return list(walk(port, ref, ""))


# reduced smollm-135m (2 groups) with micro_steps 1, reduced qwen3-1.7b
# (qk_norm, tied embeddings) with micro_steps 2, and reduced rwkv6-7b and
# jamba (their SSM leaves through the optimizer and ``opt_from_jax``) with
# micro_steps 1, 4 x 32 tokens, 3 steps of
# the default AdamWConfig; loss and grad_norm within 2e-5 relative (float32
# sums in another order), lr within float32 rounding; after 3 steps the
# parameters within 2 * (the learning rates summed) of the reference's (an
# Adam step is nearly a sign step, and a gradient near 0 may take either
# sign), the moments within 2e-4 of their largest
STEP_CASES = {"smollm-135m": 1, "qwen3-1.7b": 2, "rwkv6-7b": 1,
              "jamba-1.5-large-398b": 1}


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_train_step_matches_reference_over_three_steps(name):
    micro = STEP_CASES[name]
    cfg, jcfg = get_config(name).reduced(), jget_config(name).reduced()
    shape = ShapeConfig("s", 32, 4, "train")
    params = tf.init_params(cfg, seed=0, device="cpu")
    tree = _reference_tree(params)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init_adamw(jparams)
    state = opt_mod.init_adamw(params)
    mesh = compat_make_mesh((1, 1), ("data", "model"))
    jstep = jmake_train_step(jcfg, mesh, JShapeConfig("s", 32, 4, "train"),
                             dtype=jnp.float32, donate=False,
                             micro_steps=micro)
    step = make_train_step(cfg, micro_steps=micro)
    lr_sum = 0.0
    for i in range(3):
        batch = pipeline.make_batch_for(cfg, shape, step=i)
        jparams, jstate, jm = jstep.fn(
            jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        params, state, m = step(params, state,
                                {k: torch.as_tensor(v).long()
                                 for k, v in batch.items()})
        for key in ("loss", "grad_norm", "moe_aux", "moe_drop"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=2e-5, atol=1e-7)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        lr_sum += float(m["lr"])
    for path, a, b in _leaf_pairs(params, jparams):
        assert (a - b).abs().max() <= 2 * lr_sum, path
    jopt_np = jax.tree.map(np.asarray, jstate)
    ref_state = opt_from_jax(jopt_np, device="cpu")
    assert int(state["count"]) == int(ref_state["count"]) == 3
    for part in ("master", "m", "v"):
        for path, a, b in _leaf_pairs(state[part], jstate[part]):
            tol = 2 * lr_sum if part == "master" else 2e-4 * float(
                b.abs().max())
            assert (a - b).abs().max() <= tol + 1e-12, (part, path)


def _batch(cfg, seq, b, step=0):
    return {k: torch.as_tensor(v).long() if v.dtype.kind == "i"
            else torch.as_tensor(v)
            for k, v in pipeline.make_batch_for(
                cfg, ShapeConfig("s", seq, b, "train"), step=step).items()}


def _clone(tree):
    return opt_mod.tree_map(lambda t: t.clone(), tree)


def test_grad_accumulation_matches_a_single_step():
    """The reference's property on the port: 4 microbatches give the
    full batch's loss and update (accumulated in float32)."""
    cfg = get_config("smollm-135m").reduced()
    params = tf.init_params(cfg, seed=0, device="cpu")
    batch = _batch(cfg, 16, 4)
    out = []
    for micro in (1, 4):
        p = _clone(params)
        p, _, m = make_train_step(cfg, micro_steps=micro)(
            p, opt_mod.init_adamw(p), batch)
        out.append((p, m))
    (p1, m1), (p4, m4) = out
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-4
    d = max(float((a - b).abs().max()) for a, b in zip(
        opt_mod.tree_leaves(p1), opt_mod.tree_leaves(p4)))
    assert d < 1e-4, f"accumulated params diverge by {d}"
    # micro_steps is halved until it divides the batch: 3 -> 1
    p = _clone(params)
    _, _, m3 = make_train_step(cfg, micro_steps=3)(p, opt_mod.init_adamw(p),
                                                   batch)
    assert float(m3["loss"]) == float(m1["loss"])


def test_loss_descends_on_repeated_batch():
    cfg = get_config("smollm-135m").reduced()
    params = tf.init_params(cfg, seed=0, device="cpu")
    state = opt_mod.init_adamw(params)
    step = make_train_step(cfg, acfg=opt_mod.AdamWConfig(
        lr=1e-3, warmup_steps=0))
    batch = _batch(cfg, 32, 4)
    losses = []
    for _ in range(6):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        assert set(m) == {"loss", "moe_aux", "moe_drop", "grad_norm", "lr"}
    assert losses[-1] < losses[0] - 0.01, losses


@pytest.mark.parametrize("name,changes", [
    ("smollm-135m", {"remat": False}),
    ("whisper-tiny", {"remat": False}),
    ("gemma3-4b", {"layer_remat": False}),
    ("rwkv6-7b", {"remat": False}),
    ("jamba-1.5-large-398b", {"remat": False, "layer_remat": False}),
])
def test_remat_changes_no_number(name, changes):
    """Gradients with the group (and layer) checkpoints on and off are
    bitwise equal: the recompute is the same arithmetic.  gemma3 reduced to
    one 17-layer period, so only its per-layer remat applies."""
    cfg = get_config(name).reduced()
    if name == "gemma3-4b":
        cfg = dataclasses.replace(cfg, n_layers=17)
    params = tf.init_params(cfg, seed=0, device="cpu")
    batch = _batch(cfg, 12, 2)
    grads = []
    for c in (cfg, dataclasses.replace(cfg, **changes)):
        leaves = [p.detach().requires_grad_(True)
                  for p in opt_mod.tree_leaves(params)]
        it = iter(leaves)
        live = opt_mod.tree_map(lambda _: next(it), params)
        hidden, _, aux = tf.forward(live, c, batch["tokens"], mode="train",
                                    frames=batch.get("frames"))
        loss = tf.ce_loss(live, c, hidden, batch["labels"], chunk=4)
        grads.append(torch.autograd.grad(loss + 0.01 * aux[0], leaves,
                                         allow_unused=True))
    for a, b in zip(*grads):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("name", ["rwkv6-7b", "jamba-1.5-large-398b"])
def test_ssm_leaves_get_gradients(name):
    """rwkv6 and mamba layers train (ROADMAP Queue A item 12.10, once a
    raise): the train-mode forward is differentiable in every SSM leaf
    (``u``, ``mix``, ``w_base``, ``a_log``, ``d_skip``, ``conv_*``), and
    ``make_train_step`` takes a finite step that moves them."""
    cfg = get_config(name).reduced()
    params = tf.init_params(cfg, seed=0, device="cpu")
    ssm = {"rwkv6": ("u", "mix", "w_base", "w_lora_a", "wr"),
           "mamba": ("a_log", "d_skip", "conv_w", "conv_b", "dt_bias")}
    layers = [(g, f"l{i}", mixer) for g in range(cfg.n_groups)
              for i, (mixer, _) in enumerate(cfg.pattern) if mixer in ssm]
    assert layers
    leaves = {(g, l, k): params["groups"][g][l]["mixer"][k]
              for g, l, mixer in layers for k in ssm[mixer]}
    for t in leaves.values():
        t.requires_grad_(True)
    batch = _batch(cfg, 8, 2)
    hidden, _, aux = tf.forward(params, cfg, batch["tokens"], mode="train")
    loss = tf.ce_loss(params, cfg, hidden, batch["labels"]) + 0.01 * aux[0]
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for key, g in zip(leaves, grads):
        assert torch.isfinite(g).all() and g.abs().max() > 0, key
    before = {key: t.detach().clone() for key, t in leaves.items()}
    for t in leaves.values():
        t.requires_grad_(False)
    _, _, metrics = make_train_step(cfg, micro_steps=1)(
        params, opt_mod.init_adamw(params), batch)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    for key, t in leaves.items():
        assert not torch.equal(t, before[key]), key
