"""repro_torch's dry run (``launch/costs.py``, ``launch/dryrun.py``, the
``meta`` branch of ``kernels/ops.py`` and ``kernels/work.py``) on the CPU.

- Costs against the JAX package's ``launch/costs.py::cell_costs`` on a 1 x
  1 mesh, every attention-only configuration reduced (the SSM and MoE
  ones in ``test_torch_costs_ssm.py``, on another test worker),
  ``ShapeConfig(kind, 64, 2, kind)`` for train, prefill and decode,
  float32: the same components and
  multipliers, and each component's flops (the port's with its outer
  checkpoint's forward once, as the reference's compiled component runs
  it) against the reference's.  Three differences are the
  implementations', not the count's, and are taken out of the reference's
  number before the comparison: its ``jnp.take`` embedding (mode "fill")
  selects every gathered element, where the port's index does no
  arithmetic (XLA's own count of that take, compiled here); its stem
  component adds a stand-in for the groups' output to the embeddings
  before the final norm (``x + x_mid``, one flop an element), where the
  port's traces ``forward`` of a model without groups, which has no such
  add; and its plain
  attention multiplies every (query, key) pair and masks the hidden ones,
  forward and backward, where K5 computes only the visible pairs (counted
  from the configuration: causal and windowed layers).  What is left must
  lie within ``COST_TOL`` for the attention-only configurations; for the
  SSM and MoE ones the stem, head, encoder and optimizer are held to it
  and the groups' ratios are printed (the reference counts a scan's loop
  body once and adds an analytic correction, the port counts K6's and
  K7's own work).
- ``meta`` against the CPU: a reduced model's train step and serve run
  traced on ``meta`` count the same flops and launches as the same code
  run on the CPU (the plain versions recorded as their kernels' work).
- The ``meta`` branch of every kernel wrapper: outputs of the kernel's
  shapes and dtypes, one launch and the work of ``kernels/work.py`` in the
  tally, no launch counted on the wrapper.
- The memory trace's bookkeeping, ``run_cell``'s plan, the gsofa cell
  against the reference's ``core/spaceopt.py`` (bitwise), the CLI, and the
  card default (no capacity and no card raises).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_config as jget_config
from repro.core import spaceopt as jspaceopt
from repro.core.gsofa import SymbolicGraph as JSymbolicGraph
from repro.launch import costs as jcosts
from repro.launch.mesh import compat_make_mesh
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.data.pipeline import make_batch_for
from repro_torch.kernels import ops, plain, work
from repro_torch.kernels.ops import resolve_device
from repro_torch.launch import costs, dryrun
from repro_torch.launch.train import device_batch
from repro_torch.models import transformer as tf
from repro_torch.train.optimizer import init_adamw
from repro_torch.train.steps import (
    make_decode_step, make_prefill_step, make_train_step,
)

torch.set_num_threads(1)

ATTENTION_ONLY = ["gemma3-4b", "internvl2-26b", "qwen3-1.7b", "qwen3-14b",
                  "smollm-135m", "whisper-tiny"]
SSM_OR_MOE = ["deepseek-v3-671b", "jamba-1.5-large-398b",
              "moonshot-v1-16b-a3b", "rwkv6-7b"]
KINDS = ("train", "prefill", "decode")
# each component's flops against the reference's, less the three
# implementation differences above; the largest deviation measured over
# the attention-only configurations is 5.8 % (every decode stem_head:
# 66,562 against 70,640), the train groups' within 2.7 % (gemma3-4b's);
# before the three are taken out, 17.7 % (the prefill stem_heads, 98,944
# against 120,174)
COST_TOL = 0.10


@pytest.fixture(scope="module")
def mesh11():
    return compat_make_mesh((1, 1), ("data", "model"))


def _take_flops(b, s, vocab, d):
    """XLA's flops of the reference's embedding, ``jnp.take(table,
    tokens, axis=0)``, at these shapes."""
    f = jax.jit(lambda t, i: jnp.take(t, i, axis=0)).lower(
        jax.ShapeDtypeStruct((vocab, d), jnp.float32),
        jax.ShapeDtypeStruct((b, s), jnp.int32)).compile()
    return f.cost_analysis()["flops"]


def _visible(s, t, window):
    """Causal (query, key) pairs of s queries over t keys, query i seeing
    min(i + t - s + 1, window) keys."""
    return sum(min(i + t - s + 1, window or t) for i in range(s))


def _masked_attention_flops(cfg, kind, b, s):
    """The flops the reference's plain attention spends on the (query,
    key) pairs a causal or windowed layer hides (a group's layers, at s
    positions): two S x T products a pair forward (twice in train under
    ``layer_remat``), four more backward, 2 * hd flops each, over every
    head."""
    products = {"train": 6 + 2 * cfg.layer_remat, "prefill": 2,
                "decode": 0}[kind]
    pairs = sum(s * s - _visible(s, s, cfg.sliding_window
                                 if mixer == "local" else None)
                for mixer, _ in cfg.pattern if mixer in ("attn", "local"))
    return products * 2 * cfg.hd * b * cfg.n_heads * pairs


def _compare(arch, mesh11):
    """{(kind, component): (port flops, reference flops, the reference's
    less the implementation differences)}."""
    out = {}
    for kind in KINDS:
        jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
        ref = jcosts.cell_costs(jcfg, mesh11, JShapeConfig(kind, 64, 2, kind),
                                dtype=jnp.float32)["components"]
        got = costs.cell_costs(cfg, ShapeConfig(kind, 64, 2, kind))
        comps = got["components"]
        assert set(ref) - {"ssm_scan_correction"} == set(comps)
        b = 2 // got["micro_steps"]
        s = 1 if kind == "decode" else 64
        for name, rec in comps.items():
            assert rec["multiplier"] == ref[name]["multiplier"], (kind, name)
            want = ref[name]["flops"]
            adj = want
            if name == "group":
                adj -= _masked_attention_flops(cfg, kind, b, s)
            elif name == "stem_head":
                adj -= _take_flops(b, s - (cfg.n_patches if kind != "decode"
                                           else 0), cfg.vocab, cfg.d_model)
                adj -= b * s * cfg.d_model          # its ``x + x_mid``
            out[kind, name] = (rec["flops_outer_once"], want, adj)
    return out


def check_components(arch, mesh11):
    """``_compare``'s rows, printed; each within ``COST_TOL`` of the
    reference's less the implementation differences, but for an SSM or
    MoE configuration's groups (their ratios are printed and held to a
    factor of 2 only)."""
    rows = _compare(arch, mesh11)
    for (kind, name), (got, want, adj) in sorted(rows.items()):
        print(f"{arch} {kind} {name}: {got} / {want} = {got / want:.4f}; "
              f"/ {adj} = {got / adj:.4f}")
        if arch in ATTENTION_ONLY or name != "group":
            assert abs(got / adj - 1) <= COST_TOL, (kind, name, got, adj)
        else:
            assert 0.5 < got / want < 2, (kind, name, got, want)


@pytest.mark.parametrize("arch", ATTENTION_ONLY)
def test_cell_costs_components_against_the_references(arch, mesh11):
    check_components(arch, mesh11)


def _train_trace(cfg, device):
    params = tf.init_params(cfg, device=device)
    opt = init_adamw(params)
    batch = device_batch(make_batch_for(cfg, ShapeConfig("t", 64, 2,
                                                         "train")),
                         torch.float32, device)
    step = make_train_step(cfg, micro_steps=1)
    return costs.trace(lambda: step(params, opt, batch), (params, opt,
                                                          batch))


def _serve_trace(cfg, device):
    params = tf.init_params(cfg, device=device)
    batch = {"tokens": torch.zeros((2, 24), dtype=torch.int64,
                                   device=device)}
    if cfg.n_patches:
        batch["patches"] = torch.zeros((2, cfg.n_patches, cfg.d_model),
                                       device=device)
    if cfg.encdec is not None:
        batch["frames"] = torch.zeros((2, cfg.encdec.enc_len, cfg.d_model),
                                      device=device)
    prefill = make_prefill_step(cfg, cache_len=cfg.n_patches + 24 + 4)
    decode = make_decode_step(cfg)

    def run():
        tok, caches, _ = prefill(params, batch)
        for _ in range(3):
            tok, caches, _ = decode(params, caches, tok[:, None])
    return costs.trace(run, (params, batch))


COUNTS = ("product_flops", "elementwise_flops", "transcendentals",
          "kernel_flops", "launches")


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "internvl2-26b",
                                  "jamba-1.5-large-398b", "rwkv6-7b",
                                  "smollm-135m", "whisper-tiny"])
def test_meta_counts_what_a_cpu_run_does(arch):
    """The same reduced step traced on meta and run on the CPU: equal
    flops of every kind and equal launches (the plain versions recorded
    as their kernels), bitwise; a serve run too for the attention and
    recurrent families."""
    cfg = get_config(arch).reduced()
    meta, cpu = _train_trace(cfg, "meta"), _train_trace(cfg, "cpu")
    assert {k: meta[k] for k in COUNTS} == {k: cpu[k] for k in COUNTS}
    assert meta["launches"] or arch == "deepseek-v3-671b"
    if arch in ("smollm-135m", "rwkv6-7b", "whisper-tiny"):
        meta, cpu = _serve_trace(cfg, "meta"), _serve_trace(cfg, "cpu")
        assert {k: meta[k] for k in COUNTS} == {k: cpu[k] for k in COUNTS}


def _kernel_cases():
    rng = np.random.default_rng(0)

    def f32(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32))

    b, h, s, d = 2, 4, 6, 16
    q, k, v, do = f32(b, h, s, d), f32(b, 2, s, d), f32(b, 2, s, d), \
        f32(b, h, s, d)
    o, lse = plain.flash_attention_plain(q, k, v, live_heads=4,
                                         return_lse=True)
    r5 = (f32(2, 5, 3, 16), f32(2, 5, 3, 16), f32(2, 5, 3, 16),
          torch.rand(2, 5, 3, 16), f32(3, 16), f32(2, 3, 16, 16))
    m6 = (f32(2, 5, 8), f32(2, 5, 8).abs(), f32(2, 5, 4), f32(2, 5, 4),
          -f32(8, 4).abs(), f32(8), f32(2, 8, 4))
    rel = torch.as_tensor(rng.integers(-1, 9, (5, 7)).astype(np.int32))
    lanes = [torch.as_tensor(rng.integers(0, 9, 5).astype(np.int32))
             for _ in range(4)]
    acc, lp, up = f32(3, 4), f32(3, 2), f32(2, 4)
    return {
        "minmax_relax": ((torch.zeros((3, 5), dtype=torch.int32),
                          torch.ones((5, 7), dtype=torch.uint8)), {},
                         (work.minmax_relax_work(3, 5, 7, 0)[0], None)),
        "column_fingerprints": ((rel, *lanes), {},
                                work.column_fingerprints_work(5, 7)),
        "panel_update": ((acc, lp, up), {},
                         work.panel_update_work(3, 2, 4, 4)),
        "panel_update_batched": ((acc[None].repeat(2, 1, 1),
                                  lp[None].repeat(2, 1, 1),
                                  up[None].repeat(2, 1, 1)), {},
                                 work.panel_update_work(3, 2, 4, 4, 2)),
        "flash_attention": ((q, k, v), {"live_heads": 4},
                            work.attn_work(b, h, s, s, d, 4, 2)),
        "flash_attention_backward": (
            (q, k, v, o, do, lse), {"live_heads": 4},
            work.k5_bwd_work(b, h, 4, 2, s, s, d, causal=True, window=None)),
        "rwkv6_scan": (r5, {}, work.rwkv6_work(2, 5, 3, 16)),
        "rwkv6_scan_backward": (
            r5 + (f32(2, 5, 3, 16), f32(2, 3, 16, 16)), {},
            (work.rwkv6_bwd_work(2, 5, 3, 16)[0],
             work.rwkv6_bwd_work(2, 5, 3, 16)[1] // 3
             + work.rwkv6_bwd_work(2, 5, 3, 16)[2])),
        "mamba_scan": (m6, {}, work.mamba_work(2, 5, 8, 4)),
        "mamba_scan_backward": (m6 + (f32(2, 5, 8), f32(2, 8, 4)), {},
                                work.mamba_bwd_work(2, 5, 8, 4)),
    }


@pytest.mark.parametrize("name", sorted(_kernel_cases()))
def test_meta_branch_stands_in_for_each_kernel(name):
    """On meta a wrapper returns what it returns on the CPU (shapes and
    dtypes) and records one launch and the kernel's work in the tally; on
    the CPU it records the same; on neither does it count a launch of
    its kernel (``<wrapper>.launches``: none was made)."""
    args, kw, counts = _kernel_cases()[name]
    fn = getattr(ops, name)
    ops.reset_launches()
    work.reset()
    want = fn(*args, **kw)
    got = fn(*(a.to("meta") for a in args), **kw)
    assert ops.launch_counts()[name] == 0
    for g, w in zip(torch.utils._pytree.tree_leaves(got),
                    torch.utils._pytree.tree_leaves(want)):
        assert g.is_meta and g.shape == w.shape and g.dtype == w.dtype
    tally = work.totals()[name]
    assert tally == {"launches": 2, "bytes": 2 * counts[0],
                     "flops": None if counts[1] is None else 2 * counts[1]}


def test_attention_work_is_the_smokes_count():
    """``attn_work``'s closed form of the causal pairs against the sum
    the bounds were first written with."""
    for s, t, window in ((1, 544, None), (512, 512, None), (1536, 1536, 1024),
                         (7, 20, 3), (64, 64, 8), (5, 5, 9)):
        pairs = sum(min(i + t - s + 1, window or t) for i in range(s))
        assert work.attn_work(2, 3, s, t, 16, window=window)[1] == \
            4 * 16 * pairs * 2 * 3
        assert work._causal_pairs(s, t, window or t) == pairs


def test_trace_counts_live_bytes_and_their_peak():
    """The peak of live storages, each rounded to the allocator's 512
    bytes, over the base; views add nothing; a freed tensor's bytes come
    back; logsumexp's hidden temporary counts at its call."""
    base = torch.empty(1000, device="meta")
    with costs.Trace((base,)) as t:
        a = torch.empty(1000, device="meta") * 2     # a product, 4000 B
        view = a.view(10, 100).t()
        b = a + 1
        del a, view
        c = b * 3
        del b, c
        d = torch.logsumexp(torch.empty((4, 256), device="meta"), dim=-1)
        del d
    assert t.base_bytes == 4096
    # base + two 4096-byte tensors at each step up to c; logsumexp: its
    # 4096-byte input, 512-byte output and 4096-byte hidden temporary
    assert t.peak_bytes == 3 * 4096 + 512
    assert t.live_bytes == 4096
    assert t.record()["elementwise_flops"] == 3 * 1000 + 4 * 256


def test_run_cell_plans_a_reduced_train_and_serve_cell():
    cfg = get_config("whisper-tiny").reduced()
    rec = dryrun.run_cell(cfg, ShapeConfig("t", 32, 4, "train"),
                          capacity_bytes=1e9, micro_steps=1)
    st = rec["state_bytes"]
    params = tf.n_params(tf.init_params(cfg, device="meta"))
    assert st["params"] == 4 * params and st["opt"] == 3 * 4 * params + 4
    mem = rec["memory"]
    assert mem["held_bytes"] >= st["params"] + st["opt"] + st["batch"]
    assert mem["peak_bytes"] > mem["held_bytes"] + st["grads"]
    assert mem["activation_bytes"] > 0 and mem["fits"]
    # 2 encoder layers once, 2 decoder groups' self and cross twice
    assert rec["launches"] == {"flash_attention": 2 + 2 * 2 * 2,
                               "flash_attention_backward": 2 + 2 * 2}
    pod = rec["state_bytes_per_device"]["pod"]
    assert pod["params"] < st["params"]
    assert rec["costs"]["totals_per_device"]["collective_bytes"] == 0
    small = dryrun.run_cell(cfg, ShapeConfig("s", 16, 2, "prefill"),
                            capacity_bytes=1e3, gen_len=4, with_costs=False)
    assert not small["memory"]["fits"]
    assert small["launches"] == {"flash_attention": 2 + 2 * 2 * 4}


def test_gsofa_cell_equals_the_references_spaceopt():
    n, k, c, cap = 1 << 20, 16, 64, 80 * 10 ** 9
    rec = dryrun.run_gsofa_cell(n, k, c, capacity_bytes=cap)
    ell = jax.ShapeDtypeStruct((n, k), jnp.int32)
    graph = JSymbolicGraph(n=n, in_ell=ell, out_ell=ell,
                           out_deg=jax.ShapeDtypeStruct((n,), jnp.int32),
                           adj_dense=None)
    assert rec["bytes_per_source"] == jspaceopt.bytes_per_source(graph, "ell")
    assert rec["aux_memory"] == jspaceopt.aux_memory_report(graph, c, "ell")
    assert rec["max_concurrency"] == jspaceopt.auto_concurrency(graph, cap, n,
                                                                "ell")
    assert rec["waves"] == {"one_card": n // c, "pod": n // (256 * c),
                            "multipod": n // (512 * c)}


def test_cli_writes_a_plan(tmp_path, capsys):
    out = tmp_path / "plan.json"
    dryrun.main(["--arch", "qwen3-1.7b", "--reduced", "--shape",
                 "decode_32k", "--capacity-bytes", "85e9", "--no-costs",
                 "--out", str(out)])
    rec = json.loads(out.read_text())
    assert rec["kind"] == "decode" and rec["launches"] == {
        "flash_attention": 2}
    assert "fits True" in capsys.readouterr().out


def test_the_card_stays_the_default():
    cfg = get_config("smollm-135m").reduced()
    with pytest.raises(RuntimeError, match="capacity_bytes"):
        dryrun.run_cell(cfg, "decode_32k")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(ValueError, match="dry run"):
        resolve_device("meta")
    assert resolve_device("meta", meta=True).type == "meta"
