"""One-card dry run: plan a cell before anything is allocated.

    python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k \\
        --capacity-bytes 85e9
    python -m repro_torch.launch.dryrun --gsofa --capacity-bytes 85e9
    python -m repro_torch.launch.dryrun --sweep --capacity-bytes 85e9
    python -m repro_torch.launch.dryrun --arch whisper-tiny --reduced \
        --shape train_4k --capacity-bytes 85e9

The port of the JAX package's ``launch/dryrun.py``.  A cell is (arch x
shape); for each the port's own step runs once on ``meta`` tensors (shapes,
no memory; ``launch/costs.py::Trace``) and the plan records:

- ``params`` / ``active_params`` (the config's analytic counts) and
  ``n_params`` (the port's tree);
- ``state_bytes``: one card's resident state: parameters, the AdamW
  ``master`` / ``m`` / ``v`` (``train/optimizer.py``) and the gradients
  for a train cell; the batch; a decode cell's caches and tokens;
- ``memory``: the predicted peak of the step (the live bytes of the
  ``meta`` trace over the state: the CUDA caching allocator's
  ``max_memory_allocated`` less what was held before), the activations
  the forward leaves for the backward (live bytes at its end, above the
  state) and among them the tensors autograd saves outside checkpoints
  (``saved_tensors_hooks``), the largest transient (the rest of the
  peak), and ``fits``: the peak against
  ``capacity_bytes`` (default: the card's ``total_memory``; without a card
  it must be given);
- ``launches``: the port's kernel launches in the step (a serve cell: the
  prefill and its decode steps), as the card counts them;
- ``state_bytes_per_device`` on the reference's pod (16 x 16) and
  multi-pod (2 x 16 x 16) meshes, from ``train/sharding.py``;
- ``costs``: ``launch/costs.py::cell_costs``.

``run_cell`` takes a cut config too, and ``gen_len`` makes a prefill cell a
serve run (``launch/serve.py``: the prefill of ``shape`` then ``gen_len -
1`` greedy decode steps against caches of ``n_patches + prompt + gen_len``
slots).  ``run_gsofa_cell`` plans the symbolic step's memory from
``core/spaceopt.py``.  What has no counterpart on one card: XLA programs,
``memory_analysis()`` / ``cost_analysis()``, the 512-device lowering and
the collective schedule.  The sweep runs in this process (a ``meta`` cell
needs no subprocess) and writes JSON under ``build/dryrun/``.
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path
from typing import Dict, Optional, Union

import torch

from repro_torch.configs.base import (
    SHAPES, ModelConfig, ShapeConfig, all_configs, cell_is_supported,
    get_config,
)
from repro_torch.launch import costs as C
from repro_torch.models import transformer as tf
from repro_torch.train import sharding as shd
from repro_torch.train.optimizer import init_adamw, tree_leaves, tree_map
from repro_torch.train.steps import (
    _micro_steps, make_decode_step, make_prefill_step, make_train_step,
)

ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
MESHES = {"pod": shd.POD, "multipod": shd.MULTI_POD}


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def card_capacity(capacity_bytes=None) -> int:
    """``capacity_bytes``, or the card's ``total_memory``; raises without
    a card when none is given."""
    if capacity_bytes is not None:
        return int(capacity_bytes)
    if not torch.cuda.is_available():
        raise RuntimeError("the dry run plans for the card's memory and no "
                           "card is available; pass capacity_bytes")
    return torch.cuda.get_device_properties(0).total_memory


def meta_batch(cfg: ModelConfig, batch: int, seq: int, *, train: bool,
               dtype=torch.float32) -> Dict:
    """A train or prefill batch of ``seq`` positions (patches included) on
    ``meta``: ``tokens`` (and ``labels``), ``patches``, ``frames``."""
    dev = torch.device("meta")
    out = {"tokens": torch.empty((batch, seq - cfg.n_patches),
                                 dtype=torch.int64, device=dev)}
    if train:
        out["labels"] = torch.empty((batch, seq), dtype=torch.int64,
                                    device=dev)
    if cfg.n_patches:
        out["patches"] = torch.empty((batch, cfg.n_patches, cfg.d_model),
                                     dtype=dtype, device=dev)
    if cfg.encdec is not None:
        out["frames"] = torch.empty((batch, cfg.encdec.enc_len, cfg.d_model),
                                    dtype=dtype, device=dev)
    return out


def _train_plan(cfg, shape, params, dtype, micro_steps):
    opt = init_adamw(params)
    batch = meta_batch(cfg, shape.global_batch, shape.seq_len, train=True,
                       dtype=dtype)
    state = {"params": _bytes(params), "opt": _bytes(opt),
             "grads": _bytes(params), "batch": _bytes(batch)}
    step = make_train_step(cfg, micro_steps=micro_steps)
    rec = C.trace(lambda: step(params, opt, batch), (params, opt, batch))
    # the forward's leftovers for the backward: a train-mode forward and
    # loss with the graph kept, on the first micro-batch
    rows = shape.global_batch // _micro_steps(
        shape.global_batch, cfg.micro_steps if micro_steps is None
        else micro_steps)
    micro = {k: v[:rows] for k, v in batch.items()}
    with C.Trace((params, opt, batch)) as t:
        keep = _forward_loss(params, cfg, micro)
        t._purge()
        activations = t.live_bytes - t.base_bytes
        del keep
    return state, rec, {"activation_bytes": activations,
                        "saved_for_backward_bytes": t.saved_bytes}


def _forward_loss(params, cfg, batch):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    hidden, _, aux = tf.forward(live, cfg, batch["tokens"], mode="train",
                                frames=batch.get("frames"),
                                patches=batch.get("patches"))
    return tf.ce_loss(live, cfg, hidden, batch["labels"]) + aux[0], leaves


def _serve_plan(cfg, shape, params, dtype, gen_len):
    """A prefill of ``shape`` and ``gen_len - 1`` decode steps (the serve
    loop), or one decode step at a full cache (a decode shape)."""
    b, s = shape.global_batch, shape.seq_len
    dev = torch.device("meta")
    if shape.kind == "decode":
        caches = tf.init_caches(cfg, b, s, dtype=dtype, device=dev)
        C.at_last_slot(caches, s)
        tokens = torch.empty((b, 1), dtype=torch.int64, device=dev)
        state = {"params": _bytes(params), "caches": _bytes(caches),
                 "tokens": _bytes(tokens)}
        decode = make_decode_step(cfg)
        return state, C.trace(lambda: decode(params, caches, tokens),
                              (params, caches, tokens))
    batch = meta_batch(cfg, b, s, train=False, dtype=dtype)
    cache_len = s + (gen_len or 0)
    prefill = make_prefill_step(cfg, cache_len=cache_len)
    decode = make_decode_step(cfg)
    state = {"params": _bytes(params), "batch": _bytes(batch),
             "caches": _bytes(tf.init_caches(cfg, b, cache_len, dtype=dtype,
                                             device=dev))}

    def run():
        tok, caches, _ = prefill(params, batch)
        for _ in range((gen_len or 1) - 1):
            tok, caches, _ = decode(params, caches, tok[:, None])
    return state, C.trace(run, (params, batch))


def run_cell(arch: Union[str, ModelConfig], shape: Union[str, ShapeConfig],
             *, capacity_bytes=None, dtype=torch.float32,
             micro_steps: Optional[int] = None, gen_len: Optional[int] = None,
             with_costs: bool = True) -> dict:
    """Plan one cell (see the module's docstring).  ``arch``: a registered
    name or a (cut) config; ``shape``: a name of ``SHAPES`` or a
    ``ShapeConfig`` (its ``seq_len`` counts the patches); ``micro_steps``
    as ``make_train_step``'s (default the config's); ``gen_len`` makes a
    prefill cell a serve run of that many tokens."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    capacity = card_capacity(capacity_bytes)
    rec = {"arch": cfg.name, "n_layers": cfg.n_layers, "shape": shape.name,
           "kind": shape.kind, "seq_len": shape.seq_len,
           "batch": shape.global_batch, "dtype": str(dtype)[6:]}
    ok, why = cell_is_supported(cfg, shape)
    if not ok:
        rec["skipped"] = why
        return rec
    t0 = time.perf_counter()
    params = tf.init_params(cfg, device="meta", dtype=dtype)
    rec.update(params=cfg.param_count(),
               active_params=cfg.active_param_count(),
               n_params=tf.n_params(params))
    extra = {}
    if shape.kind == "train":
        state, step, extra = _train_plan(cfg, shape, params, dtype,
                                         micro_steps)
    else:
        state, step = _serve_plan(cfg, shape, params, dtype, gen_len)
        if gen_len:
            rec["gen_len"] = gen_len
    peak, held = step["peak_bytes"], step["base_bytes"]
    rec["state_bytes"] = state
    # the largest transient: what the peak adds to the held state and to
    # the forward's activations (a train step's CE logits, a prefill's
    # MLP and projections)
    extra["transient_bytes"] = peak - held - extra.get("activation_bytes", 0)
    rec["memory"] = {"peak_bytes": peak, "held_bytes": held, **extra,
                     "capacity_bytes": capacity, "fits": peak <= capacity}
    rec["launches"] = step["launches"]
    rec["step"] = {k: step[k] for k in ("flops", "product_flops",
                                        "elementwise_flops", "kernel_flops",
                                        "hbm_bytes")}
    rec["state_bytes_per_device"] = {
        name: C.state_bytes_per_device(cfg, shape, mesh, dtype=dtype)
        for name, mesh in MESHES.items()}
    if with_costs:
        rec["costs"] = C.cell_costs(cfg, shape, mesh_shape=shd.POD,
                                    dtype=dtype)
    rec["plan_s"] = time.perf_counter() - t0
    return rec


def run_gsofa_cell(n: int = 1 << 20, k_in: int = 16, concurrency: int = 64,
                   *, capacity_bytes=None) -> dict:
    """The symbolic step's cell (the reference's ``run_gsofa_cell``): a
    graph of ``n`` vertices with ``k_in`` in- and out-neighbours a vertex
    on ``meta``; per source the resident bytes of the ELL fixpoint, the
    auxiliary memory at ``concurrency`` sources (``core/spaceopt.py``),
    the concurrency the card's memory admits, and the waves: ``ceil(n /
    concurrency)`` on one card, ``ceil(n / (devices x concurrency))`` over
    the pod meshes."""
    from repro_torch.core.gsofa import SymbolicGraph
    from repro_torch.core.spaceopt import (
        auto_concurrency, aux_memory_report, bytes_per_source,
    )

    capacity = card_capacity(capacity_bytes)
    ell = torch.empty((n, k_in), dtype=torch.int32, device="meta")
    graph = SymbolicGraph(n=n, in_ell=ell, out_ell=ell.clone(),
                          out_deg=torch.empty((n,), dtype=torch.int32,
                                              device="meta"))
    per_src = bytes_per_source(graph, "ell")
    report = aux_memory_report(graph, concurrency, "ell")
    resident = report["matrix_bytes"] + 4 * n + report["aux_bytes"]
    return {"arch": "gsofa", "shape": f"n{n}", "kind": "symbolic", "n": n,
            "k_in": k_in, "concurrency": concurrency,
            "bytes_per_source": per_src, "aux_memory": report,
            "resident_bytes": resident, "capacity_bytes": capacity,
            "fits": resident <= capacity,
            "max_concurrency": auto_concurrency(graph, capacity, n, "ell"),
            "waves": {"one_card": -(-n // concurrency),
                      **{name: -(-n // (math.prod(mesh.values())
                                        * concurrency))
                         for name, mesh in MESHES.items()}}}


def all_cells():
    return [(arch, shape) for arch in all_configs() for shape in SHAPES]


def _write(rec: dict, out: Optional[str], name: str) -> Path:
    path = Path(out) if out else ARTIFACT_DIR / f"{name}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=1, default=str))
    return path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's reduced() variant")
    ap.add_argument("--gsofa", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--capacity-bytes", type=float,
                    help="memory to plan against (default: the card's)")
    ap.add_argument("--no-costs", action="store_true")
    ap.add_argument("--out", help="JSON path (default: build/dryrun/)")
    args = ap.parse_args(argv)
    cap = args.capacity_bytes
    if args.sweep:
        cells = all_cells() + [("gsofa", None)]
        for arch, shape in cells:
            name = f"{arch}__{shape or 'default'}"
            try:
                rec = (run_gsofa_cell(capacity_bytes=cap) if arch == "gsofa"
                       else run_cell(arch, shape, capacity_bytes=cap,
                                     with_costs=not args.no_costs))
            except Exception:
                rec = {"arch": arch, "shape": shape,
                       "error": traceback.format_exc()[-4000:]}
            path = _write(rec, None, name)
            print(f"[dryrun] {name}: {_summary(rec)} -> {path}", flush=True)
        return
    if args.gsofa:
        rec, name = run_gsofa_cell(capacity_bytes=cap), "gsofa__default"
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, --gsofa or --sweep")
        cfg = get_config(args.arch)
        rec = run_cell(cfg.reduced() if args.reduced else cfg, args.shape,
                       capacity_bytes=cap, with_costs=not args.no_costs)
        name = f"{args.arch}{'_reduced' if args.reduced else ''}__" \
               f"{args.shape}"
    path = _write(rec, args.out, name)
    print(f"[dryrun] {name}: {_summary(rec)} -> {path}")


def _summary(rec: dict) -> str:
    if "error" in rec:
        return "ERROR " + rec["error"].strip().splitlines()[-1]
    if "skipped" in rec:
        return "skipped: " + rec["skipped"]
    if rec["arch"] == "gsofa":
        return (f"resident {rec['resident_bytes'] / 1e9:.3f} GB, fits "
                f"{rec['fits']}, waves {rec['waves']}")
    mem = rec["memory"]
    out = (f"peak {mem['peak_bytes'] / 1e9:.3f} GB of "
           f"{mem['capacity_bytes'] / 1e9:.1f}, fits {mem['fits']}, "
           f"launches {rec['launches']}")
    if "costs" in rec:
        out += (f", {rec['costs']['totals_per_device']['flops']:.4g} "
                f"flops")
    return out


if __name__ == "__main__":
    main()
