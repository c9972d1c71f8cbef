"""Compositional costs of one (arch x shape) cell, traced on ``meta``.

The port of the JAX package's ``launch/costs.py``.  A cell's step is cut
into components, each traced once with the port's own code on tensors
that have shapes and no memory, and multiplied as the reference does:

    cost(train_step)  = n_groups x micro x cost(group fwd+bwd)
                      + micro x cost(stem+head: embed, final norm, CE, fwd+bwd)
                      + micro x cost(encoder fwd+bwd)           [enc-dec only]
                      + cost(optimizer update)
    cost(prefill)     = n_groups x cost(group fwd) + stem/head [+ encoder]
    cost(decode)      = n_groups x cost(group decode) + stem/head

``Trace`` counts, op by op on any device:
- ``product_flops``: the aten products, by ``torch.utils.flop_counter``'s
  formulas (``FlopCounterMode``'s);
- ``elementwise_flops``: one per output element of a pointwise op and one
  per input element of a reduction; exp, log and the like are counted as
  ``transcendentals`` instead (XLA's cost convention, which the
  reference's numbers follow);
- ``kernel_flops`` / ``kernel_bytes`` and launches: the port's kernels
  (K1–K8 and the backwards) from ``kernels/work.py``'s tally, which their
  wrappers fill on ``meta`` and on the CPU (a CPU run's plain versions are
  not counted as aten ops);
- ``hbm_bytes``: every non-view op's tensor inputs and outputs plus the
  kernels' bytes.  This is an UNFUSED count: each op reads and writes its
  operands in full, where XLA's "bytes accessed" is counted after fusion;
- the peak of live bytes (``peak_bytes``) over the storages the traced code
  holds, each rounded up as the CUDA caching allocator rounds (512 bytes),
  above the ``base`` tensors held before the trace.  What an op allocates
  inside itself and frees before it returns is not seen (only the few ops
  in ``_HIDDEN`` are charged for theirs).

``flops`` = products + elementwise + kernels.  A component that runs under
remat (``cfg.remat`` with more than one group, ``cfg.layer_remat``, the CE
chunks) counts its recompute, as the step runs it.  ``flops_outer_once``
is that count less one forward of the part under the outer checkpoint
(the group's, the CE chunks'), traced alone with the same code: the count
of the reference's ``cost_analysis``, whose component differentiates a
checkpointed function and drops its primal output, so the compiled
program runs that forward once; nested checkpoints (``layer_remat``)
still count their recompute there.  torch's recompute stops after the
last op that saves a tensor for the backward, so the ops of a forward
after that (a loss chunk's final sum) come off twice.

There is no ``_ssm_scan_correction``: K6 and K7 are counted from their own
work, not from a loop body counted once.  Collective bytes are 0 on one
card; with a ``mesh_shape`` the per-device state bytes come from
``train/sharding.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch
from torch.autograd.graph import saved_tensors_hooks
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.checkpoint import checkpoint
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels import work
from repro_torch.kernels.plain import fp32_highest
from repro_torch.models import transformer as tf
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import sharding as shd

aten = torch.ops.aten

# the CUDA caching allocator's block granularity
ALLOC_ROUND = 512
# ops that allocate no traffic of their own
_NO_TRAFFIC = {aten.empty, aten.empty_like, aten.empty_strided,
               aten.new_empty, aten.new_empty_strided, aten.lift_fresh}
_TRANSCENDENTAL = {aten.exp, aten.exp2, aten.expm1, aten.log, aten.log1p,
                   aten.log2, aten.rsqrt, aten.sqrt, aten.sin, aten.cos,
                   aten.tanh, aten.sigmoid, aten.erf, aten.silu,
                   aten.reciprocal}
# pointwise-tagged copies: no arithmetic
_NO_FLOPS = {aten.clone}
# ops whose CUDA kernels allocate a temporary of their input's size and
# free it before returning (``logsumexp``: ``exp(x - max)``)
_HIDDEN = {aten.logsumexp}


def _alloc(nbytes: int) -> int:
    return -(-nbytes // ALLOC_ROUND) * ALLOC_ROUND


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _flat(xs) -> list:
    """The tensors of an op's arguments or outputs (a tensor, or a
    sequence of tensors, scalars and sequences of tensors)."""
    if isinstance(xs, torch.Tensor):
        return [xs]
    if not isinstance(xs, (list, tuple)):
        return []
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


@dataclasses.dataclass(frozen=True)
class _Kind:
    """How ``Trace`` counts one op overload."""
    decompose: bool       # composite: trace its decomposition instead
    product: bool         # in ``flop_registry``
    flops: str            # "out", "in" (a reduction), "transcendental", ""
    traffic: bool         # moves its operands (not a view, not ``empty``)
    hidden: bool          # in ``_HIDDEN``


_KINDS: Dict[object, _Kind] = {}
_COMPOSITE = torch._C.DispatchKey.CompositeImplicitAutograd


def _runs_decomposed(func) -> bool:
    """A composite op without a kernel of its own (``matmul``, which
    reaches the mode whole under ``inference_mode``): the card runs its
    decomposition.  An op with its own kernel (``silu_backward``) runs
    whole, whatever decomposition it also has.  The CPU's kernels stand
    for the card's, which a CPU-only build of torch does not register."""
    has = torch._C._dispatch_has_kernel_for_dispatch_key
    return has(func.name(), _COMPOSITE) and not has(
        func.name(), torch._C.DispatchKey.CPU)


def _classify(func) -> _Kind:
    packet = func._overloadpacket
    product = packet in flop_registry
    flops = ""
    if torch.Tag.pointwise in func.tags and packet not in _NO_FLOPS:
        flops = "transcendental" if packet in _TRANSCENDENTAL else "out"
    elif torch.Tag.reduction in func.tags:
        flops = "in"
    kind = _Kind(decompose=not product and _runs_decomposed(func),
                 product=product, flops=flops,
                 traffic=not func.is_view and packet not in _NO_TRAFFIC,
                 hidden=packet in _HIDDEN)
    _KINDS[func] = kind
    return kind


class Trace(TorchDispatchMode):
    """Counts the work of the code run under it (see the module's
    docstring); ``base``: tensors held before the trace, the floor of the
    live bytes.  After the ``with`` block: ``product_flops``,
    ``elementwise_flops``, ``transcendentals``, ``hbm_bytes`` (aten ops),
    ``kernels`` ({wrapper: {"launches", "bytes", "flops"}}), ``peak_bytes``
    and ``base_bytes``, ``saved_bytes`` (the storages beside the base that
    autograd saved for the backward outside checkpoints, read with
    ``saved_tensors_hooks``)."""

    def __init__(self, base=()):
        super().__init__()
        self.product_flops = self.elementwise_flops = 0
        self.transcendentals = self.hbm_bytes = 0
        self._live: Dict[int, tuple] = {}
        self._saved: Dict[int, tuple] = {}
        self.live_bytes = 0
        for t in _tensors(base):
            self.live_bytes += self._hold(t.untyped_storage(), self._live)
        self._base = set(self._live)
        self.base_bytes = self.peak_bytes = self.live_bytes
        self.saved_bytes = 0
        self.kernels: Dict[str, dict] = {}
        self._depth = 0

    def _hold(self, storage, table) -> int:
        """Registers ``storage`` in ``table`` if it is new there; returns
        the bytes it adds."""
        key = storage._cdata
        old = table.get(key)
        if old is not None and not old[0].expired():
            return 0
        nbytes = _alloc(storage.nbytes())
        table[key] = (StorageWeakRef(storage), nbytes)
        return nbytes - (old[1] if old is not None else 0)

    def _purge(self) -> None:
        for key, (ref, nbytes) in list(self._live.items()):
            if ref.expired():
                del self._live[key]
                self.live_bytes -= nbytes

    def _allocated(self, outs, extra: int = 0) -> None:
        """Counts new storages among ``outs`` (and ``extra`` bytes freed
        again at once) into the live bytes and their peak.  Frees show
        only when the count would pass the peak: then the storages that
        died since are dropped first, so the peak is exact."""
        for t in outs:
            self.live_bytes += self._hold(t.untyped_storage(), self._live)
        if self.live_bytes + extra > self.peak_bytes:
            self._purge()
            self.peak_bytes = max(self.peak_bytes, self.live_bytes + extra)

    def _pack(self, t):
        storage = t.untyped_storage()
        if storage._cdata not in self._base:
            self.saved_bytes += self._hold(storage, self._saved)
        return t

    def __enter__(self):
        # entered again (without the hooks) to trace a decomposition
        self._depth += 1
        if self._depth == 1:
            self._before = work.totals()
            self._hooks = saved_tensors_hooks(self._pack, lambda t: t)
            self._hooks.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._depth -= 1
        if self._depth == 0:
            self._hooks.__exit__(*exc)
            self._purge()
            self.kernels = _tally_since(self._before)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = _KINDS.get(func) or _classify(func)
        if kind.decompose:
            # a composite op (``matmul`` under ``inference_mode`` reaches
            # the mode whole): trace the ops its kernel runs, as the card's
            with self:
                return func._op_dk(_COMPOSITE, *args, **kwargs)
        out = func(*args, **kwargs)
        outs = _flat(out)
        hidden = 0
        if not work.inside():
            ins = _flat(args) + _flat(tuple(kwargs.values()))
            if kind.product:
                self.product_flops += flop_registry[func._overloadpacket](
                    *args, **kwargs, out_val=out)
            elif kind.flops == "out" and outs:
                self.elementwise_flops += outs[0].numel()
            elif kind.flops == "transcendental" and outs:
                self.transcendentals += outs[0].numel()
            elif kind.flops == "in" and ins:
                self.elementwise_flops += ins[0].numel()
            if kind.traffic:
                self.hbm_bytes += sum(_nbytes(t) for t in ins + outs)
            if kind.hidden and ins:
                hidden = _alloc(_nbytes(ins[0]))
        self._allocated(outs, hidden)
        return out

    def record(self) -> dict:
        k_flops = sum(v["flops"] or 0 for v in self.kernels.values())
        k_bytes = sum(v["bytes"] or 0 for v in self.kernels.values())
        return {"flops": self.product_flops + self.elementwise_flops
                + k_flops,
                "product_flops": self.product_flops,
                "elementwise_flops": self.elementwise_flops,
                "transcendentals": self.transcendentals,
                "kernel_flops": k_flops,
                "hbm_bytes": self.hbm_bytes + k_bytes,
                "kernel_bytes": k_bytes,
                "launches": {k: v["launches"]
                             for k, v in sorted(self.kernels.items())},
                "peak_bytes": self.peak_bytes,
                "base_bytes": self.base_bytes,
                "saved_bytes": self.saved_bytes}


def _tally_since(before: dict) -> dict:
    out = {}
    for name, now in work.totals().items():
        was = before.get(name, {"launches": 0, "bytes": 0, "flops": 0})
        if now["launches"] == was["launches"]:
            continue
        out[name] = {"launches": now["launches"] - was["launches"],
                     **{k: (None if now[k] is None or was[k] is None
                            else now[k] - was[k])
                        for k in ("bytes", "flops")}}
    return out


def trace(fn: Callable, base=()) -> dict:
    """``fn()`` under a ``Trace`` with ``base`` held; its ``record()``."""
    with Trace(base) as t:
        fn()
    return t.record()


# ---------------------------------------------------------------------------
# components
# ---------------------------------------------------------------------------

def _one_group(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, n_layers=len(cfg.pattern))


def _leaves(tree):
    return list(opt_mod.tree_leaves(tree))


def micro_steps(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """The reference's rule: ``cfg.micro_steps`` for a train shape, halved
    until it divides the batch; 1 otherwise."""
    micro = 1
    if shape.kind == "train":
        micro = max(1, cfg.micro_steps)
        while shape.global_batch % micro:
            micro //= 2
    return micro


def _grad(outs, grads_out, inputs):
    outs, grads_out = zip(*[(o, g) for o, g in zip(outs, grads_out)
                            if o is not None])
    return torch.autograd.grad(outs, inputs, grads_out, allow_unused=True)


@dataclasses.dataclass
class Component:
    """One part of a step, traced on its own: ``run`` does its work over
    the ``base`` tensors it holds; ``rerun`` (None if nothing is) is the
    forward that ``run`` computes a second time under an outer checkpoint
    (the group's, the CE chunks'), traced alone for ``flops_outer_once``."""
    run: Callable
    base: tuple
    rerun: Optional[Callable] = None


def group_component(cfg: ModelConfig, shape: ShapeConfig, *, device="meta",
                    dtype=torch.float32) -> Component:
    """One layer group at ``shape`` (its batch the micro-batch): train,
    the forward (under a checkpoint when the step checkpoints its groups)
    and the backward for a cotangent of the output (and 0.01 of the MoE
    auxiliaries), as the reference's ``jax.vjp``; prefill, the forward
    filling fresh caches; decode, one token against caches full to the
    last slot."""
    dev = torch.device(device)
    one = _one_group(cfg)
    gp = tf.init_params(one, device=dev, dtype=dtype)["groups"][0]
    b, s, d = shape.global_batch, shape.seq_len, cfg.d_model
    enc = (torch.zeros((b, cfg.encdec.enc_len, d), dtype=dtype, device=dev)
           if cfg.encdec is not None else None)
    if shape.kind == "train":
        x = torch.zeros((b, s, d), dtype=dtype, device=dev)
        dy = torch.zeros_like(x)
        leaves = [t.requires_grad_() for t in _leaves(gp)]
        inputs = leaves + [x.requires_grad_()] + (
            [enc.requires_grad_()] if enc is not None else [])
        checkpointed = cfg.remat and cfg.n_groups > 1

        def run():
            with fp32_highest():
                if checkpointed:
                    out, _, aux = checkpoint(tf._group, gp, x, None, one,
                                             "train", enc,
                                             use_reentrant=False)
                else:
                    out, _, aux = tf._group(gp, x, None, one, "train", enc)
                ones = None if aux is None else torch.full_like(aux, 0.01)
                _grad((out, aux), (dy, ones), inputs)

        def rerun():
            with torch.no_grad(), fp32_highest():
                tf._group(gp, x, None, one, "train", enc)
        return Component(run, (gp, x, dy, enc),
                         rerun if checkpointed else None)

    mode = shape.kind
    x = torch.zeros((b, 1 if mode == "decode" else s, d), dtype=dtype,
                    device=dev)
    caches = tf.init_caches(one, b, s, dtype=dtype, device=dev)
    if mode == "decode":
        at_last_slot(caches, s)
        enc = None
    caches = caches[0]

    def run():
        with torch.inference_mode(), fp32_highest():
            tf._group(gp, x, caches, one, mode, enc)
    return Component(run, (gp, x, caches, enc))


def at_last_slot(caches, length: int) -> None:
    """Sets every cursor of fresh caches of ``length`` positions
    (``init_caches``) to the last one: the next decode step attends over
    full caches (a local layer's ring, wrapped, over its window)."""
    for cg in caches:
        for ce in cg.values():
            for sub in ce.values():
                if "idx" in sub:
                    sub["idx"] = length - 1


def stem_head_component(cfg: ModelConfig, shape: ShapeConfig, *,
                        device="meta", dtype=torch.float32) -> Component:
    """The model without its groups and encoder (``tf.forward`` of a
    config of no layers: the embedding, the patches in front, the final
    norm), then the chunked CE loss and its backward (train) or the last
    position's logits and the greedy token (prefill, decode)."""
    dev = torch.device(device)
    bare = dataclasses.replace(cfg, n_layers=0, encdec=None)
    stem = tf.init_params(bare, device=dev, dtype=dtype)
    b = shape.global_batch
    s = 1 if shape.kind == "decode" else shape.seq_len
    patches = cfg.n_patches if shape.kind != "decode" else 0
    tokens = torch.zeros((b, s - patches), dtype=torch.int64, device=dev)
    pad = (torch.zeros((b, patches, cfg.d_model), dtype=dtype, device=dev)
           if patches else None)

    def hidden(mode):
        return tf.forward(stem, bare, tokens, mode=mode,
                          caches=[] if mode == "decode" else None,
                          patches=pad)[0]

    if shape.kind == "train":
        labels = torch.zeros((b, s), dtype=torch.int64, device=dev)
        leaves = [t.requires_grad_() for t in _leaves(stem)]
        h0 = torch.zeros((b, s, cfg.d_model), dtype=dtype, device=dev)

        def run():
            with fp32_highest():
                torch.autograd.grad(
                    tf.ce_loss(stem, cfg, hidden("train"), labels), leaves)

        def rerun():
            with torch.no_grad(), fp32_highest():
                tf.ce_loss(stem, cfg, h0, labels)
        return Component(run, (stem, tokens, pad, labels, h0), rerun)

    def run():
        with torch.inference_mode(), fp32_highest():
            tf.logits_last(stem, cfg, hidden(shape.kind)).argmax(dim=-1)
    return Component(run, (stem, tokens, pad))


def encoder_component(cfg: ModelConfig, shape: ShapeConfig, *,
                      device="meta", dtype=torch.float32):
    """Whisper's encoder over the frames: forward and the backward of
    sum(out * dy) (train), or the forward (prefill); None for a decode or
    a model without one."""
    if cfg.encdec is None or shape.kind == "decode":
        return None
    dev = torch.device(device)
    bare = dataclasses.replace(cfg, n_layers=0)
    ep = {"encoder": tf.init_params(bare, device=dev,
                                    dtype=dtype)["encoder"]}
    b, t = shape.global_batch, cfg.encdec.enc_len
    frames = torch.zeros((b, t, cfg.d_model), dtype=dtype, device=dev)
    if shape.kind == "train":
        dy = torch.zeros_like(frames)
        leaves = [x.requires_grad_() for x in _leaves(ep)]
        frames.requires_grad_()

        def run():
            with fp32_highest():
                out = tf.encode(ep, cfg, frames, train=True)
                torch.autograd.grad(torch.sum(out.float() * dy.float()),
                                    leaves + [frames])
        return Component(run, (ep, frames, dy))

    def run():
        with torch.inference_mode(), fp32_highest():
            tf.encode(ep, cfg, frames)
    return Component(run, (ep, frames))


def optimizer_component(cfg: ModelConfig, *, device="meta",
                        dtype=torch.float32,
                        acfg: opt_mod.AdamWConfig = opt_mod.AdamWConfig()
                        ) -> Component:
    """One AdamW update of the whole model in place."""
    params = tf.init_params(cfg, device=device, dtype=dtype)
    grads = opt_mod.tree_map(torch.zeros_like, params)
    state = opt_mod.init_adamw(params)

    def run():
        with fp32_highest():
            opt_mod.adamw_update(params, grads, state, acfg)
    return Component(run, (params, grads, state))


def component_cost(comp: Component) -> dict:
    """``trace`` of ``comp.run``; ``flops_outer_once`` is its flops less
    those of ``comp.rerun``, traced alone."""
    rec = trace(comp.run, comp.base)
    rec.pop("saved_bytes")
    rec["flops_outer_once"] = rec["flops"] - (
        trace(comp.rerun, comp.base)["flops"] if comp.rerun else 0)
    return rec


def cell_costs(cfg: ModelConfig, shape: ShapeConfig, *,
               mesh_shape: Optional[Dict[str, int]] = None,
               dtype=torch.float32, device="meta") -> dict:
    """Per-device cost totals of one (arch x shape) cell on one card, by
    component (see the module's docstring); ``device`` "cpu" runs the same
    components for real (small configurations only).  ``mesh_shape``
    adds each device's state bytes under the sharding rules."""
    micro = micro_steps(cfg, shape)
    eff = dataclasses.replace(shape, global_batch=shape.global_batch // micro)
    kw = {"device": device, "dtype": dtype}
    components = [("group", cfg.n_groups * micro,
                   group_component(cfg, eff, **kw)),
                  ("stem_head", micro, stem_head_component(cfg, eff, **kw))]
    enc = encoder_component(cfg, eff, **kw)
    if enc is not None:
        components.append(("encoder", micro, enc))
    if shape.kind == "train":
        components.append(("optimizer", 1, optimizer_component(cfg, **kw)))
    total = {"flops": 0, "flops_outer_once": 0, "hbm_bytes": 0,
             "collective_bytes": 0}
    detail = {}
    for name, mult, comp in components:
        rec = component_cost(comp)
        detail[name] = {"multiplier": mult, **rec}
        for key in ("flops", "flops_outer_once", "hbm_bytes"):
            total[key] += mult * rec[key]
    out = {"totals_per_device": total, "components": detail,
           "micro_steps": micro, "n_devices": 1}
    if mesh_shape is not None:
        out["mesh"] = dict(mesh_shape)
        out["n_devices"] = math.prod(mesh_shape.values())
        out["state_bytes_per_device"] = state_bytes_per_device(
            cfg, shape, mesh_shape, dtype=dtype)
    return out


def state_bytes_per_device(cfg: ModelConfig, shape: ShapeConfig,
                           mesh: Dict[str, int], *,
                           dtype=torch.float32) -> dict:
    """One device's bytes of a cell's resident state on ``mesh`` (the
    reference's ``state_bytes_per_device``): train params, the AdamW
    state (ZeRO-1, float32 master and moments) and the batch; prefill
    params and batch; decode params, caches and tokens."""
    params = tf.init_params(cfg, device="meta", dtype=dtype)
    out = {"params": shd.tree_bytes_per_device(
        shd.param_shardings(params, mesh, cfg), mesh)}
    b, s = shape.global_batch, shape.seq_len

    def batch_bytes(shapes):
        return sum(shd.sharded_bytes(sh, dt, shd.batch_pspec(sh, mesh, cfg),
                                     mesh) for sh, dt in shapes)

    if shape.kind == "train":
        one = sum(shd.sharded_bytes(tuple(t.shape), torch.float32, spec,
                                    mesh)
                  for _, t, spec in shd.param_shardings(params, mesh, cfg,
                                                    zero1=True))
        out["opt"] = 3 * one + 4                     # master, m, v, count
        out["batch"] = batch_bytes(_batch_shapes(cfg, b, s, dtype, True))
    elif shape.kind == "prefill":
        out["batch"] = batch_bytes(_batch_shapes(cfg, b, s, dtype, False))
    else:
        caches = tf.init_caches(cfg, b, s, dtype=dtype, device="meta")
        out["caches"] = sum(
            shd.sharded_bytes(shp[1:], ts[0].dtype,
                              shd.cache_pspec(path, shp, mesh, cfg)[1:], mesh)
            * len(ts) for path, shp, ts in shd.cache_leaves(caches))
        out["tokens"] = batch_bytes([((b, 1), torch.int64)])
    return out


def _batch_shapes(cfg: ModelConfig, b: int, s: int, dtype, train: bool):
    """(shape, dtype) of a train or prefill batch: tokens (and labels) of
    the text positions, patches, frames."""
    text = s - cfg.n_patches
    out = [((b, text), torch.int64)]
    if train:
        out.append(((b, s), torch.int64))
    if cfg.n_patches:
        out.append(((b, cfg.n_patches, cfg.d_model), dtype))
    if cfg.encdec is not None:
        out.append(((b, cfg.encdec.enc_len, cfg.d_model), dtype))
    return out
