"""Sharding rules as data: parameters (TP + optional FSDP), optimizer state
(ZeRO-1), caches and batches, without a mesh.

The port of the rules of the JAX package's ``train/sharding.py``.  On one
card nothing is sharded; these functions say how the state of a cell would
be split over the reference's pod meshes, so the dry run
(``launch/dryrun.py``) can give each device's bytes.  A mesh is an ordered
mapping of axis names to sizes, ``{"data": 16, "model": 16}`` for the pod
or ``{"pod": 2, "data": 16, "model": 16}`` for two.  A spec is a plain
tuple with one entry per leading dim (a shorter spec leaves the rest
unsharded): ``None``, an axis name, or a tuple of two or more names, as
``tuple(PartitionSpec(...))`` reads.

Baseline layout (the reference's): batch over ('pod', 'data'); tensor
parallelism over 'model' (head projections, FFN hidden, MoE experts, vocab);
FSDP over ``cfg.fsdp_axes`` for tensors of 2^16 elements or more; ZeRO-1
shards the optimizer state over 'data' even where the parameter is
replicated there; decode caches shard the sequence over what the batch
leaves.  Divisibility is checked per rule, and a rule that does not divide
quietly degrades to replication.

The rules take the reference's paths (``groups/l0/mixer/wq``) and stacked
shapes (``n_groups`` leading).  The port keeps the groups, the encoder's
layers and the caches as lists of per-group dicts; ``param_leaves`` and
``cache_leaves`` walk them under the reference's paths and shapes.

What has no counterpart: ``constrain``, ``set_context`` and
``step_context`` (activation annotations inside the model; one card holds
every tensor, and the port's models call none of them).
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, Mapping, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig

_FSDP_MIN_SIZE = 1 << 16    # don't FSDP-shard tiny tensors

POD = {"data": 16, "model": 16}
MULTI_POD = {"pod": 2, "data": 16, "model": 16}

Spec = Tuple


def _entry(axes: Sequence[str]):
    """A spec entry: None, one name, or a tuple of two or more."""
    axes = tuple(axes)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _resolve(kind, mesh: Mapping[str, int]) -> Tuple[str, ...]:
    """A rule name as mesh axes: "batch" is ('pod', 'data') as present."""
    if kind is None:
        return ()
    if isinstance(kind, tuple):
        return tuple(a for k in kind for a in _resolve(k, mesh))
    if kind == "batch":
        return tuple(a for a in ("pod", "data") if a in mesh)
    return (kind,) if kind in mesh else ()


def auto_spec(shape: Sequence[int], prefs, mesh: Mapping[str, int]) -> Spec:
    """Pick, per dim, the first preference whose axes are unused and divide
    the dim.  ``prefs[i]`` is None | name | tuple | list-of-candidates."""
    used: set = set()
    spec = []
    for size, pref in zip(shape, prefs):
        chosen = ()
        for cand in (pref if isinstance(pref, list) else [pref]):
            axes = _resolve(cand, mesh)
            if not axes or any(a in used for a in axes):
                continue
            total = math.prod(mesh[a] for a in axes)
            if total > 1 and size % total == 0:
                chosen = axes
                break
        used.update(chosen)
        spec.append(_entry(chosen))
    return tuple(spec)


# ---------------------------------------------------------------------------
# parameter shardings
# ---------------------------------------------------------------------------

_COL = {"wq", "wk", "wv", "wg", "wr", "w_gate", "w_up", "w_in", "wq_b",
        "wkv_b", "w_lora_a", "w_dt"}          # (in, out): TP on out
_ROW = {"wo", "w_down", "w_out"}              # (in, out): TP on in
_IN_ONLY = {"w_xproj", "a_log"}               # (di, *): TP on dim 0
_CH_VEC = {"conv_b", "d_skip", "dt_bias"}     # (di,): TP
_LORA_IN = {"wq_a", "wkv_a"}                  # (d, r): FSDP on d only


def param_pspec(path: str, shape: Tuple[int, ...], mesh: Mapping[str, int],
                cfg: ModelConfig) -> Spec:
    """The spec of the parameter at the reference's ``path`` with the
    reference's (stacked) ``shape``."""
    names = path.split("/")
    name = names[-1]
    grouped = names[0] in ("groups", "encoder")
    dims = list(shape[1:]) if grouped else list(shape)
    model = mesh.get("model", 1)
    fsdp_axes = tuple(a for a in cfg.fsdp_axes if a in mesh)
    fsdp = math.prod(mesh[a] for a in fsdp_axes) if fsdp_axes else 1
    big = math.prod(dims) >= _FSDP_MIN_SIZE

    def m(i):  # model axis if divisible
        return "model" if model > 1 and dims[i] % model == 0 else None

    def f(i):  # fsdp axes if divisible and worthwhile
        return (_entry(fsdp_axes) if fsdp > 1 and big and dims[i] % fsdp == 0
                else None)

    # seq-sharded attention replaces head-TP when n_heads % tp != 0: the
    # attention projections then skip model sharding (FSDP only)
    attn_no_tp = (cfg.seq_shard_attention
                  and name in ("wq", "wk", "wv", "wo")
                  and "mixer" in names)

    spec = [None] * len(dims)
    if name == "table" and len(dims) == 2:                  # (V, d) embed/head
        spec = [m(0), f(1)]
    elif name in _COL and len(dims) == 2:                   # (d, out)
        spec = [f(0), None if attn_no_tp else m(1)]
    elif name in _ROW and len(dims) == 2:                   # (in, d)
        spec = [None if attn_no_tp else m(0), f(1)]
    elif name in ("w_gate", "w_up") and len(dims) == 3:     # (E, d, de) experts
        spec = [m(0), f(1), None]
    elif name == "w_down" and len(dims) == 3:               # (E, de, d)
        spec = [m(0), None, f(2)]
    elif name in _IN_ONLY and len(dims) == 2:               # (di, *)
        spec = [m(0), None]
    elif name == "conv_w" and len(dims) == 2:               # (d_conv, di)
        spec = [None, m(1)]
    elif name in _CH_VEC and len(dims) == 1:                # (di,)
        spec = [m(0)]
    elif name in _LORA_IN and len(dims) == 2:               # (d, r)
        spec = [f(0), None]
    # everything else (norms, router, u, mix, w_base) replicates
    if grouped:
        spec = [None] + spec
    return tuple(spec)


def zero1_pspec(spec: Spec, shape: Tuple[int, ...],
                mesh: Mapping[str, int]) -> Spec:
    """ZeRO-1: additionally shard optimizer state over 'data' (largest
    still-unsharded divisible dim).  Params already FSDP'd keep their spec."""
    if "data" not in mesh:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    if any("data" in _axes(e) for e in entries):
        return spec
    d = mesh["data"]
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if entries[i] is None and shape[i] % d == 0 and shape[i] >= d:
            entries[i] = "data"
            return tuple(entries)
    return spec


# ---------------------------------------------------------------------------
# cache / batch shardings
# ---------------------------------------------------------------------------

_SEQ_PREFS = [("data", "model"), ("data",), ("model",)]   # for seq-dim sharding


def cache_pspec(path: str, shape: Tuple[int, ...], mesh: Mapping[str, int],
                cfg: ModelConfig) -> Spec:
    """Caches are stacked (n_groups leading).  Batch shards first; KV heads
    over 'model' when divisible; otherwise the sequence dim picks up the
    spare axes (sequence-sharded cache for long_500k's batch=1)."""
    name = path.split("/")[-1]
    dims = shape[1:]                                     # drop group axis
    prefs = {("k", 4): ["batch", "model", _SEQ_PREFS, None],   # (B, Hkv, T, hd)
             ("v", 4): ["batch", "model", _SEQ_PREFS, None],
             ("pos", 2): ["batch", _SEQ_PREFS],                # (B, T)
             ("ckv", 3): ["batch", _SEQ_PREFS, None],          # (B, T, r)
             ("krope", 4): ["batch", None, _SEQ_PREFS, None],  # (B, 1, T, rd)
             ("s", 4): ["batch", "model", None, None],         # rwkv (B, H, K, K)
             ("h", 3): ["batch", "model", None],               # mamba (B, di, N)
             ("conv", 3): ["batch", None, "model"],            # (B, dc-1, di)
             ("x_prev", 2): ["batch", "model"],                # (B, d)
             }.get((name, len(dims)))
    spec = auto_spec(dims, prefs, mesh) if prefs else ()  # idx and friends
    return (None,) + spec


def batch_pspec(shape: Tuple[int, ...], mesh: Mapping[str, int],
                cfg: ModelConfig) -> Spec:
    return auto_spec(shape, ["batch"] + [None] * (len(shape) - 1), mesh)


# ---------------------------------------------------------------------------
# bytes, and the port's trees under the reference's paths
# ---------------------------------------------------------------------------

def sharded_bytes(shape: Tuple[int, ...], dtype, spec: Spec,
                  mesh: Mapping[str, int]) -> int:
    """One device's bytes of a tensor of ``shape`` and ``dtype`` split as
    ``spec``: each sharded dim divided by its axes' sizes (the rules shard
    only dims their axes divide)."""
    shard = [size // math.prod(mesh[a] for a in _axes(e))
             for size, e in zip(shape, tuple(spec) + (None,) * len(shape))]
    return math.prod(shard) * torch.empty((), dtype=dtype).element_size()


def _walk(tree, path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{path}/{k}" if path else k)
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def _stacked(groups, prefix: str):
    """(path, stacked shape, the tensor of each group) of a list of
    per-group dicts that the reference stacks along a leading axis."""
    flat = [dict(_walk(g, prefix)) for g in groups]
    for path, t in flat[0].items():
        yield path, (len(groups),) + tuple(t.shape), [f[path] for f in flat]


def param_leaves(params: Dict) -> Iterator[Tuple[str, Tuple, list]]:
    """(reference path, reference shape, [the port's tensors]) of every
    parameter: ``groups/...`` and ``encoder/layers/...`` once for all
    groups / layers with the stacked shape, every other leaf alone."""
    for key, sub in params.items():
        if key == "groups":
            yield from _stacked(sub, "groups")
        elif key == "encoder":
            yield from _stacked(sub["layers"], "encoder/layers")
            for path, t in _walk(sub["norm"], "encoder/norm"):
                yield path, tuple(t.shape), [t]
        else:
            for path, t in _walk(sub, key):
                yield path, tuple(t.shape), [t]


def cache_leaves(caches) -> Iterator[Tuple[str, Tuple, list]]:
    """(reference path, stacked shape, [the port's tensors]) of every
    cache tensor; the port's cursors (``idx``) are host ints, and its
    caches hold no position arrays."""
    yield from _stacked(caches, "")


def param_shardings(params: Dict, mesh: Mapping[str, int],
                    cfg: ModelConfig, *, zero1: bool = False
                    ) -> Iterator[Tuple[str, torch.Tensor, Spec]]:
    """(reference path, tensor, spec of that tensor) of every parameter
    tensor of the port's tree; ``zero1`` gives the optimizer state's.  A
    stacked leaf's tensors take its spec without the group axis."""
    for path, shape, tensors in param_leaves(params):
        spec = param_pspec(path, shape, mesh, cfg)
        if zero1:
            spec = zero1_pspec(spec, shape, mesh)
        stacked = len(shape) > tensors[0].dim()
        for t in tensors:
            yield path, t, spec[1:] if stacked else spec


def tree_bytes_per_device(leaves, mesh: Mapping[str, int]) -> int:
    """Sum of ``sharded_bytes`` over ``(path, tensor, spec)`` triples."""
    return sum(sharded_bytes(tuple(t.shape), t.dtype, spec, mesh)
               for _, t, spec in leaves)
