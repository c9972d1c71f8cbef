"""repro_torch's mesh-free sharding rules (``train/sharding.py``) against the
JAX package's ``train/sharding.py``, on the reference's pod meshes (16 x 16
('data', 'model') and 2 x 16 x 16 ('pod', 'data', 'model'), as device-less
abstract meshes): every rule's spec equals the reference's
``tuple(PartitionSpec)`` bitwise, over the property inputs of
``tests/test_sharding_rules.py`` (names, dims and the grouped flag drawn
the same way) and over every leaf of every configuration's parameter,
optimizer-state and cache trees at full width (the port's on ``meta``, the
reference's from ``jax.eval_shape``); and the per-device bytes of each tree
(``sharded_bytes``) equal the reference's ``launch/costs.py::sharded_bytes``
on the reference's specs."""
import jax
import jax.numpy as jnp
import pytest
import torch
from _hypothesis_compat import given, settings, st
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs.base import all_configs as jall_configs
from repro.configs.base import get_config as jget_config
from repro.launch import costs as jcosts
from repro.launch.mesh import compat_abstract_mesh
from repro.train import sharding as jshd
from repro.train.steps import cache_specs, param_specs
from repro_torch.configs.base import get_config
from repro_torch.models import transformer as tf
from repro_torch.train import sharding as shd

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = sorted(jall_configs())


@pytest.fixture(scope="module", params=sorted(MESHES))
def meshes(request):
    """(the reference's abstract mesh, the port's {axis: size})."""
    dims, names = MESHES[request.param]
    return compat_abstract_mesh(dims, names), dict(zip(names, dims))


def _canon(spec):
    """A reference spec as a tuple, one-name tuples as the name (older JAX
    keeps them as tuples)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


# the property inputs of tests/test_sharding_rules.py
NAMES = ["table", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "w_in",
         "w_out", "wq_a", "wq_b", "wkv_a", "wkv_b", "router", "scale",
         "conv_w", "a_log", "d_skip", "w_xproj", "w_dt", "u", "mix"]


@settings(max_examples=200, deadline=None)
@given(
    name=st.sampled_from(NAMES),
    grouped=st.booleans(),
    dims=st.lists(st.sampled_from([1, 3, 8, 16, 48, 64, 96, 576, 2048, 4096,
                                   16384, 49152, 92553]), min_size=1,
                  max_size=3),
    arch=st.sampled_from(["qwen3-14b", "deepseek-v3-671b", "gemma3-4b"]),
)
def test_param_and_zero1_pspecs_equal_the_references(meshes, name, grouped,
                                                     dims, arch):
    mesh, ms = meshes
    shape = tuple(([4] if grouped else []) + dims)
    path = ("groups/l0/mixer/" if grouped else "") + name
    want = jshd.param_pspec(path, shape, mesh, jget_config(arch))
    got = shd.param_pspec(path, shape, ms, get_config(arch))
    assert got == _canon(want)
    assert shd.zero1_pspec(got, shape, ms) == _canon(
        jshd.zero1_pspec(want, shape, mesh))


@settings(max_examples=100, deadline=None)
@given(dims=st.lists(st.integers(1, 4096), min_size=1, max_size=4))
def test_zero1_of_a_replicated_spec_equals_the_references(meshes, dims):
    mesh, ms = meshes
    assert shd.zero1_pspec((), tuple(dims), ms) == _canon(
        jshd.zero1_pspec(P(), tuple(dims), mesh))


@settings(max_examples=100, deadline=None)
@given(
    b=st.sampled_from([1, 2, 16, 32, 128, 256]),
    hkv=st.sampled_from([1, 3, 4, 8, 16, 128]),
    t=st.sampled_from([128, 4096, 32768, 524288]),
    name=st.sampled_from(["k", "v", "ckv", "krope", "s", "h", "conv",
                          "x_prev", "idx"]),
)
def test_cache_and_batch_pspecs_equal_the_references(meshes, b, hkv, t,
                                                     name):
    mesh, ms = meshes
    cfg, jcfg = get_config("qwen3-14b"), jget_config("qwen3-14b")
    shape = {"k": (4, b, hkv, t, 128), "v": (4, b, hkv, t, 128),
             "ckv": (4, b, t, 512), "krope": (4, b, 1, t, 64),
             "s": (4, b, hkv, 64, 64), "h": (4, b, 16 * hkv, 16),
             "conv": (4, b, 3, 16 * hkv), "x_prev": (4, b, 64 * hkv),
             "idx": (4,)}[name]
    path = f"groups/l0/self/{name}"
    assert shd.cache_pspec(path, shape, ms, cfg) == _canon(
        jshd.cache_pspec(path, shape, mesh, jcfg))
    assert shd.batch_pspec(shape[1:], ms, cfg) == _canon(
        jshd.batch_pspec(shape[1:], mesh, jcfg))


def _ref_leaves(tree):
    return {jshd._path_str(p): leaf
            for p, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _ref_bytes(leaves, specs, mesh):
    """The reference's own per-device bytes of a tree of (path: struct)
    under (path: spec)."""
    paths = sorted(leaves)
    return jcosts.sharded_bytes([leaves[p] for p in paths],
                                [NamedSharding(mesh, specs[p])
                                 for p in paths])


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_and_optimizer_trees_shard_as_the_references(arch):
    """Every parameter of the full-width model: the port's spec (the
    stacked leaves' without the group axis) equals the reference's, the
    ZeRO-1 optimizer spec too, and each tree's per-device bytes equal the
    reference's arithmetic on the reference's specs (float32 parameters;
    the optimizer state one float32 copy)."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    ref = _ref_leaves(param_specs(jcfg, jnp.float32))
    params = tf.init_params(cfg, device="meta")
    for name, (dims, axes) in MESHES.items():
        mesh, ms = compat_abstract_mesh(dims, axes), dict(zip(axes, dims))
        seen, specs, zspecs = set(), {}, {}
        for path, shape, tensors in shd.param_leaves(params):
            assert tuple(ref[path].shape) == shape, path
            specs[path] = jshd.param_pspec(path, shape, mesh, jcfg)
            zspecs[path] = jshd.zero1_pspec(specs[path], shape, mesh)
            assert shd.param_pspec(path, shape, ms, cfg) == _canon(
                specs[path]), (name, path)
            seen.add(path)
        assert seen == set(ref)
        for zero1, want in ((False, specs), (True, zspecs)):
            got = list(shd.param_shardings(params, ms, cfg, zero1=zero1))
            for path, t, spec in got:
                full = _canon(want[path])
                stacked = len(ref[path].shape) > t.dim()
                assert spec == (full[1:] if stacked else full), path
            assert shd.tree_bytes_per_device(got, ms) == _ref_bytes(
                ref, want, mesh), (name, zero1)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_trees_shard_as_the_references(arch):
    """Every cache tensor of the full-width model at decode_32k (128 x
    32768) and long_500k (1 x 524288): the port's spec equals the
    reference's on the same path, and the per-device bytes of the tensors
    both hold equal the reference's (the reference also keeps a position
    array per cache and device cursors, which the port keeps on the
    host)."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    for batch, length in ((128, 32768), (1, 524288)):
        ref = _ref_leaves(cache_specs(jcfg, batch, length, jnp.float32))
        caches = tf.init_caches(cfg, batch, length, device="meta")
        for name, (dims, axes) in MESHES.items():
            mesh, ms = compat_abstract_mesh(dims, axes), dict(zip(axes, dims))
            got, want = 0, {}
            for path, shape, tensors in shd.cache_leaves(caches):
                assert tuple(ref[path].shape) == shape, path
                want[path] = jshd.cache_pspec(path, shape, mesh, jcfg)
                spec = shd.cache_pspec(path, shape, ms, cfg)
                assert spec == _canon(want[path]), (name, path)
                got += sum(shd.sharded_bytes(tuple(t.shape), t.dtype,
                                             spec[1:], ms) for t in tensors)
            assert want, arch
            assert got == _ref_bytes({p: ref[p] for p in want}, want, mesh)


def test_sharded_bytes_divides_each_axis():
    ms = {"pod": 2, "data": 16, "model": 16}
    assert shd.sharded_bytes((64, 48, 7), torch.float32,
                             (("pod", "data"), "model"), ms) == 2 * 3 * 7 * 4
    assert shd.sharded_bytes((64,), torch.bfloat16, (), ms) == 128
    assert shd.auto_spec((32, 5), ["batch", "model"], ms) == (
        ("pod", "data"), None)
