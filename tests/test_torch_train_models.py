"""repro_torch's train-mode forward, chunked loss and gradients against
repro's, on the CPU, for the nine families that train: dense GQA
(smollm-135m, qwen3-1.7b), gemma3-4b's local and global layers (reduced
to one 17-layer period, per-layer remat), whisper-tiny (encoder and
cross-attention), internvl2-26b (patches, their labels 0), moonshot's
attention + MoE, deepseek-v3's MLA + MoE, rwkv6-7b (the rwkv6 mixer
through K7's plain backward, group remat) and jamba's period (attention,
mamba through K6's plain backward and MoE, per-layer remat).  The
reference runs
``jax.value_and_grad`` of ``forward(mode="train")`` + ``ce_loss`` +
``0.01 * moe_aux`` under ``jax.jit`` on the port's seed-0 parameters
stacked into its tree; the port runs the same through ``torch.autograd``
(K5's, K6's and K7's plain backwards on the CPU; remat on, as the
configs say)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import transformer as jtf
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.data import pipeline
from repro_torch.models import transformer as tf
from repro_torch.train.optimizer import tree_leaves, tree_map
from repro_torch.train.steps import AUX_LOSS_WEIGHT
from test_torch_train import _leaf_pairs, _reference_tree

# tiny shapes, several pytest workers: one intra-op thread each
torch.set_num_threads(1)

FAMILIES = ["smollm-135m", "qwen3-1.7b", "gemma3-4b", "whisper-tiny",
            "internvl2-26b", "moonshot-v1-16b-a3b", "deepseek-v3-671b",
            "rwkv6-7b", "jamba-1.5-large-398b"]
SEQ, BATCH, CHUNK = 16, 2, 4          # ce_loss in 4 chunks of 4
# float32 sums in another order: the hidden states within 2e-5, the loss
# and moe_aux within 1e-5 relative, each gradient leaf within 2e-4 of its
# largest entry (plus 1e-7 for leaves that are all but zero)
HIDDEN_TOL, LOSS_TOL, GRAD_TOL = 2e-5, 1e-5, 2e-4


def _configs(name):
    cfgs = tuple(get(name).reduced() for get in (jget_config, get_config))
    if name == "gemma3-4b":
        cfgs = tuple(dataclasses.replace(c, n_layers=17) for c in cfgs)
    return cfgs


def _reference(jcfg, jparams, batch):
    def loss_fn(p):
        hidden, _, aux = jtf.forward(
            p, jcfg, batch["tokens"], patches=batch.get("patches"),
            frames=batch.get("frames"), mode="train")
        loss = jtf.ce_loss(p, jcfg, hidden, batch["labels"], chunk=CHUNK)
        return loss + AUX_LOSS_WEIGHT * aux[0], (loss, aux, hidden)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jparams)


@pytest.mark.parametrize("name", FAMILIES)
def test_train_forward_loss_and_grads_match_reference(name):
    jcfg, cfg = _configs(name)
    params = tf.init_params(cfg, seed=0, device="cpu")
    jparams = jax.tree.map(jnp.asarray, _reference_tree(params))
    batch = pipeline.make_batch_for(cfg, ShapeConfig("s", SEQ, BATCH,
                                                     "train"), seed=3)
    (jtotal, (jloss, jaux, jhidden)), jgrads = _reference(
        jcfg, jparams, {k: jnp.asarray(v) for k, v in batch.items()})

    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    tb = {k: torch.as_tensor(v).long() if v.dtype.kind == "i"
          else torch.as_tensor(v) for k, v in batch.items()}
    hidden, caches, aux = tf.forward(params, cfg, tb["tokens"], mode="train",
                                     frames=tb.get("frames"),
                                     patches=tb.get("patches"))
    assert caches is None
    loss = tf.ce_loss(params, cfg, hidden, tb["labels"], chunk=CHUNK)
    total = loss + AUX_LOSS_WEIGHT * aux[0]
    grads = torch.autograd.grad(total, leaves, allow_unused=True)

    np.testing.assert_allclose(hidden.detach().numpy(), np.asarray(jhidden),
                               rtol=HIDDEN_TOL, atol=HIDDEN_TOL)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(aux.detach().numpy(), np.asarray(jaux),
                               rtol=LOSS_TOL, atol=1e-7)
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=LOSS_TOL)
    it = iter(grads)
    port_grads = tree_map(lambda p: (lambda g: torch.zeros_like(p)
                                     if g is None else g)(next(it)), params)
    for path, g, want in _leaf_pairs(port_grads, jgrads):
        err = float((g - want).abs().max())
        assert err <= GRAD_TOL * float(want.abs().max()) + 1e-7, (path, err)
