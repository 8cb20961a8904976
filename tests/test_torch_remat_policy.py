"""``REMAT_POLICY = "save_moe"`` (``repro_torch.models.lm``) against the
reference's, on reduced MoE configs, CPU only; the policy is set on both
sides and restored afterwards.

Tolerances: the loss within 1e-5 relative and every gradient leaf within
1e-4 of its largest |g| against ``jax.value_and_grad`` (f32, the same
formulas summed in another order, as ``test_torch_train.py``); ``save_moe``
against ``"none"`` in the port bit for bit (the recompute runs the same CPU
ops, the saved ones are the forward's own).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jget
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.optim.adamw import tree_leaves

B, S = 2, 16
LOSS_RTOL, GRAD_REL = 1e-5, 1e-4
MOE_ARCHS = ["deepseek-v2-236b", "arctic-480b"]


class _ExpertForwards(TorchDispatchMode):
    """Counts the expert gate products the forward runs (a bmm of a layer's
    ``w_gate`` as stored: the backward reads it transposed)."""

    def __init__(self, w_gate):
        super().__init__()
        self.storage = w_gate.untyped_storage().data_ptr()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.bmm.default:
            w = args[1]
            if w.untyped_storage().data_ptr() == self.storage and w.is_contiguous():
                self.n += 1
        return func(*args, **(kwargs or {}))


def _setup(arch, rng):
    jcfg = dataclasses.replace(jget(arch).reduced(), compute_dtype="float32")
    tcfg = dataclasses.replace(get_config(arch).reduced(), compute_dtype="float32")
    jparams = jlm.init_params(jcfg, seed=0)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    tokens = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    tbatch = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    return jcfg, tcfg, jparams, tparams, jbatch, tbatch


def _loss_and_grads(params, batch, cfg):
    """(loss, grads, expert forwards run) of one step."""
    moe_key = next(k for k, g in params["blocks"].items() if "moe" in g)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    with _ExpertForwards(params["blocks"][moe_key]["moe"]["w_gate"]) as count:
        total, _ = lm.loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(total, leaves)
    return total.detach(), grads, count.n


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_save_moe_same_loss_and_grads_and_one_expert_forward(arch, rng, monkeypatch):
    jcfg, tcfg, jparams, tparams, jbatch, tbatch = _setup(arch, rng)
    assert tcfg.remat == "full" and tcfg.moe is not None
    moe_layers = sum(ch == "a" for ch in tcfg.pattern())

    none = _loss_and_grads(tparams, tbatch, tcfg)
    monkeypatch.setattr(lm, "REMAT_POLICY", "save_moe")
    monkeypatch.setattr(jlm, "REMAT_POLICY", "save_moe")
    saved = _loss_and_grads(tparams, tbatch, tcfg)
    # "none" runs each MoE layer's experts in the forward and again in the
    # recompute; "save_moe" keeps the block's activations: once
    assert none[2] == 2 * moe_layers and saved[2] == moe_layers
    assert torch.equal(none[0], saved[0])
    assert all(torch.equal(a, b) for a, b in zip(none[1], saved[1]))

    (jtotal, _), jgrads = jax.jit(
        jax.value_and_grad(lambda p, b: jlm.loss_fn(p, b, jcfg), has_aux=True))(jparams, jbatch)
    np.testing.assert_allclose(float(saved[0]), float(jtotal), rtol=LOSS_RTOL)
    jleaves = [np.asarray(g, np.float32) for g in jax.tree.leaves(jgrads)]
    assert len(jleaves) == len(saved[1])
    for g_t, g_j in zip(saved[1], jleaves):
        scale = max(float(np.abs(g_j).max()), 1e-30)
        np.testing.assert_allclose(g_t.numpy(), g_j, rtol=0, atol=GRAD_REL * scale)


def test_save_moe_is_the_default_off_and_leaves_dense_models_alone(rng, monkeypatch):
    assert lm.REMAT_POLICY == jlm.REMAT_POLICY == "none"
    _, tcfg, _, tparams, _, tbatch = _setup("llama3.2-1b", rng)
    leaves = tree_leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    base = lm.loss_fn(tparams, tbatch, tcfg)[0]
    monkeypatch.setattr(lm, "REMAT_POLICY", "save_moe")
    assert torch.equal(lm.loss_fn(tparams, tbatch, tcfg)[0], base)


def test_remat_policy_restored():
    assert lm.REMAT_POLICY == jlm.REMAT_POLICY == "none"
