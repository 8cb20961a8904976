"""Numerics of the port's sharded training on 4 gloo ranks, the counterpart
of ``tests/test_manual_tp.py``: a (data=2, model=2) mesh on the reference
test's config (2 layers, d 64, 4 heads, d_head 16, d_ff 128, vocab 512,
f32, no remat) with ``act_seq`` forced to ``"model"``, under both
settings — ``DTensor`` propagation, and the manual tensor-parallel paths
(``BF16_TP_REDUCE`` and ``MEGATRON_MLP``).  With 4 kv heads the kv heads
shard with the q heads; with 1 kv head they stay replicated and each rank
takes the kv head its q heads read (the replicated-kv GQA case).

The reference's own sharded step cannot run on the installed JAX (its
indexing of a sharded leaf raises ``DuplicateSpecError``), so the sharded
loss and gradients are held against the reference's *unsharded*
``lm.loss_fn`` and ``jax.grad`` — loss within 1e-4, every gradient at
rtol = atol = 2e-3, the reference test's own tolerances — and against the
port's unsharded loss, gradients and train step (loss within 1e-5
relative, gradients and stepped parameters at rtol 1e-4, atol 1e-5: the
same f32 formulas, the sums split over ranks).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_ranks
from repro.configs import get_config as jget
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.launch import steps
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamW, tree_leaves

SETTINGS = ("propagation", "manual")
REF_LOSS_TOL, REF_GRAD_TOL = 1e-4, 2e-3
PORT_LOSS_RTOL, PORT_RTOL, PORT_ATOL = 1e-5, 1e-4, 1e-5


def _jax_cfg(n_kv_heads):
    return dataclasses.replace(jget("llama3.2-1b").reduced(), n_kv_heads=n_kv_heads,
                               **torch_ranks.TP_CFG)


@pytest.fixture(scope="module", params=[4, 1], ids=["kv4", "kv1_replicated"])
def run(request, tmp_path_factory):
    """The reference's unsharded loss and gradients, the port's unsharded
    loss, gradients and step, and the 4 ranks' sharded results."""
    n_kv = request.param
    out = tmp_path_factory.mktemp(f"tp_kv{n_kv}")
    jcfg, cfg = _jax_cfg(n_kv), torch_ranks.tp_config(n_kv)
    jparams = jlm.init_params(jcfg, seed=0)
    batch = torch_ranks.tp_batch()
    jbatch = {k: jax.numpy.asarray(v.numpy()) for k, v in batch.items()}
    jloss, jgrads = jax.value_and_grad(lambda p: jlm.loss_fn(p, jbatch, jcfg)[0])(jparams)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg)
    torch.save(params, out / "params.pt")

    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = lm.loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    plain = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg)
    opt = AdamW()
    stepped, _, _ = steps.make_train_step(cfg, opt, steps.TrainHyper())(
        plain, opt.init(plain), batch)

    torch_ranks.run_ranks(torch_ranks.manual_tp_rank, 4, out, str(out), n_kv, timeout=240)
    return {
        "ref": (float(jloss), [np.asarray(g) for g in jax.tree.leaves(jgrads)]),
        "port": (loss.detach(), [g.detach() for g in grads],
                 [p.detach() for p in tree_leaves(stepped)]),
        "sharded": torch.load(out / "sharded.pt"),
    }


@pytest.mark.parametrize("setting", SETTINGS)
def test_sharded_loss_and_grads_match_the_reference_unsharded(run, setting):
    ref_loss, ref_grads = run["ref"]
    got = run["sharded"][setting]
    assert abs(float(got["loss"]) - ref_loss) < REF_LOSS_TOL
    assert len(got["grads"]) == len(ref_grads)
    for g, r in zip(got["grads"], ref_grads):
        np.testing.assert_allclose(g.numpy(), r.astype(np.float32), rtol=REF_GRAD_TOL,
                                   atol=REF_GRAD_TOL)


@pytest.mark.parametrize("setting", SETTINGS)
def test_sharded_loss_and_grads_match_the_port_unsharded(run, setting):
    loss, grads, _ = run["port"]
    got = run["sharded"][setting]
    torch.testing.assert_close(got["loss"], loss, rtol=PORT_LOSS_RTOL, atol=0)
    for g, r in zip(got["grads"], grads):
        torch.testing.assert_close(g, r, rtol=PORT_RTOL, atol=PORT_ATOL)


@pytest.mark.parametrize("setting", SETTINGS)
def test_sharded_train_step_matches_the_unsharded_step(run, setting):
    """``make_train_step(..., grad_shardings=...)``: one AdamW step on the
    sharded state lands on the unsharded step's parameters, every leaf
    keeping its placements."""
    loss, _, stepped = run["port"]
    got = run["sharded"][setting]
    assert got["placements_kept"]
    torch.testing.assert_close(got["step_loss"], loss, rtol=PORT_LOSS_RTOL, atol=0)
    for p, r in zip(got["stepped"], stepped):
        torch.testing.assert_close(p, r, rtol=PORT_RTOL, atol=PORT_ATOL)
