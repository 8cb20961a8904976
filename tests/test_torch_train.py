"""The port's training path against the reference's: ``lm.loss_fn`` and its
gradient for every registered architecture, the train step with AdamW and
the warm-up / cosine schedule, microbatch accumulation, remat, and the
kernel wrappers' refusal of a gradient they cannot give.

Reduced configs in float32 compute, the reference's weights carried across
with ``repro_torch.bridge``, batches made with numpy.  Tolerances:

- the loss within 1e-5 relative: the same f32 formulas, summed in another
  order by another library;
- every gradient leaf within 1e-4 of that leaf's largest |g| (the
  reference's), elementwise: the backward sums the same products in
  another order (the reference's attention backward is its chunked custom
  VJP, the port's autograd through the plain dense softmax);
- remat on and off bit for bit: the recompute runs the same CPU ops;
- three train steps' losses within 1e-5 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as JNAMES
from repro.configs import get_config as jget
from repro.launch.steps import TrainHyper as JTrainHyper
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import lm as jlm
from repro.optim.adamw import AdamW as JAdamW
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.kernels import attention as tatt
from repro_torch.kernels import build, fft, matmul, paged_attention, ssd
from repro_torch.kernels import rmsnorm as trms
from repro_torch.launch.steps import TrainHyper, make_train_step
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamW, tree_leaves

B, S = 2, 32  # S tiles the reduced SSM chunk (16) and the attention chunks
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4


def _cfgs(arch, **kw):
    jcfg = dataclasses.replace(jget(arch).reduced(), compute_dtype="float32", **kw)
    tcfg = dataclasses.replace(get_config(arch).reduced(), compute_dtype="float32", **kw)
    return jcfg, tcfg


def _batches(cfg, rng, b=B, s=S):
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    if cfg.frontend == "patch_embed":
        x = {"embeds": rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)}
    else:
        x = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    nb = dict(x, labels=labels)
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


def _grads(params, batch, cfg):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    total, metrics = lm.loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    return total, metrics, [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]


def _assert_grads_close(tgrads, jgrads):
    """Each leaf within GRAD_REL of its largest |g| (the reference's)."""
    jleaves = [np.asarray(g, np.float32) for g in jax.tree.leaves(jgrads)]
    assert len(jleaves) == len(tgrads)
    for g_t, g_j in zip(tgrads, jleaves):
        g_t = g_t.detach().numpy()
        assert g_t.shape == g_j.shape
        scale = max(float(np.abs(g_j).max()), 1e-30)
        np.testing.assert_allclose(g_t, g_j, rtol=0, atol=GRAD_REL * scale)


@pytest.mark.parametrize("arch", JNAMES)
def test_loss_and_grads_match_reference(arch, rng):
    """``lm.loss_fn`` and every gradient leaf against
    ``jax.value_and_grad(repro.models.lm.loss_fn)`` (remat on, as both
    configs default; pixtral through its patch embeddings)."""
    jcfg, tcfg = _cfgs(arch)
    assert tcfg.remat == jcfg.remat == "full"
    jparams = jlm.init_params(jcfg, seed=0)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    jbatch, tbatch = _batches(tcfg, rng)
    (jtotal, jmetrics), jgrads = jax.jit(
        jax.value_and_grad(lambda p, b: jlm.loss_fn(p, b, jcfg), has_aux=True)
    )(jparams, jbatch)
    total, metrics, grads = _grads(tparams, tbatch, tcfg)
    for key in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(metrics[key].detach()), float(jmetrics[key]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    if tcfg.moe is not None:
        assert float(metrics["aux"]) > 0  # the MoE aux loss is summed in
    _assert_grads_close(grads, jgrads)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-v2-236b", "zamba2-7b"])
def test_remat_on_and_off_give_the_same_grads(arch, rng):
    _, tcfg = _cfgs(arch)
    params = lm.init_params(tcfg, seed=1)
    _, tbatch = _batches(tcfg, rng)
    _, m_on, g_on = _grads(params, tbatch, tcfg)
    _, m_off, g_off = _grads(params, tbatch, dataclasses.replace(tcfg, remat="none"))
    assert all(torch.equal(m_on[k], m_off[k]) for k in m_on)
    assert all(torch.equal(a, b) for a, b in zip(g_on, g_off))


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.detach().clone() for k, v in tree.items()}


def test_microbatch_two_matches_one(rng):
    """Gradients accumulated over two halves of the batch (in the moment
    dtype) and averaged update the weights as the whole batch's mean
    gradient does; the metrics are averaged."""
    _, tcfg = _cfgs("llama3.2-1b")
    params = lm.init_params(tcfg, seed=2)
    opt = AdamW(moment_dtype=tcfg.opt_dtype)
    _, batch = _batches(tcfg, rng, b=4)
    out = {}
    for n in (1, 2):
        p = _clone(params)
        step = make_train_step(tcfg, opt, TrainHyper(base_lr=1e-3, warmup_steps=2, microbatch=n))
        p, state, metrics = step(p, opt.init(p), batch)
        out[n] = (p, metrics)
    for key in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(out[2][1][key]), float(out[1][1][key]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    for a, b in zip(tree_leaves(out[2][0]), tree_leaves(out[1][0])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("microbatch", [None, 2])
def test_three_train_steps_match_reference(microbatch):
    """Three steps of ``make_train_step`` (AdamW, warm-up / cosine) on the
    synthetic pipeline's batches: the losses against the reference's jitted
    step within 1e-5 relative."""
    jcfg, tcfg = _cfgs("llama3.2-1b")
    hyper = dict(base_lr=1e-3, warmup_steps=2, total_steps=16, microbatch=microbatch)
    jopt, topt = JAdamW(moment_dtype=jcfg.opt_dtype), AdamW(moment_dtype=tcfg.opt_dtype)
    jstep = jax.jit(jmake_train_step(jcfg, jopt, JTrainHyper(**hyper)))
    tstep = make_train_step(tcfg, topt, TrainHyper(**hyper))
    jparams = jlm.init_params(jcfg, seed=0)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    data = SyntheticLMData(tcfg.vocab_size, S, 4, seed=3)
    for step in range(3):
        batch = data.batch_at(step)
        jparams, jstate, jm = jstep(jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tparams, tstate, tm = tstep(tparams, tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    assert int(tstate.step) == int(jstate.step) == 3


# -- wrappers without a backward refuse a gradient --------------------------------


def _meta(*shape, dtype=torch.float32, grad=True):
    return torch.zeros(shape, dtype=dtype, device="meta", requires_grad=grad)


def _paged():
    pool = _meta(5, 2, 4, 16)
    return lambda: paged_attention.paged_attention(
        _meta(2, 4, 1, 16), pool, pool, torch.zeros(2, 2, dtype=torch.int32, device="meta"),
        torch.zeros(2, dtype=torch.int32, device="meta"))


NO_BACKWARD = {
    "paged_attention": (_paged(), "paged_attention"),
    "ssd_chunks": (lambda: ssd.ssd_chunks(_meta(1, 16, 2, 8), _meta(1, 16, 2), _meta(2),
                                          _meta(1, 16, 4), _meta(1, 16, 4), chunk=16),
                   "ssd_scan"),
    "matmul": (lambda: matmul.matmul(_meta(128, 128), _meta(128, 128)), "matmul"),
    "schur_update": (lambda: matmul.schur_update(_meta(128, 128), _meta(128, 128),
                                                 _meta(128, 128)), "lu"),
    "complex_matmul": (lambda: fft.complex_matmul(*(_meta(128, 128) for _ in range(4))),
                       "fft2d"),
    "gated_rmsnorm": (lambda: trms.rmsnorm(_meta(1, 2, 2, 8), _meta(16),
                                           gate=(_meta(1, 2, 2, 8), _meta(2), _meta(1, 2, 16))),
                      "rmsnorm"),
}


@pytest.mark.parametrize("name", sorted(NO_BACKWARD))
def test_wrappers_without_a_backward_refuse_grad(name):
    """A CUDA wrapper with no backward kernel raises under autograd, naming
    the block to bind to ``torch``, instead of returning a result with no
    gradient path.  (Meta tensors stand in for CUDA ones: the wrapper takes
    its kernel's branch for every tensor not on the CPU.)"""
    call, block = NO_BACKWARD[name]
    with pytest.raises(RuntimeError, match=f"bind the '{block}' block's 'torch' target"):
        call()


def test_flash_and_norm_wrappers_take_their_autograd_functions(monkeypatch):
    """Under autograd flash attention and RMSNorm's plain and add forms go
    through their Functions (forward kernel, then backward kernel); with
    grad mode off they launch the forward kernel alone, with no lse."""
    calls = []
    monkeypatch.setattr(build, "check_cuda", lambda name, *ts: None)
    monkeypatch.setattr(build, "stream_of", lambda t: 0)
    monkeypatch.setattr(build, "launch", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(trms, "_sm_count", lambda device: 132)  # a meta tensor has no card
    q, k, v = _meta(1, 4, 8, 16), _meta(1, 2, 8, 16), _meta(1, 2, 8, 16)
    out = tatt.flash_attention(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    assert calls[-1][0] == "repro_flash_attention" and calls[-1][1][4] is not None  # lse
    out.sum().backward()
    assert calls[-1][0] == "repro_flash_attention_bwd"
    x, w = _meta(2, 8, 16), _meta(16)
    y = trms.rmsnorm(x, w, 1e-5)
    assert type(y.grad_fn).__name__ == "RMSNormFnBackward"
    s, y = trms.rmsnorm(x, w, 1e-5, delta=_meta(2, 8, 16))
    assert type(y.grad_fn).__name__ == "AddRMSNormFnBackward"
    (s.sum() + y.sum()).backward()
    assert calls[-1][0] == "repro_rmsnorm_bwd" and calls[-1][1][2] is not None  # ds
    with torch.no_grad():
        assert tatt.flash_attention(q, k, v).grad_fn is None
    assert calls[-1][0] == "repro_flash_attention" and calls[-1][1][4] is None


def test_remat_recomputes_under_the_forwards_bindings(monkeypatch, rng):
    """On the card autograd runs the backward (and so the remat recompute)
    on its own device thread, where the caller's thread-local bindings are
    not: the recompute must take the blocks the forward took.  A backward
    run from another thread stands in for the device thread: every norm of
    the forward under a ``ref`` binding runs again through ``ref``."""
    import threading

    from repro_torch.core import blocks
    from repro_torch.core.blocks import Impl

    calls = []
    ref = blocks.registry.implementation("rmsnorm", "ref")

    def spy(*args, **kwargs):
        calls.append(threading.get_ident())
        return ref.fn(*args, **kwargs)

    monkeypatch.setitem(blocks.registry._impls["rmsnorm"], "ref",
                        Impl("rmsnorm", "ref", spy, ref.note))
    _, tcfg = _cfgs("llama3.2-1b")
    params = lm.init_params(tcfg, seed=1)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    _, tbatch = _batches(tcfg, rng)
    with blocks.bind({"rmsnorm": "ref"}):
        total, _ = lm.loss_fn(params, tbatch, tcfg)
    forward = len(calls)
    assert forward == 2 * tcfg.n_layers + 1
    worker = threading.Thread(target=lambda: torch.autograd.grad(total, leaves))
    worker.start()
    worker.join(timeout=120)
    assert not worker.is_alive()
    assert len(calls) == 2 * forward  # every layer and the head recomputed through ref
