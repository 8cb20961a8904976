"""The registry's gradient default: an unbound block call that autograd will
differentiate and whose ``cuda`` target cannot (the SSD chunk kernel, the
gated norm: no backward kernel) resolves to ``torch``, as the reference's
default resolves an unbound block to ``xla``; an explicit ``cuda`` binding
still reaches the wrapper, which refuses.  The card is stood in for by a
device target that answers ``cuda`` for CPU tensors: the ``cuda`` wrappers
then run their plain versions (a CPU tensor), so a whole train step runs
and its resolutions can be read.

Tolerances, as ``test_torch_train.py``: the loss within 1e-5 relative and
every gradient leaf within 1e-4 of the reference's largest |g| (the same
f32 formulas summed in another order); the recompute's resolutions exactly
the forward's.
"""

import collections
import dataclasses
import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.kernels import ops as jops
from repro.launch.steps import TrainHyper as JTrainHyper
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import lm as jlm
from repro.optim.adamw import AdamW as JAdamW
from repro_torch import bridge, kernels
from repro_torch.configs import get_config
from repro_torch.core import blocks
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.kernels import ops, ssd
from repro_torch.kernels import ref as tref
from repro_torch.launch import train
from repro_torch.launch.steps import TrainHyper, make_train_step
from repro_torch.models import lm
from repro_torch.offload import zoo
from repro_torch.optim.adamw import AdamW, tree_leaves

ARCH = "mamba2-2.7b"
B, S = 2, 32  # S tiles the reduced SSD chunk (16)


@pytest.fixture
def on_card(monkeypatch):
    """Unbound calls pick the ``cuda`` target, as for CUDA tensors."""
    monkeypatch.setattr(blocks, "_device_target", lambda args: "cuda")
    kernels.reset_launches()
    yield
    kernels.reset_launches()


def _t(*shape, grad=False):
    return torch.zeros(shape, requires_grad=grad)


def _ssd_args(grad):
    return (_t(1, 16, 2, 4, grad=grad), _t(1, 16, 2), _t(2, grad=grad), _t(1, 16, 4),
            _t(1, 16, 4)), {"chunk": 16}


def _gated_args(grad):
    # the gradient reaches only the gate's tuple (d_skip), not the first tensor
    return (_t(1, 2, 2, 4), _t(8)), {"eps": 1e-5, "gate": (_t(1, 2, 2, 4), _t(2, grad=grad),
                                                           _t(1, 2, 8))}


def _norm_args(grad, add=False):
    kw = {"eps": 1e-5, **({"delta": _t(2, 8)} if add else {})}
    return (_t(2, 8, grad=grad), _t(8)), kw


def _attention_args(grad):
    return (_t(1, 2, 4, 8, grad=grad), _t(1, 2, 4, 8), _t(1, 2, 4, 8)), {}


# (block, args builder, grad, bound target, grad mode, expected target, counter)
CASES = {
    "ssd_scan_grad": ("ssd_scan", _ssd_args, True, None, True, "torch", "ssd_scan"),
    "ssd_scan_no_requires_grad": ("ssd_scan", _ssd_args, False, None, True, "cuda", None),
    "ssd_scan_grad_mode_off": ("ssd_scan", _ssd_args, True, None, False, "cuda", None),
    "ssd_scan_bound_cuda": ("ssd_scan", _ssd_args, True, "cuda", True, "cuda", None),
    "gated_grad_in_gate": ("rmsnorm", _gated_args, True, None, True, "torch", "rmsnorm.gated"),
    "gated_no_grad": ("rmsnorm", _gated_args, False, None, True, "cuda", None),
    "gated_bound_cuda": ("rmsnorm", _gated_args, True, "cuda", True, "cuda", None),
    "plain_norm_grad": ("rmsnorm", _norm_args, True, None, True, "cuda", None),
    "add_norm_grad": ("rmsnorm", lambda g: _norm_args(g, add=True), True, None, True, "cuda",
                      None),
    "attention_grad": ("attention", _attention_args, True, None, True, "cuda", None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_resolution_rule(on_card, case):
    block, make, grad, bound, grad_mode, want, counter = CASES[case]
    args, kwargs = make(grad)
    with blocks.bind({block: bound} if bound else {}), torch.set_grad_enabled(grad_mode):
        fn = blocks.registry.resolve(block, *args, **kwargs)
    assert fn is blocks.registry.implementation(block, want).fn
    want_counts = {f"grad_default/{counter}": 1} if counter else {}
    assert {k: n for k, n in kernels.counters().items() if k.startswith("grad_default/")} \
        == want_counts


def test_cpu_tensors_keep_the_torch_target_and_count_nothing():
    kernels.reset_launches()
    args, kwargs = _ssd_args(True)
    assert blocks.registry.resolve("ssd_scan", *args, **kwargs) is \
        blocks.registry.implementation("ssd_scan", "torch").fn
    assert blocks.registry.grad_defaults == {}


@pytest.mark.parametrize("block", ["ssd_scan", "rmsnorm"])
def test_an_explicit_cuda_binding_still_raises(block):
    """Bound to ``cuda``, a call under autograd reaches the kernel's
    wrapper, which refuses (meta tensors stand in for CUDA ones: the
    wrapper takes its kernel's branch for every tensor not on the CPU)."""
    def meta(*shape, grad=True):
        return torch.zeros(shape, device="meta", requires_grad=grad)

    if block == "ssd_scan":
        args = (meta(1, 16, 2, 8), meta(1, 16, 2), meta(2), meta(1, 16, 4), meta(1, 16, 4))
        kwargs = {"chunk": 16}
    else:
        args = (meta(1, 2, 2, 8), meta(16))
        kwargs = {"gate": (meta(1, 2, 2, 8), meta(2), meta(1, 2, 16))}
    with blocks.bind({block: "cuda"}), pytest.raises(
            blocks.GradRefused, match=f"bind the '{block}' block's 'torch' target"):
        blocks.call(block, *args, **kwargs)


def _spy_resolutions(monkeypatch):
    """Record (block, form, target) of every resolution, and its thread."""
    log = []
    resolve = blocks.FunctionBlockRegistry.resolve

    def spy(self, block, *args, **kwargs):
        fn = resolve(self, block, *args, **kwargs)
        impls = self._impls[block]
        target = next(t for t in ("cuda", "torch", "ref") if t in impls and impls[t].fn is fn)
        form = ("gated" if kwargs.get("gate") is not None
                else "add" if kwargs.get("delta") is not None else "plain")
        log.append(((block, form if block == "rmsnorm" else "", target),
                    threading.get_ident()))
        return fn

    monkeypatch.setattr(blocks.FunctionBlockRegistry, "resolve", spy)
    return log


def _cfgs(**kw):
    jcfg = dataclasses.replace(jget(ARCH).reduced(), compute_dtype="float32", **kw)
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), compute_dtype="float32", **kw)
    return jcfg, tcfg


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return {"tokens": tokens, "labels": labels}


def test_remat_recompute_resolves_as_the_forward(on_card, monkeypatch):
    """Full remat: the backward recomputes every layer and the head, on another thread
    (autograd's device thread on the card); each recomputed call resolves
    as its forward call did, the SSD scan and the gated norm to ``torch``,
    the plain and add norms to ``cuda``."""
    _, tcfg = _cfgs()
    assert tcfg.remat == "full" and set(tcfg.pattern()) == {"m"}
    params = lm.init_params(tcfg, seed=1)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    log = _spy_resolutions(monkeypatch)
    total, _ = lm.loss_fn(params, {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()},
                          tcfg)
    forward = collections.Counter(key for key, _ in log)
    n = len(log)
    worker = threading.Thread(target=lambda: torch.autograd.grad(total, leaves))
    worker.start()
    worker.join(timeout=120)
    assert not worker.is_alive()
    recompute = collections.Counter(key for key, _ in log[n:])
    assert {tid for _, tid in log[n:]} == {worker.ident}
    layers = tcfg.n_layers
    assert recompute == forward  # every layer and the head recomputed, resolved alike
    for key in (("ssd_scan", "", "torch"), ("rmsnorm", "gated", "torch")):
        assert forward[key] == layers
    assert all(target == "cuda" for (block, form, target) in forward
               if block == "rmsnorm" and form in ("plain", "add"))
    assert kernels.counters()["grad_default/ssd_scan"] == 2 * layers


def test_mamba2_train_step_on_default_bindings_matches_reference(on_card):
    """With default bindings on the (stand-in) card, a reduced mamba2's loss
    and gradients, then three ``make_train_step`` steps, against the
    reference's ``jax.value_and_grad`` and jitted step."""
    jcfg, tcfg = _cfgs()
    jparams = jlm.init_params(jcfg, seed=0)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    batch = _batch(tcfg)
    (_, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, b, jcfg), has_aux=True))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = tree_leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    total, tm = lm.loss_fn(tparams, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    grads = torch.autograd.grad(total, leaves)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    jleaves = [np.asarray(g, np.float32) for g in jax.tree.leaves(jgrads)]
    assert len(jleaves) == len(grads)
    for g_t, g_j in zip(grads, jleaves):
        scale = max(float(np.abs(g_j).max()), 1e-30)
        np.testing.assert_allclose(g_t.numpy(), g_j, rtol=0, atol=1e-4 * scale)
    counted = kernels.counters()
    assert counted["grad_default/ssd_scan"] > 0 and counted["grad_default/rmsnorm.gated"] > 0

    for p in leaves:
        p.requires_grad_(False)
    hyper = dict(base_lr=1e-3, warmup_steps=2, total_steps=16)
    jopt, topt = JAdamW(moment_dtype=jcfg.opt_dtype), AdamW(moment_dtype=tcfg.opt_dtype)
    jstep = jax.jit(jmake_train_step(jcfg, jopt, JTrainHyper(**hyper)))
    tstep = make_train_step(tcfg, topt, TrainHyper(**hyper))
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    data = SyntheticLMData(tcfg.vocab_size, S, B, seed=3)
    for step in range(3):
        b = data.batch_at(step)
        jparams, jstate, jm = jstep(jparams, jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tparams, tstate, tm = tstep(tparams, tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)


def test_train_cli_names_the_blocks_it_resolved_to_torch(on_card, tmp_path, capsys):
    argv = ["--arch", ARCH, "--reduced", "--batch", "2", "--seq", "16", "--device", "cpu",
            "--steps", "2", "--ckpt-dir", str(tmp_path)]
    assert train.main(argv) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-2].startswith("grad_default: rmsnorm.gated (")
    assert "ssd_scan (" in out[-2] and out[-1].startswith("done: 2 steps")


def test_cli_on_the_cpu_resolves_nothing_to_torch_for_a_gradient(tmp_path, capsys):
    argv = ["--arch", ARCH, "--reduced", "--batch", "2", "--seq", "16", "--device", "cpu",
            "--steps", "1", "--ckpt-dir", str(tmp_path)]
    assert train.main(argv) == 0
    assert capsys.readouterr().out.splitlines()[-2] == "grad_default: none"


def test_a_plan_search_counts_a_refused_gradient_as_a_failed_trial(monkeypatch, tmp_path):
    """A train cell's trial that binds ``ssd_scan`` to a ``cuda`` target with
    no backward (the refusal stood in for on the CPU) fails: infinitely
    slow, never the winner, and the search goes on and commits a plan."""
    def refusing(x, dt, a, bmat, cmat, *, chunk=128):
        from repro_torch.kernels import build

        build.refuse_grad("ssd_chunks", "ssd_scan", x, dt, a, bmat, cmat)
        return ssd.ssd_chunks_torch(x, dt, a, bmat, cmat, chunk=chunk)

    monkeypatch.setattr(ops, "ssd_chunks", refusing)
    results = zoo.plan_zoo(str(tmp_path), [(ARCH, "train")], layers=1, batch=1, seq=16,
                           targets=("torch", "cuda"), device="cpu")
    result = results[(ARCH, "train")]
    failed = [t for t in result.trials if t.mapping.get("ssd_scan") == "cuda"]
    assert failed and all(math.isinf(t.seconds) for t in failed)
    assert result.mapping.get("ssd_scan") != "cuda"
    assert zoo.default_plan_key(str(tmp_path), ARCH, "train") == f"zoo:{ARCH}:train"


def test_ssd_gradient_is_finite_where_the_upper_triangle_overflows(rng):
    """Training an SSM on default bindings differentiates the SSD scan's
    plain version.  Above a chunk's diagonal ``a_cum[i] - a_cum[j]`` sums up
    to L - 1 positive ``-dt a`` terms: at full width (chunk 128, dt up to
    0.1, |a| up to 16) past f32's exp range, as here (|dt a| = 4 a step over
    64).  The reference's ``where(mask, exp(diff), 0)`` then gives NaN
    gradients (the zero cotangent times inf); the port masks before the exp,
    so its gradients are finite and match autograd through the sequential
    oracle (``ref.ssd_ref``), each within 1e-4 of its largest |g| (f32 sums
    in another order).  The forward is the same either way."""
    b, s, h, p, n, chunk = 1, 64, 2, 4, 8, 64
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.full((b, s, h), 1.0, np.float32)
    a = np.array([-4.0, -0.5], np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)

    def jloss(*args):
        y, hfin = jops.ssd_scan(*args, chunk=chunk, backend="xla")
        return jnp.sum(y) + jnp.sum(hfin)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (x, dt, a, bm, cm)))
    assert not all(np.isfinite(np.asarray(g)).all() for g in jgrads)

    def grads(scan):
        ts = [torch.from_numpy(v).requires_grad_(True) for v in (x, dt, a, bm, cm)]
        y, hfin = scan(*ts)
        return y.detach(), torch.autograd.grad(y.sum() + hfin.sum(), ts)

    y, got = grads(lambda *ts: ops.ssd_scan(*ts, chunk=chunk, backend="torch"))
    y_ref, want = grads(tref.ssd_ref)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), rtol=1e-4, atol=1e-4)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-4 * scale)
