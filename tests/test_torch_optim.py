"""The port's optimizer pieces against the reference's: AdamW (global-norm
clip, bias correction, the moment dtype, the ``ndim >= 2`` decay rule that
also decays a layer group's stacked norm weights), ``warmup_cosine`` and
the int8 gradient codec.

The same parameters, gradients and moments (numpy, through
``repro_torch.bridge``) go through both updates; parameters and moments
agree within 1e-6 (the same f32 formulas; the global norm is summed over
the leaves in the same order, each leaf's squares in another).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import lm as jlm
from repro.optim import compression as jcomp
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import OptState as JOptState
from repro.optim.schedule import warmup_cosine as jwarmup_cosine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.optim import compression as tcomp
from repro_torch.optim.adamw import AdamW, tree_leaves
from repro_torch.optim.schedule import warmup_cosine

TOL = dict(rtol=1e-6, atol=1e-6)


def _state(rng, jparams, step, grad_scale):
    """Gradients and moments shaped as the parameters (nu > 0)."""
    def like(scale, positive=False):
        def f(p):
            a = rng.standard_normal(p.shape).astype(np.float32) * scale
            return np.abs(a) if positive else a
        return jax.tree.map(f, jax.tree.map(np.asarray, jparams))

    return like(grad_scale), like(0.01), like(1e-4, positive=True), step


@pytest.mark.parametrize("grad_scale", [1e-3, 1.0], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(moment_dtype, grad_scale, rng):
    jcfg, tcfg = jget("llama3.2-1b").reduced(), get_config("llama3.2-1b").reduced()
    jparams = jlm.init_params(jcfg, seed=0)
    grads, mu, nu, step = _state(rng, jparams, 3, grad_scale)
    jopt, topt = JAdamW(moment_dtype=moment_dtype), AdamW(moment_dtype=moment_dtype)
    mdt = jnp.dtype(moment_dtype)
    jstate = JOptState(mu=jax.tree.map(lambda a: jnp.asarray(a, mdt), mu),
                       nu=jax.tree.map(lambda a: jnp.asarray(a, mdt), nu),
                       step=jnp.asarray(step, jnp.int32))
    lr = 1e-3
    jnew, jstate = jax.jit(jopt.update)(jax.tree.map(jnp.asarray, grads), jstate, jparams, lr)

    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    tstate = bridge.opt_state_from_numpy(
        jax.tree.map(lambda a: np.asarray(jnp.asarray(a, mdt)), mu),
        jax.tree.map(lambda a: np.asarray(jnp.asarray(a, mdt)), nu), step, tcfg, moment_dtype)
    tgrads = bridge.params_from_numpy(grads, tcfg)
    tnew, tstate = topt.update(tgrads, tstate, tparams, torch.tensor(lr))

    assert int(tstate.step) == int(jstate.step) == step + 1
    for got, want in zip(tree_leaves(tnew), jax.tree.leaves(jnew)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    mu_t, nu_t, _ = bridge.opt_state_to_numpy(tstate)
    for got, want in zip(jax.tree.leaves(mu_t) + jax.tree.leaves(nu_t),
                         jax.tree.leaves(jstate.mu) + jax.tree.leaves(jstate.nu)):
        want = np.asarray(want, np.float32)
        if moment_dtype == "float32":
            np.testing.assert_allclose(got, want, **TOL)
        else:  # both round an f32 moment to bf16: one bf16 step (2^-7 relative at
            # most) apart where the f32 values straddle a rounding boundary
            np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-6)


def test_decay_applies_to_stacked_norms_not_the_final_norm(rng):
    """Mirrored from the reference: every leaf with ndim >= 2 is decayed,
    so a group's stacked (L, d) norm weights are and the (d,) final norm
    is not."""
    tcfg = get_config("llama3.2-1b").reduced()
    jparams = jlm.init_params(jget("llama3.2-1b").reduced(), seed=0)
    grads = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), jparams)
    out = {}
    for wd in (0.0, 0.1):
        params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
        opt = AdamW(weight_decay=wd)
        out[wd], _ = opt.update(bridge.params_from_numpy(grads, tcfg), opt.init(params),
                                params, 1e-2)
    ln1 = out[0.0]["blocks"]["g0_a"]["ln1"]
    assert ln1.ndim == 2
    assert not torch.equal(ln1, out[0.1]["blocks"]["g0_a"]["ln1"])
    assert torch.equal(out[0.0]["final_norm"], out[0.1]["final_norm"])


def test_init_gives_zero_moments_in_the_moment_dtype():
    tcfg = get_config("llama3.2-1b").reduced()
    params = bridge.params_from_numpy(
        jax.tree.map(np.asarray, jlm.init_params(jget("llama3.2-1b").reduced(), seed=0)), tcfg)
    state = AdamW(moment_dtype="bfloat16").init(params)
    assert int(state.step) == 0 and state.step.dtype == torch.int32
    for m, p in zip(tree_leaves(state.mu), tree_leaves(params)):
        assert m.dtype == torch.bfloat16 and m.shape == p.shape and not m.any()


@pytest.mark.parametrize("warmup,total", [(100, 10000), (2, 16), (0, 5)])
def test_warmup_cosine_matches_reference(warmup, total):
    for step in (0, 1, 2, 3, 50, 99, 100, 101, 5000, 10000, 20000):
        want = float(jwarmup_cosine(step, 3e-4, warmup, total))
        assert float(warmup_cosine(step, 3e-4, warmup, total)) == pytest.approx(want, rel=1e-6)
        got_t = warmup_cosine(torch.tensor(step, dtype=torch.int32), 3e-4, warmup, total)
        assert got_t.dtype == torch.float32 and float(got_t) == pytest.approx(want, rel=1e-6)


def test_codec_matches_reference_bit_for_bit(rng):
    g = (rng.standard_normal((64, 33)) * 3).astype(np.float32)
    q, s = tcomp._quantize(torch.from_numpy(g))
    jq, js = jcomp._quantize(jnp.asarray(g))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(tcomp._dequantize(q, s).numpy(),
                                  np.asarray(jcomp._dequantize(jq, js)))
    tree = {"a": g, "b": {"c": g[:3] * 0.1}}
    tq, jqt = tcomp.quantize_tree(jax.tree.map(torch.from_numpy, tree)), jcomp.quantize_tree(
        jax.tree.map(jnp.asarray, tree))
    np.testing.assert_array_equal(tq["b"]["c"][0].numpy(), np.asarray(jqt["b"]["c"][0]))
    res = (rng.standard_normal(g.shape) * 0.01).astype(np.float32)
    for got, want in zip(tcomp.ef_update(torch.from_numpy(g), torch.from_numpy(res)),
                         jcomp.ef_update(jnp.asarray(g), jnp.asarray(res))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
