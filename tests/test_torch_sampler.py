"""The port's sampler against ``repro.serve.sampler`` on the CPU.

The port draws the reference's ``jax.random`` bits (threefry2x32 keys
``fold_in(fold_in(PRNGKey(0), seed), step)``, then ``categorical``), so on
the same logits, seeds, steps, temperatures and top-k the tokens are
identical; the Gumbel noise itself agrees to float32 ``log`` rounding
(1e-6).  A sampled served trace of llama3.2-1b reduced in float32, with
the reference's weights carried across by ``repro_torch.bridge``, is then
token-identical between the two engines.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import lm as jlm
from repro.serve import Request as JRequest
from repro.serve import Sampler as JSampler
from repro.serve import ServeEngine as JServeEngine
from repro.serve.sampler import _slot_key
from repro.serve.sampler import sample_tokens as jsample
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.serve import Request, Sampler, ServeEngine
from repro_torch.serve.sampler import gumbel_noise, sample_tokens, slot_keys

F32 = dataclasses.replace(get_config("llama3.2-1b").reduced(), compute_dtype="float32")
J32 = dataclasses.replace(jget("llama3.2-1b").reduced(), compute_dtype="float32", remat="none")


def test_slot_keys_and_noise_match_jax_random(rng):
    seeds = rng.integers(0, 2**31 - 1, 64).astype(np.int32)
    steps = rng.integers(0, 4096, 64).astype(np.int32)
    want = np.asarray(jax.random.key_data(
        jax.vmap(_slot_key)(jnp.asarray(seeds), jnp.asarray(steps))
    ))
    k0, k1 = slot_keys(torch.from_numpy(seeds), torch.from_numpy(steps))
    np.testing.assert_array_equal(np.stack([k0.numpy(), k1.numpy()], -1).astype(np.uint32), want)
    g = gumbel_noise(torch.from_numpy(seeds[:4]), torch.from_numpy(steps[:4]), 1000)
    jg = np.stack([
        np.asarray(jax.random.gumbel(_slot_key(jnp.int32(s), jnp.int32(t)), (1000,)))
        for s, t in zip(seeds[:4], steps[:4])
    ])
    np.testing.assert_allclose(g.numpy(), jg, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("vocab", [512, 128256])
def test_sample_tokens_identical_to_reference(vocab, rng):
    b = 8
    for _ in range(3):
        logits = (3.0 * rng.standard_normal((b, vocab))).astype(np.float32)
        seeds = rng.integers(0, 2**31 - 1, b).astype(np.int32)
        steps = rng.integers(0, 512, b).astype(np.int32)
        temps = np.array([0.0, 0.8, 1.0, 0.5, 0.0, 1.3, 0.8, 2.0], np.float32)
        top_ks = np.array([0, 40, 0, 5, 3, 0, 1, 100], np.int32)
        want = np.asarray(jsample(*map(jnp.asarray, (logits, seeds, steps, temps, top_ks))))
        got = sample_tokens(*map(torch.from_numpy, (logits, seeds, steps, temps, top_ks)))
        np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_served_trace_token_identical_to_reference(rng):
    jparams = jlm.init_params(J32, seed=0)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), F32)
    prompts = [rng.integers(0, F32.vocab_size, n).tolist() for n in (5, 9, 4)]
    gens = (8, 6, 7)

    def trace(engine, request_cls, sampler):
        ids = [
            engine.submit(request_cls(p, max_new_tokens=g, sampling=sampler))
            for p, g in zip(prompts, gens)
        ]
        engine.run_until_idle(max_steps=500)
        return [engine.completions[i].tokens for i in ids]

    want = trace(
        JServeEngine(J32, params=jparams, n_slots=2, max_len=64, seed=0),
        JRequest, JSampler.with_top_k(40, 0.8),
    )
    got = trace(
        ServeEngine(F32, params=tparams, n_slots=2, max_len=64, seed=0, device="cpu"),
        Request, Sampler.with_top_k(40, 0.8),
    )
    assert got == want
    assert any(len(set(t)) > 1 for t in got)  # really sampled, not constant
