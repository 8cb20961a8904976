"""The port's MoE FFN (``repro_torch.models.moe``) against ``repro.models.moe``,
and arctic-480b (128 experts top-2 beside a dense residual FFN) served
token-identically to ``repro.serve.ServeEngine``.

Inputs are seeded with numpy; the reference's weights cross through
``repro_torch.bridge``; reduced configs in float32.  Routing is discrete:
``jax.lax.top_k`` breaks ties toward the lower index and ``torch.topk``
promises no order, so the gates here are softmaxes of random f32 logits,
which hold no ties; the expert index tables and dispatch fractions must
then be equal and the combine weights equal to the bit.  The combine sums
up to top_k rows a token in another order than the reference's scatter-add,
so outputs are held to 1e-5, and served traces to token identity.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jget
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.sampler import POLICIES

ATOL = 1e-5


def _cfgs(arch, **moe_kw):
    jcfg = dataclasses.replace(jget(arch).reduced(), compute_dtype="float32", remat="none")
    tcfg = dataclasses.replace(get_config(arch).reduced(), compute_dtype="float32")
    if moe_kw:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe_kw))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, **moe_kw))
    return jcfg, tcfg


def _gates(rng, s, e):
    logits = rng.standard_normal((s, e)).astype(np.float32)
    g = np.exp(logits - logits.max(-1, keepdims=True))
    return (g / g.sum(-1, keepdims=True)).astype(np.float32)


# -- routing ---------------------------------------------------------------------------


def test_capacity_of_matches_reference():
    for arch in ("deepseek-v2-236b", "arctic-480b"):
        jm, tm = jget(arch).moe, get_config(arch).moe
        for s in (1, 3, 16, 64, 128, 512, 4096):
            assert moe.capacity_of(s, tm) == jmoe.capacity_of(s, jm)


@pytest.mark.parametrize("s,e,k,cap", [(16, 4, 2, 8), (64, 8, 2, 8), (40, 16, 6, 12),
                                       (1, 160, 6, 4)])
def test_route_row_matches_reference(s, e, k, cap, rng):
    """idx and frac equal to the reference's, w within 0; the smaller
    capacities drop tokens (their choices land on the sentinel)."""
    gates = _gates(rng, s, e)
    jidx, jw, jfrac = jmoe.route_row(jnp.asarray(gates), k, cap)
    idx, w, frac = moe.route_row(torch.from_numpy(gates), k, cap)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(frac.numpy(), np.asarray(jfrac))
    if s * k > e * cap:
        assert int((idx < s).sum()) < s * k  # some choices were dropped


def _moe_params(jcfg, tcfg, seed):
    jp = jlm.init_params(jcfg, seed=seed)["blocks"]
    key = next(k for k in jp if k.endswith("_a"))
    jlayer = jax.tree.map(lambda a: np.asarray(a[0]), jp[key]["moe"])
    tlayer = jax.tree.map(torch.from_numpy, jlayer)
    return jax.tree.map(jnp.asarray, jlayer), tlayer


@pytest.mark.parametrize("s", [1, 12, 64])
@pytest.mark.parametrize("arch,moe_kw", [
    ("deepseek-v2-236b", {}),
    ("arctic-480b", {}),
    # a quarter of the capacity: most rows drop tokens
    ("deepseek-v2-236b", dict(capacity_factor=0.25)),
    ("arctic-480b", dict(capacity_factor=0.25)),
], ids=["deepseek", "arctic", "deepseek_drops", "arctic_drops"])
def test_moe_forward_matches_reference(arch, moe_kw, s, rng):
    """Output and aux loss within 1e-5, shared experts (deepseek) and the
    dense residual (arctic) included; B=3 rows routed apart."""
    jcfg, tcfg = _cfgs(arch, **moe_kw)
    jp, tp = _moe_params(jcfg, tcfg, seed=s)
    x = rng.standard_normal((3, s, tcfg.d_model)).astype(np.float32)
    jout, jaux = jmoe.moe_forward(jp, jnp.asarray(x), jcfg, jnp.float32)
    out, aux = moe.moe_forward(tp, torch.from_numpy(x), tcfg, torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=ATOL)
    assert ("shared" in tp) == (arch == "deepseek-v2-236b")
    assert ("dense" in tp) == (arch == "arctic-480b")
    if moe_kw and s == 64:
        gates = torch.softmax(torch.from_numpy(x) @ tp["router"], -1)
        idx, *_ = moe.route(gates, tcfg.moe.top_k, moe.capacity_of(s, tcfg.moe))
        assert int((idx < s).sum()) < 3 * s * tcfg.moe.top_k


def test_moe_forward_reads_nothing_on_the_host():
    """A CUDA graph captures the MoE only if it reads nothing on the host:
    under ``FakeTensorMode`` any such read raises."""
    _, tcfg = _cfgs("deepseek-v2-236b")
    params = moe.moe_metas(tcfg)
    mode = FakeTensorMode()
    with mode:
        tp = jax.tree.map(lambda m: torch.randn(m.shape), params,
                          is_leaf=lambda m: hasattr(m, "shape"))
        out, aux = moe.moe_forward(tp, torch.randn(2, 9, tcfg.d_model), tcfg, torch.float32)
    assert out.shape == (2, 9, tcfg.d_model) and aux.shape == ()


# -- arctic served against the reference engine ------------------------------------------


@pytest.fixture(scope="module")
def arctic():
    jcfg, tcfg = _cfgs("arctic-480b")
    jparams = jlm.init_params(jcfg, seed=0)
    return jcfg, tcfg, jparams, bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)


def _trace(engine, request_cls, prompts, gens):
    ids = [engine.submit(request_cls(p, max_new_tokens=g)) for p, g in zip(prompts, gens)]
    engine.run_until_idle(max_steps=2000)
    return [engine.completions[i].tokens for i in ids], engine


#: prompt lengths, generation lengths; engine kwargs per trace (max_len 64)
LENS, GENS = (30, 5, 21, 9, 17), (6, 12, 4, 8, 5)
TRACES = {
    "contiguous": dict(n_slots=3),
    "paged": dict(n_slots=3, page_size=4),
    "paged_bucket": dict(n_slots=3, page_size=4, prefill_bucket=16),
    "paged_chunk": dict(n_slots=3, page_size=4, prefill_chunk=16),
}


@pytest.mark.parametrize("name", sorted(TRACES))
def test_arctic_greedy_trace_token_identical_to_reference(name, arctic, rng):
    jcfg, tcfg, jparams, tparams = arctic
    kw = TRACES[name]
    prompts = [rng.integers(0, tcfg.vocab_size, n).tolist() for n in LENS]
    want, jeng = _trace(JServeEngine(jcfg, params=jparams, max_len=64, seed=0, **kw),
                        JRequest, prompts, GENS)
    got, teng = _trace(ServeEngine(tcfg, params=tparams, max_len=64, seed=0, device="cpu", **kw),
                       Request, prompts, GENS)
    assert got == want
    for field in ("prefill_chunks", "slot_reuses", "decode_steps"):
        assert getattr(teng.stats, field) == getattr(jeng.stats, field), field


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_chunked_trace_with_drops_token_identical_to_reference(paged, rng):
    """With a quarter of the capacity a 16-token chunk drops tokens, so a
    token's value depends on its chunk: the final chunk runs at its exact
    width (no overlapped window), as the reference's, and the trace stays
    token-identical."""
    jcfg, tcfg = _cfgs("arctic-480b", capacity_factor=0.25)
    jparams = jlm.init_params(jcfg, seed=2)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    kw = dict(n_slots=2, prefill_chunk=16, **(dict(page_size=4) if paged else {}))
    prompts = [rng.integers(0, tcfg.vocab_size, n).tolist() for n in (37, 20, 9)]
    gens = (5, 4, 6)
    want, _ = _trace(JServeEngine(jcfg, params=jparams, max_len=64, seed=0, **kw),
                     JRequest, prompts, gens)
    got, teng = _trace(ServeEngine(tcfg, params=tparams, max_len=64, seed=0, device="cpu", **kw),
                       Request, prompts, gens)
    assert got == want
    assert teng.overlap_tokens == 0 and teng.stats.prefill_chunks == 3 + 2


def test_moe_chunk_functions_read_nothing_on_the_host():
    """The chunk programs of an MoE model under ``FakeTensorMode``: a
    non-final chunk and final chunks of two widths."""
    engine = ServeEngine(get_config("arctic-480b").reduced(), n_slots=2, max_len=32,
                         device="cpu", prefill_chunk=8, page_size=4)
    mode = FakeTensorMode()
    fake = mode.from_tensor
    engine.params = jax.tree.map(fake, engine.params)
    engine.cache = jax.tree.map(fake, engine.cache)
    i32 = lambda v: fake(torch.tensor([v], dtype=torch.int32))  # noqa: E731
    pages = fake(torch.zeros((1, 8), dtype=torch.int32))
    with mode, torch.no_grad():
        assert engine._extend_step(i32(1), i32(8), pages,
                                   fake(torch.zeros((1, 8), dtype=torch.int32))) is None
        for width, policy in zip((3, 8), POLICIES):
            tok, logits = engine._extend_sample_step(
                i32(1), i32(16), pages, i32(3), i32(0), fake(torch.tensor([0.8])), i32(5),
                fake(torch.zeros((1, width), dtype=torch.int32)), policy=policy)
            assert tok.shape == (1,) and logits.shape == (1, engine.cfg.vocab_size)
