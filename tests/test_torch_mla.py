"""The port's MLA mixer (``repro_torch.models.attention.mla_forward``) against
``repro.models.attention.mla_forward``, and deepseek-v2-236b (MLA with MoE
layers after one dense layer) served token-identically to
``repro.serve.ServeEngine``.

Reduced deepseek-v2 in float32 (latent 32, qk 16 + 8 rope, v 16), inputs
and caches seeded with numpy, the reference's weights carried across.  The
mixer runs in its four modes — train and prefill (the latent expanded, the
``attention`` block at qk 24 / v 16), decode and extend on the contiguous
cache (the absorbed f32 einsums) and on the paged one (the absorbed form
through the ``paged_attention`` block, the latent pool as keys and values,
the rope pool beside it) — and is held to 1e-5, the cache leaves too.  A
served trace also runs with ``_DryGraph`` standing in for the CUDA graph
(capture runs the step's Python and none of its writes, a replay runs the
step), so every step program's captured call is the eager one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

import repro_torch.kernels as kernels
from repro.configs import get_config as jget
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import attention as tattn
from repro_torch.models import lm
from repro_torch.runtime import programs as runtime_programs
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.sampler import POLICIES

ARCH = "deepseek-v2-236b"
JCFG = dataclasses.replace(jget(ARCH).reduced(), compute_dtype="float32", remat="none")
TCFG = dataclasses.replace(get_config(ARCH).reduced(), compute_dtype="float32")
TOL = dict(rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def weights():
    jparams = jlm.init_params(JCFG, seed=0)
    return jparams, bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), TCFG)


def _layer_attn(jparams, tparams, group="g1_a"):
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][group]["attn"])
    tp = {k: v[0] for k, v in tparams["blocks"][group]["attn"].items()}
    return jp, tp


def test_metas_match_reference():
    """Parameter and cache metas (contiguous and paged) and the seq axes."""
    for jmeta, tmeta in ((jattn.attn_metas(JCFG), tattn.attn_metas(TCFG)),
                         (jattn.cache_metas(JCFG, 3, 20), tattn.cache_metas(TCFG, 3, 20)),
                         (jattn.cache_metas_paged(JCFG, 9, 4),
                          tattn.cache_metas_paged(TCFG, 9, 4))):
        assert sorted(jmeta) == sorted(tmeta)
        for key in jmeta:
            j, t = jmeta[key], tmeta[key]
            assert (j.shape, j.axes, j.dtype, j.init) == (t.shape, t.axes, t.dtype, t.init)
    assert tattn.cache_seq_axes(TCFG) == jattn.cache_seq_axes(JCFG) == {"c": 1, "kr": 1}


def _np_cache(rng, shapes):
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


#: (mode, S, paged)
CASES = [("train", 12, False), ("prefill", 12, False), ("decode", 1, False),
         ("extend", 3, False), ("decode", 1, True), ("extend", 3, True)]


@pytest.mark.parametrize("mode,s,paged", CASES,
                         ids=[f"{m}_{'paged' if p else 'contiguous'}" for m, _, p in CASES])
def test_mla_forward_matches_reference(mode, s, paged, weights, rng):
    jparams, tparams = weights
    jp, tp = _layer_attn(*weights)
    m = TCFG.mla
    b, ps, n_pages, mp = 3, 4, 12, 4
    x = rng.standard_normal((b, s, TCFG.d_model)).astype(np.float32)
    lengths = np.asarray([9, 0, 11], np.int32)
    pages = None
    if mode in ("train", "prefill"):
        positions = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
        index = None
        cache = (None if mode == "train" else
                 {k: np.zeros(v, np.float32)
                  for k, v in {"c": (b, 16, m.kv_lora_rank),
                               "kr": (b, 16, m.qk_rope_head_dim)}.items()})
    else:
        positions = lengths[:, None] + np.arange(s, dtype=np.int32)
        index = lengths
        rows, seq = (n_pages + 1, ps) if paged else (b, mp * ps)
        cache = _np_cache(rng, {"c": (rows, seq, m.kv_lora_rank),
                                "kr": (rows, seq, m.qk_rope_head_dim)})
        if paged:  # each slot's pages shuffled; past its allocation the null page
            pages = np.full((b, mp), n_pages, np.int32)
            perm = rng.permutation(n_pages)
            for i, ln in enumerate(lengths):
                used = -(-(ln + s) // ps)
                pages[i, :used] = perm[i * mp : i * mp + used]

    def j(a):
        return None if a is None else jnp.asarray(a)

    def t(a):
        return None if a is None else torch.from_numpy(np.array(a))

    jout, jcache = jattn.mla_forward(
        jp, j(x), JCFG, j(positions), jax.tree.map(j, cache), j(index), mode, j(pages))
    tout, tcache = tattn.mla_forward(
        tp, t(x), TCFG, t(positions), jax.tree.map(t, cache), t(index), mode, t(pages))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    if cache is None:
        assert tcache is None and jcache is None
        return
    assert sorted(tcache) == sorted(jcache) == ["c", "kr"]
    for leaf in jcache:
        np.testing.assert_allclose(tcache[leaf].numpy(), np.asarray(jcache[leaf]), **TOL)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_lm_decode_after_prefill_matches_reference(paged, weights, rng):
    """The whole LM (one dense layer, then MoE layers): prefill into a
    batch-1 cache, then decode and extend steps on that cache."""
    jparams, tparams = weights
    kw = dict(page_size=4, n_pages=8) if paged else {}
    tokens = rng.integers(0, TCFG.vocab_size, (1, 9)).astype(np.int32)
    jcache = jlm.init_cache(JCFG, 1, 32, **kw)
    tcache = lm.init_cache(TCFG, 1, 32, **kw)
    extra_j, extra_t = {}, {}
    if paged:
        table = np.arange(8, dtype=np.int32)[None]
        extra_j, extra_t = {"pages": jnp.asarray(table)}, {"pages": torch.from_numpy(table)}
        # the prefill writes the contiguous layout; fill the pool through
        # extend from position 0 instead
        jcache = dict(jcache, index=jnp.zeros((1,), jnp.int32))
        jl, _, jcache = jlm.forward(jparams, {"tokens": jnp.asarray(tokens)}, JCFG,
                                    "extend", dict(jcache, **extra_j))
        tl, tcache = lm.forward(tparams, {"tokens": torch.from_numpy(tokens)}, TCFG,
                                "extend", dict(tcache, **extra_t))
    else:
        jl, jcache = jlm.prefill(jparams, {"tokens": jnp.asarray(tokens)}, JCFG, jcache)
        tl, tcache = lm.prefill(tparams, {"tokens": torch.from_numpy(tokens)}, TCFG, tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    for n in (1, 3):  # a decode step, then a 3-token extend
        step = rng.integers(0, TCFG.vocab_size, (1, n)).astype(np.int32)
        mode = "decode" if n == 1 else "extend"
        jcache.pop("pages", None)
        tcache.pop("pages", None)
        jl, _, jcache = jlm.forward(jparams, {"tokens": jnp.asarray(step)}, JCFG, mode,
                                    dict(jcache, **extra_j))
        tl, tcache = lm.forward(tparams, {"tokens": torch.from_numpy(step)}, TCFG, mode,
                                dict(tcache, **extra_t))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    assert int(tcache["index"][0]) == int(jcache["index"][0]) == 13
    for key in ("g0_d", "g1_a"):
        for leaf in ("c", "kr"):
            np.testing.assert_allclose(tcache[key][leaf].numpy(), np.asarray(jcache[key][leaf]),
                                       rtol=0, atol=1e-4)


# -- deepseek-v2 served against the reference engine -------------------------------------


class _NoWrites(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._schema.is_mutable:
            return args[0]
        return func(*args, **(kwargs or {}))


class _DryGraph:
    """A CUDA graph's contract on the CPU (stands in for ``runtime.programs.Graph``)."""

    def __init__(self, run, pool):
        self.run = run
        with _NoWrites():
            self.outputs = run()

    def replay(self):
        held = kernels.counters()
        new = self.run()
        kernels.add_counters({k: held[k] - n for k, n in kernels.counters().items()})
        for out, value in zip(self.outputs or (), new or ()):
            out.copy_(value)
        return self.outputs


def _trace(engine, request_cls, prompts, gens):
    ids = [engine.submit(request_cls(p, max_new_tokens=g)) for p, g in zip(prompts, gens)]
    engine.run_until_idle(max_steps=2000)
    return [engine.completions[i].tokens for i in ids], engine


LENS, GENS = (30, 5, 21, 9, 17, 30), (6, 12, 4, 8, 5, 3)
TRACES = {
    # name: (engine kwargs, graphed); max_len 64
    "contiguous": (dict(n_slots=3), False),
    "paged": (dict(n_slots=3, page_size=4), False),
    "paged_bucket": (dict(n_slots=3, page_size=4, prefill_bucket=16), False),
    "paged_chunk": (dict(n_slots=3, page_size=4, prefill_chunk=16), False),
    # every program through _DryGraph: repeated bucket lengths replay prefill
    "paged_bucket_chunk_dry_graphs": (
        dict(n_slots=3, page_size=4, prefill_bucket=16, prefill_chunk=20), True),
}


@pytest.mark.parametrize("name", sorted(TRACES))
def test_deepseek_greedy_trace_token_identical_to_reference(name, weights, rng, monkeypatch):
    jparams, tparams = weights
    kw, graphed = TRACES[name]
    prompts = [rng.integers(0, TCFG.vocab_size, n).tolist() for n in LENS]
    want, jeng = _trace(JServeEngine(JCFG, params=jparams, max_len=64, seed=0, **kw),
                        JRequest, prompts, GENS)
    engine = ServeEngine(TCFG, params=tparams, max_len=64, seed=0, device="cpu", **kw)
    if graphed:
        monkeypatch.setattr(runtime_programs, "Graph", _DryGraph)
        for name in engine.graph_stats():  # the step programs
            program = engine.programs[name]
            program.graphed = True
    got, teng = _trace(engine, Request, prompts, GENS)
    assert got == want
    for field in ("prefill_chunks", "slot_reuses", "decode_steps"):
        assert getattr(teng.stats, field) == getattr(jeng.stats, field), field
    if graphed:
        stats = teng.graph_stats()
        for name in ("decode", "prefill", "extend", "extend_sample"):
            assert stats[name]["replays"] > 0, (name, stats[name])
    if teng.kv is not None:
        teng.kv.pool.check_leaks()


def test_mla_steps_read_nothing_on_the_host():
    """Decode, prefill and both chunk programs of deepseek-v2 (MLA and MoE)
    under ``FakeTensorMode``, where any host read raises."""
    for kw in (dict(), dict(page_size=4)):
        engine = ServeEngine(get_config(ARCH).reduced(), n_slots=2, max_len=32, device="cpu",
                             prefill_chunk=8, **kw)
        mode = FakeTensorMode()
        fake = mode.from_tensor
        engine.params = jax.tree.map(fake, engine.params)
        engine.cache = jax.tree.map(fake, engine.cache)
        engine._b1_cache = jax.tree.map(fake, engine._b1_cache)
        if engine.paged:
            engine._pages_dev = fake(engine._pages_dev)
        i32 = lambda v: fake(torch.tensor([v], dtype=torch.int32))  # noqa: E731
        toks = lambda n: fake(torch.zeros((1, n), dtype=torch.int32))  # noqa: E731
        pages = fake(torch.zeros((1, 8 if engine.paged else 1), dtype=torch.int32))
        decode_in = [fake(torch.from_numpy(a.copy())) for a in engine._decode_inputs()]
        with mode, torch.no_grad():
            for policy in POLICIES:
                tok, _ = engine._decode_step(*decode_in, policy=policy)
                assert tok.shape == (2,)
                tok, _ = engine._prefill_step(i32(6), i32(11), i32(0), fake(torch.tensor([0.8])),
                                              i32(5), toks(8), policy=policy)
                assert tok.shape == (1,)
                tok, _ = engine._extend_sample_step(i32(1), i32(16), pages, i32(3), i32(0),
                                                    fake(torch.tensor([0.8])), i32(5), toks(5),
                                                    policy=policy)
                assert tok.shape == (1,)
            assert engine._extend_step(i32(1), i32(8), pages, toks(8)) is None
