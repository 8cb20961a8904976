"""Chunked prefill in the port's serve engine on the CPU
(``repro_torch.serve.engine``, ``prefill_chunk``).

Served traces run llama3.2-1b reduced in float32 on both sides, the
reference's weights carried across by ``repro_torch.bridge``, and must be
token-identical to ``repro.serve.ServeEngine(prefill_chunk=...)`` — greedy
and sampled, contiguous and paged, under preemption and under a step budget
that skips chunks — with the same chunk, preemption and slot-reuse counts
and the same ``metrics()`` (but ``programs``, which is each engine's own).
The chunk programs also run through ``_DryGraph``, the tests' stand-in for
a CUDA graph (capture runs the step's Python and none of its writes, a
replay runs the step).  Every chunk is ``prefill_chunk`` wide, the final one
overlapping the chunk before it; it must leave the pool and the sampled
token an exact-width final chunk leaves.  ``scatter_chunk_pages`` writes a
chunk in one scatter, bit-identical to the token-by-token loop and to the
reference's.
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
from repro.kernels import paged_attention as jpa
from repro.models import lm as jlm
from repro.serve import Request as JRequest
from repro.serve import Sampler as JSampler
from repro.serve import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import paged_attention as pa
from repro_torch.runtime import programs as runtime_programs
from repro_torch.serve import Request, Sampler, ServeEngine
from repro_torch.serve.sampler import POLICIES

CFG = get_config("llama3.2-1b").reduced()
F32 = dataclasses.replace(CFG, compute_dtype="float32")
J32 = dataclasses.replace(jget("llama3.2-1b").reduced(), compute_dtype="float32", remat="none")


@pytest.fixture(scope="module")
def weights():
    jparams = jlm.init_params(J32, seed=0)
    return jparams, bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), F32)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


class _NoWrites(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._schema.is_mutable:
            return args[0]
        return func(*args, **(kwargs or {}))


class _DryGraph:
    """A CUDA graph's contract on the CPU (stands in for ``runtime.programs.Graph``);
    a step with no outputs (``extend``) replays for its writes alone."""

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


def _graphed(engine, monkeypatch):
    monkeypatch.setattr(runtime_programs, "Graph", _DryGraph)
    for name in engine.graph_stats():  # the step programs
        program = engine.programs[name]
        program.graphed = True
    return engine


# -- served traces against the reference -------------------------------------------------

#: (prompt lengths, generation lengths, engine kwargs); chunk 8, max_len 64
TRACES = {
    "contiguous": ((30, 5, 21, 9, 17), (6, 12, 4, 8, 5), dict(n_slots=2)),
    "paged": ((30, 5, 21, 9, 17), (6, 12, 4, 8, 5), dict(n_slots=3, page_size=4)),
    # 6 pages of 8 for requests that end at 24-40 tokens: preemption of
    # decoding and of mid-prefill slots
    "preemption": ((30, 5, 21, 9, 17), (6, 12, 4, 8, 5),
                   dict(n_slots=3, page_size=8, n_pages=6)),
    # the budget is set after the first step (see _drive): the long
    # prompt's chunks are then skipped, their tokens reserved, while the
    # two short requests decode for more steps than a chunk is long
    "budget_skip_contiguous": ((3, 3, 30), (20, 20, 4), dict(n_slots=3)),
    "budget_skip_paged": ((3, 3, 30), (20, 20, 4), dict(n_slots=3, page_size=4)),
}
CHUNK = 8


def _drive(engine, request_cls, prompts, gens, samplers=None, budget_after=None):
    """Serve the trace; with ``budget_after`` the engine admits the first
    step unbudgeted, then runs under that step budget.  Returns the tokens
    per request and the most consecutive steps a mid-prefill slot was
    skipped while others decoded."""
    samplers = samplers or [None] * len(prompts)
    ids = [engine.submit(request_cls(p, max_new_tokens=g, sampling=s))
           for p, g, s in zip(prompts, gens, samplers)]
    skipped, worst = {}, 0
    port = isinstance(engine, ServeEngine)
    while engine.scheduler.has_work:
        before = {s: p.pos for s, p in engine._prefilling.items()} if port else {}
        events = engine.step()
        if budget_after is not None:
            engine.scheduler.max_tokens_per_step = budget_after
        decoded = any(getattr(e, "phase", None) == "decode" for e in events)
        for slot, pos in before.items():
            if decoded and slot in engine._prefilling and engine._prefilling[slot].pos == pos:
                skipped[slot] = skipped.get(slot, 0) + 1
                worst = max(worst, skipped[slot])
            else:
                skipped.pop(slot, None)
    return [engine.completions[i].tokens for i in ids], worst


def _metrics(engine):
    out = engine.metrics()
    out.pop("programs")
    return out


def _check_against_reference(jeng, teng):
    for field in ("prefill_chunks", "preemptions", "slot_reuses", "prefill_calls",
                  "decode_steps", "steps"):
        assert getattr(teng.stats, field) == getattr(jeng.stats, field), field
    assert _metrics(teng) == _metrics(jeng)
    for phase in ("prefill", "decode"):
        assert teng.telemetry[phase].calls == jeng.telemetry[phase].calls
        assert teng.telemetry[phase].tokens == jeng.telemetry[phase].tokens
    if teng.kv is not None:
        teng.kv.pool.check_leaks()
        assert teng.kv.pool.used_pages == 0


@pytest.mark.parametrize("graphs", [False, True], ids=["direct", "dry_graphs"])
@pytest.mark.parametrize("name", sorted(TRACES))
def test_greedy_chunked_trace_token_identical_to_reference(name, graphs, weights, rng,
                                                           monkeypatch):
    jparams, tparams = weights
    lens, gens, kw = TRACES[name]
    prompts = [rng.integers(0, CFG.vocab_size, n).tolist() for n in lens]
    budget = 4 if name.startswith("budget_skip") else None
    jeng = JServeEngine(J32, params=jparams, max_len=64, seed=0, prefill_chunk=CHUNK, **kw)
    want, _ = _drive(jeng, JRequest, prompts, gens, budget_after=budget)
    teng = ServeEngine(F32, params=tparams, max_len=64, seed=0, device="cpu",
                       prefill_chunk=CHUNK, **kw)
    if graphs:
        _graphed(teng, monkeypatch)
    got, worst = _drive(teng, Request, prompts, gens, budget_after=budget)
    assert got == want
    _check_against_reference(jeng, teng)
    assert teng.stats.prefill_chunks > 0
    if name == "preemption":
        assert teng.stats.preemptions > 0
    if budget is not None:
        assert worst > CHUNK
    stats = teng.graph_stats()
    assert stats["extend"]["calls"] + stats["extend_sample"]["calls"] == teng.stats.prefill_chunks
    if graphs:
        assert stats["extend"]["captures"] == 1 and stats["extend"]["replays"] > 0
        final = stats["extend_sample"]  # greedy only: captured at its second call
        assert final["captures"] == min(1, final["calls"] - 1)


@pytest.mark.parametrize("graphs", [False, True], ids=["direct", "dry_graphs"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_sampled_chunked_trace_token_identical_to_reference(paged, graphs, weights, rng,
                                                            monkeypatch):
    """Temperature and top-k requests beside greedy ones: the final chunk
    samples with the request's (seed, token index) key; one
    ``extend_sample`` graph per policy."""
    jparams, tparams = weights
    lens, gens = (30, 12, 26, 9, 19, 25), (6, 8, 4, 8, 5, 3)
    prompts = [rng.integers(0, CFG.vocab_size, n).tolist() for n in lens]
    kinds = ["temperature", None, "top_k", "temperature", "top_k", None]

    def samplers(cls):
        knobs = {None: None, "temperature": cls.with_temperature(0.8),
                 "top_k": cls.with_top_k(20, 1.1)}
        return [knobs[k] for k in kinds]

    kw = dict(n_slots=2, max_len=64, seed=0, prefill_chunk=CHUNK)
    if paged:
        kw["page_size"] = 4
    want, _ = _drive(JServeEngine(J32, params=jparams, **kw), JRequest, prompts, gens,
                     samplers(JSampler))
    teng = ServeEngine(F32, params=tparams, device="cpu", **kw)
    if graphs:
        _graphed(teng, monkeypatch)
    got, _ = _drive(teng, Request, prompts, gens, samplers(Sampler))
    assert got == want
    assert teng.stats.prefill_chunks > len(lens)
    final = teng.graph_stats()["extend_sample"]
    policies = {key.split()[0] for key in final["graphs"]}
    if graphs:
        assert policies == {f"policy={p}" for p in POLICIES}
        assert final["captures"] == 3 and final["replays"] > 0
    else:
        assert final["captures"] == 0 and final["eager_calls"] == final["calls"]


def test_chunk_functions_read_nothing_on_the_host():
    """A CUDA graph captures a step only if it reads nothing on the host:
    the chunk programs run under ``FakeTensorMode``, where a read raises."""
    for kw in (dict(), dict(page_size=4)):
        engine = ServeEngine(CFG, n_slots=2, max_len=32, device="cpu", prefill_chunk=8, **kw)
        mode = FakeTensorMode()
        fake = mode.from_tensor
        engine.params = _tree_map(fake, engine.params)
        engine.cache = _tree_map(fake, engine.cache)
        i32 = lambda v: fake(torch.tensor([v], dtype=torch.int32))  # noqa: E731
        pages = fake(torch.zeros((1, 8 if engine.paged else 1), dtype=torch.int32))
        tokens = fake(torch.zeros((1, 8), dtype=torch.int32))
        with mode, torch.no_grad():
            assert engine._extend_step(i32(1), i32(8), pages, tokens) is None
            for policy in POLICIES:
                tok, logits = engine._extend_sample_step(
                    i32(1), i32(16), pages, i32(3), i32(0), fake(torch.tensor([0.8])), i32(5),
                    tokens, policy=policy)
                assert tok.shape == (1,) and logits.shape == (1, CFG.vocab_size)


# -- the overlapped final window -------------------------------------------------------


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_overlapped_final_window_matches_exact_width(paged, weights, rng):
    """The final chunk over ``[ctx - C, ctx)`` re-extends positions the
    chunk before wrote: it leaves the cache an exact-width final chunk over
    ``[pos, ctx)`` leaves, and samples the same token.  The window's
    products run at C rows, the exact chunk's at ``ctx - pos``: f32 to 1e-6
    (a BLAS may tile the two row counts differently)."""
    _, tparams = weights
    kw = dict(page_size=4) if paged else {}
    engine = ServeEngine(F32, params=tparams, n_slots=2, max_len=32, seed=0, device="cpu",
                         prefill_chunk=CHUNK, **kw)
    context = rng.integers(0, CFG.vocab_size, 13).tolist()
    engine.submit(Request(context, max_new_tokens=4))
    with torch.no_grad():
        engine.step()  # admits the request and runs its first chunk
        (slot, prog), = engine._prefilling.items()
        assert prog.pos == CHUNK
        engine._ensure_pages(slot, len(context))
        saved = _tree_map(torch.clone, engine.cache)
        t32 = lambda a: torch.tensor(np.asarray(a, np.int32))  # noqa: E731
        pages = t32(engine.kv.array()[slot : slot + 1] if paged else [[0]])

        def final(start):
            _tree_map(lambda pair: pair[0].copy_(pair[1]), _zip(engine.cache, saved))
            tok, logits = engine._extend_sample_step(
                t32([slot]), t32([start]), pages, t32([7]), t32([0]), torch.tensor([0.9]),
                t32([0]), t32([context[start:]]), policy="temperature")
            return tok, logits, _tree_map(torch.clone, engine.cache)

        tok_exact, logits_exact, exact = final(CHUNK)
        tok_window, logits_window, window = final(len(context) - CHUNK)
    assert torch.equal(tok_window, tok_exact)
    torch.testing.assert_close(logits_window, logits_exact, rtol=1e-6, atol=1e-6)
    for key, group in exact.items():
        if key == "index":
            assert torch.equal(window[key], group) and int(group[slot]) == len(context)
            continue
        for leaf, value in group.items():
            torch.testing.assert_close(window[key][leaf], value, rtol=1e-6, atol=1e-6)


def _zip(a, b):
    if isinstance(a, dict):
        return {k: _zip(a[k], b[k]) for k in a}
    return (a, b)


def test_final_window_costs_overlap_tokens(weights, rng):
    """The final chunk re-extends ``C - run`` positions; the budget and the
    prefill telemetry count only ``run``, as the reference does."""
    _, tparams = weights
    engine = ServeEngine(F32, params=tparams, n_slots=2, max_len=64, seed=0, device="cpu",
                         prefill_chunk=CHUNK, page_size=4)
    lens = (13, 30, 8, 17)
    for n in lens:
        engine.submit(Request(rng.integers(0, CFG.vocab_size, n).tolist(), max_new_tokens=2))
    engine.run_until_idle(max_steps=200)
    chunked = [n for n in lens if n > CHUNK]
    assert engine.overlap_tokens == sum(-n % CHUNK for n in chunked)
    assert engine.stats.prefill_chunks == sum(-(-n // CHUNK) for n in chunked)
    assert engine.telemetry["prefill"].tokens == sum(lens)


# -- the vectorised chunk scatter -------------------------------------------------------


def _token_loop(pool, val, pages, index, seq_axis):
    for i in range(val.shape[seq_axis]):
        pa.scatter_token_pages(pool, val.select(seq_axis, i), pages, index + i, seq_axis)
    return pool


@pytest.mark.parametrize("seed", range(4))
def test_scatter_chunk_pages_bit_identical_to_token_loop(seed):
    """Random tables with null entries, chunks that run past the table
    (the clamped column) and rows sharing the null page."""
    g = torch.Generator().manual_seed(seed)
    for _ in range(50):
        b, s = (int(torch.randint(1, 5, (1,), generator=g)),
                int(torch.randint(1, 12, (1,), generator=g)))
        ps, mp = (int(torch.randint(1, 6, (1,), generator=g)),
                  int(torch.randint(1, 5, (1,), generator=g)))
        n_pages = b * mp
        pool = torch.randn(n_pages + 1, 2, ps, 3, generator=g)
        perm = torch.randperm(n_pages, generator=g).int().reshape(b, mp)
        null = torch.rand(b, mp, generator=g) < 0.3
        pages = torch.where(null, torch.full_like(perm, n_pages), perm)
        index = torch.randint(0, mp * ps + 3, (b,), generator=g).int()
        val = torch.randn(b, 2, s, 3, generator=g)
        want = _token_loop(pool.clone(), val, pages, index, 2)
        got = pa.scatter_chunk_pages(pool.clone(), val, pages, index, 2)
        assert torch.equal(got, want)


def test_scatter_chunk_pages_matches_reference(rng):
    """The same writes as ``repro.kernels.paged_attention.scatter_chunk_pages``
    (GQA layout; one row's chunk runs past its table and clamps)."""
    b, kh, s, d, ps, mp = 3, 2, 9, 4, 4, 3
    n_pages = b * mp
    pool = rng.standard_normal((n_pages + 1, kh, ps, d)).astype(np.float32)
    pages = rng.permutation(n_pages).astype(np.int32).reshape(b, mp)
    pages[1, 2] = n_pages  # an unallocated entry: the null page
    index = np.asarray([0, 2, 7], np.int32)  # row 2 writes positions 7..15 > 12
    val = rng.standard_normal((b, kh, s, d)).astype(np.float32)
    want = np.asarray(jpa.scatter_chunk_pages(
        jnp.asarray(pool), jnp.asarray(val), jnp.asarray(pages), jnp.asarray(index), 2))
    got = pa.scatter_chunk_pages(torch.from_numpy(pool.copy()), torch.from_numpy(val),
                                 torch.from_numpy(pages), torch.from_numpy(index), 2)
    # the null page's rows are garbage by contract; every other row is exact
    assert np.array_equal(got.numpy()[:n_pages], want[:n_pages])
