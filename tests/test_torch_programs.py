"""The serve engine's step programs on the CPU (``repro_torch.serve.programs``).

A CUDA graph captures a step only if the step reads nothing on the host,
so the decode and prefill step functions run here under ``FakeTensorMode``,
where any such read raises.  The sampler takes the batch's policy from the
caller and matches ``repro.serve.sampler.sample_tokens``.  The graph path
itself needs the card; here ``DryGraph`` stands in for it with the same
contract (capture runs the step's Python and executes none of its writes, a
replay executes the step and runs no counting Python, into the same output
tensors), so the engine's keys, static buffers, shared batch-1 cache and
launch bookkeeping are checked against the reference engine and against
eager runs.  Traces run reduced configs in float32 with the reference's
weights carried across by ``repro_torch.bridge``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import DataDependentOutputException, FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

import repro_torch.kernels as kernels
from repro.configs import get_config as jget
from repro.models import lm as jlm
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve.sampler import sample_tokens as jsample
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import blocks
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import rmsnorm as rn
from repro_torch.models import lm
from repro_torch.runtime import programs as runtime_programs
from repro_torch.serve import Request, ServeEngine, programs
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.sampler import POLICIES, policy_of, sample_tokens


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _cfgs(arch):
    jcfg = dataclasses.replace(jget(arch).reduced(), compute_dtype="float32", remat="none")
    tcfg = dataclasses.replace(get_config(arch).reduced(), compute_dtype="float32")
    return jcfg, tcfg


class _NoWrites(TorchDispatchMode):
    """Runs every op but those that write a tensor: the writes of a step
    run under it never land, as under a CUDA graph's capture."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._schema.is_mutable:
            return args[0]
        return func(*args, **(kwargs or {}))


class DryGraph:
    """A CUDA graph's contract on the CPU (stands in for ``runtime.programs.Graph``)."""

    def __init__(self, run, pool):
        self.run = run
        with _NoWrites():
            self.outputs = run()

    def replay(self):
        held = kernels.counters()
        new = self.run()
        kernels.add_counters({k: held[k] - n for k, n in kernels.counters().items()})
        for out, value in zip(self.outputs, new):
            out.copy_(value)
        return self.outputs


def _graphed(engine, monkeypatch):
    monkeypatch.setattr(runtime_programs, "Graph", DryGraph)
    for name in engine.graph_stats():  # the step programs
        program = engine.programs[name]
        program.graphed = True
    return engine


# -- no host reads ------------------------------------------------------------------

STEP_CASES = {
    # name: (arch, engine kwargs)
    "llama_paged": ("llama3.2-1b", dict(page_size=4)),
    "mamba2_contiguous": ("mamba2-2.7b", {}),
    "zamba2_paged": ("zamba2-7b", dict(page_size=4)),
    # MLA and MoE (deepseek-v2), MoE beside a dense residual (arctic)
    "deepseek_paged": ("deepseek-v2-236b", dict(page_size=4)),
    "deepseek_contiguous": ("deepseek-v2-236b", {}),
    "arctic_paged": ("arctic-480b", dict(page_size=4)),
}


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_step_functions_read_nothing_on_the_host(case, policy):
    arch, kw = STEP_CASES[case]
    engine = ServeEngine(get_config(arch).reduced(), n_slots=2, max_len=32, device="cpu", **kw)
    mode = FakeTensorMode()
    fake = mode.from_tensor
    engine.params = _tree_map(fake, engine.params)
    engine.cache = _tree_map(fake, engine.cache)
    engine._b1_cache = _tree_map(fake, engine._b1_cache)
    if engine.paged:
        engine._pages_dev = fake(engine._pages_dev)
    engine._temps[:] = 0.8
    engine._topks[:] = 5
    decode_in = [fake(torch.from_numpy(a.copy())) for a in engine._decode_inputs()]
    i32 = lambda v: fake(torch.tensor([v], dtype=torch.int32))  # noqa: E731
    prefill_in = [i32(6), i32(11), i32(0), fake(torch.tensor([0.8])), i32(5),
                  fake(torch.zeros((1, 8), dtype=torch.int32))]
    with mode, torch.no_grad():
        tok, logits = engine._decode_step(*decode_in, policy=policy)
        assert tok.shape == (2,) and logits.shape == (2, engine.cfg.vocab_size)
        tok, logits = engine._prefill_step(*prefill_in, policy=policy)
        assert tok.shape == (1,) and logits.shape == (1, engine.cfg.vocab_size)


def test_policyless_sampler_reads_the_host_under_fake_tensors():
    with FakeTensorMode():
        logits = torch.zeros((2, 16))
        knobs = (torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=torch.int32),
                 torch.full((2,), 0.8), torch.zeros(2, dtype=torch.int32))
        with pytest.raises(DataDependentOutputException):
            sample_tokens(logits, *knobs)
        assert sample_tokens(logits, *knobs, policy="temperature").shape == (2,)


# -- the sampler's policy --------------------------------------------------------------

BATCHES = {
    # temperatures, top-k per row
    "greedy": ([0.0] * 8, [0] * 8),
    "temperature": ([0.0, 0.8, 1.0, 0.5, 0.0, 1.3, 0.8, 2.0], [0, 0, 0, 0, 3, 0, 0, 0]),
    "top_k": ([0.0, 0.8, 1.0, 0.5, 0.0, 1.3, 0.8, 2.0], [0, 40, 0, 5, 3, 0, 1, 100]),
}


def test_policy_of_picks_the_narrowest_policy():
    for name, (temps, top_ks) in BATCHES.items():
        assert policy_of(np.float32(temps), np.int32(top_ks)) == name
    with pytest.raises(ValueError, match="unknown sampling policy"):
        sample_tokens(torch.zeros((1, 4)), *[torch.zeros(1)] * 4, policy="nucleus")


@pytest.mark.parametrize("vocab", [512, 128256])
def test_sampler_with_policy_identical_to_reference(vocab, rng):
    """Each batch under its own policy and every wider one: the tokens of
    ``repro.serve.sampler.sample_tokens`` on the same inputs."""
    b = 8
    for name, (temps, top_ks) in BATCHES.items():
        logits = (3.0 * rng.standard_normal((b, vocab))).astype(np.float32)
        seeds = rng.integers(0, 2**31 - 1, b).astype(np.int32)
        steps = rng.integers(0, 512, b).astype(np.int32)
        knobs = (logits, seeds, steps, np.float32(temps), np.int32(top_ks))
        want = np.asarray(jsample(*map(jnp.asarray, knobs)))
        for policy in POLICIES[POLICIES.index(name):]:
            got = sample_tokens(*map(torch.from_numpy, knobs), policy=policy)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{name} as {policy}")


# -- the cache index ---------------------------------------------------------------------


def test_forward_advances_the_index_in_place(rng):
    cfg = get_config("llama3.2-1b").reduced()
    params = lm.init_params(cfg, seed=0)
    cache = lm.init_cache(cfg, 2, 32)
    index = cache["index"]
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 5)).astype(np.int32))
    _, out = lm.prefill(params, {"tokens": tokens}, cfg, cache)
    assert out["index"] is index and index.tolist() == [5, 5]
    index[1] = 2
    _, out = lm.decode_step(params, tokens[:, :1], cfg, out)
    assert out["index"] is index and index.tolist() == [6, 3]


# -- repeated keys against the reference ------------------------------------------------------

REPEATS = {
    # name: (arch, prompt lengths, generation lengths, engine kwargs); the
    # llama prompts pad to 8, 8, 16, 8, 16, 16 (each key again and again),
    # the mamba2 ones are admitted back to back at one length
    "llama_bucket": ("llama3.2-1b", (5, 7, 12, 3, 14, 16), (4, 6, 3, 5, 2, 4),
                     dict(n_slots=2, prefill_bucket=8, page_size=4)),
    "mamba2_equal_lengths": ("mamba2-2.7b", (7, 7, 5, 7), (3, 5, 4, 2), dict(n_slots=2)),
}


@pytest.fixture(scope="module")
def weights():
    out = {}
    for arch in ("llama3.2-1b", "mamba2-2.7b"):
        jcfg, tcfg = _cfgs(arch)
        jparams = jlm.init_params(jcfg, seed=0)
        out[arch] = (jparams, bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg))
    return out


def _trace(engine, request_cls, prompts, gens):
    ids = [engine.submit(request_cls(p, max_new_tokens=g)) for p, g in zip(prompts, gens)]
    engine.run_until_idle(max_steps=2000)
    return [engine.completions[i].tokens for i in ids]


@pytest.mark.parametrize("graphs", [False, True], ids=["direct", "dry_graphs"])
@pytest.mark.parametrize("name", sorted(REPEATS))
def test_repeated_keys_token_identical_to_reference(name, graphs, weights, rng, monkeypatch):
    """Prefill keys that repeat share the batch-1 cache, zeroed inside the
    program each time: a stale state would change the next prompt's
    tokens."""
    arch, lens, gens, kw = REPEATS[name]
    jcfg, tcfg = _cfgs(arch)
    jparams, tparams = weights[arch]
    prompts = [rng.integers(0, tcfg.vocab_size, n).tolist() for n in lens]
    want = _trace(JServeEngine(jcfg, params=jparams, max_len=64, seed=0, **kw),
                  JRequest, prompts, gens)
    engine = ServeEngine(tcfg, params=tparams, max_len=64, seed=0, device="cpu", **kw)
    if graphs:
        _graphed(engine, monkeypatch)
    assert _trace(engine, Request, prompts, gens) == want
    stats = engine.graph_stats()
    assert stats["prefill"]["eager_calls"] + stats["prefill"]["replays"] == len(lens)
    if graphs:
        assert stats["prefill"]["replays"] >= 2
        decode = stats["decode"]
        assert decode["captures"] == 1 and decode["eager_calls"] == 1
        assert decode["replays"] == engine.stats.decode_steps - 1


@pytest.mark.parametrize("graphs", [False, True], ids=["direct", "dry_graphs"])
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b"])
def test_prefill_starts_from_a_zero_state(arch, graphs, rng, monkeypatch):
    """The batch-1 cache after prompt q is the same, bit for bit, whether
    or not prompt p of the same length was prefilled into it before (with
    random reduced weights a stale SSM state moves the tokens too little
    for a trace to show it)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), compute_dtype="float32")
    engine = ServeEngine(cfg, n_slots=2, max_len=32, seed=0, device="cpu")
    if graphs:
        _graphed(engine, monkeypatch)
    p, q = (rng.integers(0, cfg.vocab_size, (1, 7)).astype(np.int32) for _ in range(2))

    def prefill(tokens):
        i32 = lambda v: np.int32([v])  # noqa: E731
        _, logits = engine.programs["prefill"](
            [i32(6), i32(1), i32(0), np.float32([0.0]), i32(0), tokens], policy="greedy")
        return logits.clone(), _tree_map(torch.clone, engine._b1_cache)

    with torch.no_grad():
        fresh = prefill(q)
        prefill(p)
        again = prefill(q)
    torch.testing.assert_close(again[0], fresh[0], rtol=0, atol=0)
    for key, group in fresh[1].items():
        if key == "index":
            assert torch.equal(again[1][key], group)
            continue
        for leaf, value in group.items():
            assert torch.equal(again[1][key][leaf], value), (key, leaf)
    assert engine.graph_stats()["prefill"]["replays"] == (2 if graphs else 0)


def test_decode_captures_once_per_policy(weights, rng, monkeypatch):
    """Greedy, temperature and top-k requests in changing batches: at most
    one decode capture per policy, every later step a replay, the tokens
    those of the reference engine."""
    jcfg, tcfg = _cfgs("llama3.2-1b")
    jparams, tparams = weights["llama3.2-1b"]
    prompts = [rng.integers(0, tcfg.vocab_size, n).tolist() for n in (5, 9, 4, 7, 6)]
    gens = (6, 3, 8, 2, 5)
    samplers = [None, "temperature", None, "top_k", "temperature"]

    def run(engine, request_cls, sampler_cls):
        knobs = {None: None, "temperature": sampler_cls.with_temperature(0.8),
                 "top_k": sampler_cls.with_top_k(20, 1.1)}
        ids = [engine.submit(request_cls(p, max_new_tokens=g, sampling=knobs[s]))
               for p, g, s in zip(prompts, gens, samplers)]
        engine.run_until_idle(max_steps=500)
        return [engine.completions[i].tokens for i in ids]

    from repro.serve import Sampler as JSampler
    from repro_torch.serve import Sampler

    want = run(JServeEngine(jcfg, params=jparams, max_len=64, seed=0, n_slots=2),
               JRequest, JSampler)
    engine = _graphed(ServeEngine(tcfg, params=tparams, max_len=64, seed=0, device="cpu",
                                  n_slots=2), monkeypatch)
    assert run(engine, Request, Sampler) == want
    decode = engine.graph_stats()["decode"]
    policies = {key.split()[0] for key in decode["graphs"]}
    assert policies <= {f"policy={p}" for p in POLICIES} and len(policies) >= 2
    assert decode["captures"] == len(policies) <= decode["eager_calls"] <= 3
    assert decode["replays"] + decode["eager_calls"] == engine.stats.decode_steps


# -- launch bookkeeping --------------------------------------------------------------------


def _counting(fn, wrapper, form_of=None):
    """``fn`` counting its calls on ``wrapper`` as the CUDA wrapper counts
    its launches (and rmsnorm its forms)."""

    def call(*args, **kw):
        wrapper.launches += 1
        if form_of is not None:
            wrapper.forms[form_of(kw)] += 1
        return fn(*args, **kw)

    return call


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-7b"])
def test_graph_replays_count_like_eager_launches(arch, rng, monkeypatch):
    """A served trace with rmsnorm and paged attention counting as their
    CUDA wrappers do: graphed, the counts equal an eager run's."""
    impls = blocks.registry._impls
    form = lambda kw: "add" if "delta" in kw else "gated" if "gate" in kw else "plain"  # noqa: E731
    monkeypatch.setitem(impls["rmsnorm"], "torch", blocks.Impl(
        "rmsnorm", "torch", _counting(rn.rmsnorm_torch, rn.rmsnorm, form)))
    monkeypatch.setitem(impls["paged_attention"], "torch", blocks.Impl(
        "paged_attention", "torch", _counting(pa.paged_attention_torch, pa.paged_attention)))
    cfg = get_config(arch).reduced()
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (6, 6, 9, 6)]
    gens = (5, 3, 4, 6)
    runs = {}
    for graphs in (False, True):
        engine = ServeEngine(cfg, n_slots=2, max_len=32, page_size=4, seed=0, device="cpu")
        if graphs:
            _graphed(engine, monkeypatch)
        kernels.reset_launches()
        tokens = _trace(engine, Request, prompts, gens)
        runs[graphs] = (tokens, kernels.counters(), engine.graph_stats())
    (eager_tokens, eager_counts, _), (tokens, counts, stats) = runs[False], runs[True]
    assert tokens == eager_tokens
    assert stats["decode"]["replays"] > 0 and stats["prefill"]["replays"] > 0
    assert counts == eager_counts
    assert counts["rmsnorm"] > 0 and counts["paged_attention"] > 0


def test_step_program_keys_and_buffers(monkeypatch):
    """Keys by keyword, shape and binding; one static buffer; each key
    eager once, captured at its second call and replayed after; a program
    without graphs calls its function every time."""
    monkeypatch.setattr(runtime_programs, "Graph", DryGraph)
    seen = []

    def fn(x, scale, *, mode):
        seen.append(x.data_ptr())
        return (x * scale if mode == "mul" else x + scale,)

    program = programs.StepProgram("t", fn, 16, torch.device("cpu"))
    plain = programs.StepProgram("u", fn, 16, torch.device("cpu"), graphs=False)
    program.graphed = True
    calls = [("mul", 3), ("mul", 3), ("add", 3), ("add", 3), ("mul", 5), ("mul", 5),
             ("mul", 3), ("add", 3)]
    for mode, n in calls:
        x = np.arange(n, dtype=np.float32)
        for p in (program, plain):
            (out,) = p([x, np.float32([2.0])], mode=mode)
            np.testing.assert_array_equal(out.numpy(), x * 2 if mode == "mul" else x + 2)
    assert len(set(seen)) == 2  # each program reads its one static buffer
    with blocks.bind({"rmsnorm": "torch"}):
        program([np.zeros(3, np.float32), np.float32([1.0])], mode="mul")
    summary = program.summary()
    assert summary["graphs"] == ["mode=mul inputs 3,1", "mode=add inputs 3,1",
                                 "mode=mul inputs 5,1"]
    assert summary["calls"] == 9 and summary["captures"] == 3 and summary["replays"] == 5
    assert summary["eager_calls"] == 4
    assert plain.summary() == dict(calls=8, eager_calls=8, captures=0, replays=0,
                                   capture_seconds=0.0, graphs=[])
    with pytest.raises(TypeError, match="int32 or float32"):
        program([np.zeros(2, np.float64)], mode="mul")


def test_prefill_graphed_only_with_buckets(monkeypatch):
    """On the card an engine graphs decode always and prefill only with
    ``prefill_bucket``: exact prompt lengths are too many keys to pay for
    their captures."""
    made = {}

    class Recorder(programs.StepProgram):
        def __init__(self, name, *args, **kw):
            super().__init__(name, *args, **kw)
            made[name] = kw.get("graphs", True)

    monkeypatch.setattr(engine_mod, "StepProgram", Recorder)
    cfg = get_config("llama3.2-1b").reduced()
    for bucket in (None, 8):
        ServeEngine(cfg, n_slots=2, max_len=32, prefill_bucket=bucket, device="cpu")
        assert made == {"decode": True, "prefill": bucket is not None}
