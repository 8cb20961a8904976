"""The port's serving stack on the CPU: host-side page accounting, greedy
served traces token-identical to ``repro.serve.ServeEngine``, sampling
determinism, the CUDA-by-default rule and the serve CLI.

Parity traces run llama3.2-1b reduced in float32 on both sides with the
reference's weights carried across by ``repro_torch.bridge``: greedy argmax
over f32 logits that agree to ~1e-6 picks the same token.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import lm as jlm
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.metering import resolve_meter
from repro_torch.serve import (
    PagePool,
    PageTable,
    PoolExhausted,
    Request,
    Sampler,
    ServeEngine,
    Token,
)
from repro_torch.serve.kv import pages_for
from repro_torch.serve.sampler import gumbel_noise, sample_tokens

ROOT = Path(__file__).resolve().parents[1]
CFG = get_config("llama3.2-1b").reduced()
F32 = dataclasses.replace(CFG, compute_dtype="float32")
J32 = dataclasses.replace(jget("llama3.2-1b").reduced(), compute_dtype="float32", remat="none")


def _prompt(rng, n):
    return rng.integers(0, CFG.vocab_size, n).tolist()


def _engine(**kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("seed", 0)
    return ServeEngine(CFG, device="cpu", **kw)


# -- host-side page accounting (as tests/test_serve_kv.py for the reference) ----


def test_page_pool_alloc_free_roundtrip():
    pool = PagePool(n_pages=8, page_size=16)
    assert pool.free_pages == 8 and pool.used_pages == 0
    assert pool.null_page == 8
    a = pool.alloc(3)
    b = pool.alloc(2)
    assert sorted(a + b) == [0, 1, 2, 3, 4]
    pool.free(a)
    assert pool.alloc(3) == a[::-1]  # deterministic LIFO reuse
    pool.free(b + a)
    pool.check_leaks()
    assert pool.free_pages == 8 and pool.peak_used == 5


def test_page_pool_exhaustion_and_double_free():
    pool = PagePool(n_pages=4, page_size=8)
    held = pool.alloc(4)
    with pytest.raises(PoolExhausted):
        pool.alloc(1)
    assert pool.used_pages == 4  # failed alloc has no side effects
    pool.free(held[:1])
    with pytest.raises(ValueError, match="not held"):
        pool.free(held[:1])  # double free
    with pytest.raises(ValueError, match="not held"):
        pool.free([pool.null_page])  # the null page is never allocatable
    pool.free(held[1:])
    pool.check_leaks()


def test_page_table_slot_lifecycle_and_stats():
    table = PageTable(n_slots=3, max_pages=4, pool=PagePool(12, 8))
    assert pages_for(17, 8) == 3
    table.alloc_slot(0, 17)
    table.alloc_slot(2, 8)
    with pytest.raises(ValueError, match="already holds"):
        table.alloc_slot(0, 1)
    arr = table.array()
    assert arr.shape == (3, 4)
    assert list(arr[1]) == [table.pool.null_page] * 4
    assert arr[0, 3] == table.pool.null_page
    version = table.version
    assert table.ensure(0, 24) == [] and table.version == version  # no growth
    assert len(table.ensure(0, 25)) == 1 and table.capacity(0) == 32
    with pytest.raises(ValueError, match="max_pages"):
        table.ensure(0, 40)
    assert table.resident_tokens == 33 and table.partial_pages == 1
    assert table.stats()["used_pages"] == 5
    table.free_slot(0)
    table.free_slot(2)
    table.pool.check_leaks()
    assert (table.array() == table.pool.null_page).all()


# -- served traces against the reference -----------------------------------------------


@pytest.fixture(scope="module")
def shared_params():
    jparams = jlm.init_params(J32, seed=0)
    return jparams, bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), F32)


def _trace(engine, request_cls, prompts, gens):
    ids = [engine.submit(request_cls(p, max_new_tokens=g)) for p, g in zip(prompts, gens)]
    engine.run_until_idle(max_steps=2000)
    return [engine.completions[i].tokens for i in ids], engine


TRACES = {
    # name: (prompt lengths, generation lengths, engine kwargs)
    "contiguous": ((5, 9, 4), (6, 3, 8), dict(n_slots=4)),
    "paged": ((5, 9, 4, 7), (6, 3, 8, 2), dict(n_slots=4, page_size=4)),
    "slot_reuse": ((5, 9, 4, 7, 6), (6, 3, 8, 2, 5), dict(n_slots=2)),
    # 6 pages of 8 = 48 tokens for 3 requests needing 32 each at the end
    "preemption": ((20, 20, 20), (12, 12, 12), dict(n_slots=3, page_size=8, n_pages=6)),
}


@pytest.mark.parametrize("name", sorted(TRACES))
def test_greedy_trace_token_identical_to_reference(name, shared_params, rng):
    jparams, tparams = shared_params
    lens, gens, kw = TRACES[name]
    prompts = [_prompt(rng, n) for n in lens]
    want, jeng = _trace(
        JServeEngine(J32, params=jparams, max_len=64, seed=0, **kw), JRequest, prompts, gens
    )
    got, teng = _trace(
        ServeEngine(F32, params=tparams, max_len=64, seed=0, device="cpu", **kw),
        Request, prompts, gens,
    )
    assert got == want
    assert teng.stats.slot_reuses == jeng.stats.slot_reuses
    assert teng.stats.preemptions == jeng.stats.preemptions
    if name == "slot_reuse":
        assert teng.stats.slot_reuses >= 3
    if name == "preemption":
        assert teng.stats.preemptions > 0
    if teng.kv is not None:
        teng.kv.pool.check_leaks()
        assert teng.kv.pool.used_pages == 0


# -- sampling -------------------------------------------------------------------------


def test_sampled_tokens_independent_of_batch_composition(rng):
    """A request's draws depend only on (seed, token index): replayed with
    other requests in other slots, it samples the identical tokens."""
    prompt = _prompt(rng, 6)
    for sampler in (Sampler.with_temperature(0.8), Sampler.with_top_k(20, 1.1)):
        solo = _engine(n_slots=1)
        solo.submit(Request(prompt, max_new_tokens=8, sampling=sampler, seed=1234))
        alone = solo.run_until_idle(max_steps=100)[0].tokens

        crowded = _engine(n_slots=3)
        crowded.submit(Request(_prompt(rng, 9), max_new_tokens=4))
        crowded.submit(Request(_prompt(rng, 5), max_new_tokens=6,
                               sampling=Sampler.with_temperature(1.5)))
        rid = crowded.submit(Request(prompt, max_new_tokens=8, sampling=sampler, seed=1234))
        crowded.run_until_idle(max_steps=200)
        assert crowded.completions[rid].tokens == alone


def test_sample_tokens_greedy_ties_topk_and_noise():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0], [0.0, 0.0, 0.0, 0.0]])
    zeros = torch.zeros(2, dtype=torch.int32)
    greedy = sample_tokens(logits, zeros, zeros, torch.zeros(2), zeros)
    assert greedy.tolist() == [1, 0]  # argmax takes the first index on ties
    # top-1 at any temperature is greedy
    top1 = sample_tokens(logits, zeros, zeros, torch.full((2,), 5.0), torch.ones(2, dtype=torch.int32))
    assert top1.tolist()[0] in (1, 2)
    g = gumbel_noise(torch.tensor([7, 7, 8]), torch.tensor([0, 1, 0]), 4096)
    assert torch.isfinite(g).all()
    assert torch.equal(g[0], gumbel_noise(torch.tensor([7]), torch.tensor([0]), 4096)[0])
    assert not torch.equal(g[0], g[1]) and not torch.equal(g[0], g[2])
    assert abs(float(g.mean()) - 0.5772) < 0.05  # the Gumbel mean


# -- device rule, unported options, the CLI -------------------------------------------------


def test_engine_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(CFG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_cli.main(["--reduced", "--requests", "1"])


@pytest.mark.parametrize("kw", [
    dict(meter="auto"), dict(meter="psutil"), dict(meter="time"),
])
def test_unported_engine_options_raise(kw):
    """The engine's ``meter=`` (once a stub that raised) fills each phase's
    joules, stamped with the resolved meter's provenance."""
    engine = _engine(**kw)
    want = type(resolve_meter(kw["meter"])).provenance
    engine.submit(Request(list(range(1, 9)), max_new_tokens=3))
    engine.run_until_idle(max_steps=50)
    for phase in ("prefill", "decode"):
        tele = engine.telemetry[phase]
        assert tele.calls > 0 and tele.joules > 0 and tele.provenance == want
        assert tele.joules_per_token == pytest.approx(tele.joules / tele.tokens)
        assert "J/tok" in tele.summary()


@pytest.mark.parametrize("arch, chunk, match", [
    ("mamba2-2.7b", 8, "SSM scan cannot do"),
    ("zamba2-7b", 8, "SSM scan cannot do"),
    ("llama3.2-1b", 0, "prefill_chunk must be >= 1"),
])
def test_prefill_chunk_refusals(arch, chunk, match):
    """A recurrent scan cannot resume mid-prompt: SSM patterns refuse
    chunked prefill with the reference's message, as does a chunk < 1."""
    with pytest.raises(ValueError, match=match):
        ServeEngine(get_config(arch).reduced(), device="cpu", prefill_chunk=chunk)
    with pytest.raises(ValueError, match=match):
        JServeEngine(jget(arch).reduced(), prefill_chunk=chunk)


def test_submit_validation_and_streaming_order(rng):
    engine = _engine(page_size=8, n_pages=4)
    with pytest.raises(ValueError, match="never be resident"):
        engine.submit(Request(_prompt(rng, 30), max_new_tokens=10))
    with pytest.raises(ValueError, match="max_len"):
        engine.submit(Request(_prompt(rng, 60), max_new_tokens=10))
    events = list(engine.stream([Request(_prompt(rng, 5), max_new_tokens=4)]))
    tokens = [e for e in events if isinstance(e, Token)]
    assert [t.index for t in tokens] == [0, 1, 2, 3]
    assert tokens[0].phase == "prefill" and events[-1].tokens == tuple(t.token_id for t in tokens)


def test_serve_cli_runs_on_cpu_and_reports_slot_reuse():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced", "--device", "cpu",
         "--requests", "4", "--prompt-len", "10", "--len-jitter", "3", "--gen", "4",
         "--slots", "2", "--max-len", "32", "--page-size", "8"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    line = next(ln for ln in out.stdout.splitlines() if ln.startswith("continuous batching:"))
    assert int(line.split()[2]) >= 1
    assert "tok/s" in out.stdout and "ttft: p50" in out.stdout
