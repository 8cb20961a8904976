"""Binding mode in the port on the CPU: ``BindingSpace``, ``declared_pattern``,
``select_block_pattern`` / ``measure_block_pattern``, the session's binding
mode with ``stored_binding`` / ``attach``, the zoo planner
(``repro_torch.offload.zoo``) and plan binding in the serve engine and CLI.

The reference's tests of the same surfaces (``test_planner.py``,
``test_blocks.py``, ``test_offload_session.py``, ``test_metering.py``,
``test_kernels_paged_attention.py``, ``test_serve.py``) are mirrored with
the targets mapped one to one: ``ref`` -> ``ref``, ``xla`` -> ``torch``,
``pallas`` -> ``cuda``.  On the CPU a ``cuda`` target's wrapper runs its
plain version.  The zoo's keys and axes and the served traces under a bound
plan are held against the reference itself: greedy f32 traces of llama3.2-1b
reduced, the reference's weights carried across by ``repro_torch.bridge``,
must be token-identical to ``repro.serve.ServeEngine`` under the mapped
plan (greedy argmax over f32 logits that agree to ~1e-6).

Timing-sensitive tests drive sleep-based targets with >= 5 ms gaps so
median-of-1 measurements rank them deterministically.
"""

import dataclasses
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import jax

import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401 — registers the reference's shelf
import repro_torch.kernels  # noqa: F401 — registers the port's shelf
from repro.configs import get_config as jget
from repro.core import blocks as jblocks
from repro.core import planner as jplanner
from repro.core.planner import PlanStore as JPlanStore
from repro.models import lm as jlm
from repro.offload import zoo as jzoo
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import blocks, planner
from repro_torch.core.blocks import FunctionBlockRegistry
from repro_torch.core.engine import OffloadEngine
from repro_torch.core.planner import (
    BindingSpace,
    MeasurementCache,
    Plan,
    PlanStore,
    environment_fingerprint,
)
from repro_torch.offload import OffloadSession, stored_binding, zoo
from repro_torch.serve import Request, ServeEngine

ROOT = Path(__file__).resolve().parents[1]
CFG = get_config("llama3.2-1b").reduced()
F32 = dataclasses.replace(CFG, compute_dtype="float32")
J32 = dataclasses.replace(jget("llama3.2-1b").reduced(), compute_dtype="float32", remat="none")
#: the reference's targets -> the port's
TO_PORT = {"ref": "ref", "xla": "torch", "pallas": "cuda"}
TO_REF = {v: k for k, v in TO_PORT.items()}
ARCHS = ("llama3.2-1b", "mamba2-2.7b", "zamba2-7b")


def _prompt(rng, n):
    return rng.integers(0, CFG.vocab_size, n).tolist()


def _toy_registry(delays=(("ref", 0.015), ("torch", 0.003))):
    reg = FunctionBlockRegistry()
    for target, delay in delays:
        reg.register("norm", target, (lambda d: lambda x: (time.sleep(d), x)[1])(delay))
    return reg


def _toy_binding_space(reg):
    return BindingSpace(lambda: (lambda x: reg.call("norm", x)), registry=reg)


def _plan(key, mapping, fingerprint):
    return Plan(
        key=key, space="sig", mapping=dict(mapping), pattern=tuple(sorted(mapping)),
        baseline_seconds=1.0, best_seconds=0.5, speedup=2.0, strategy="exhaustive",
        evaluations=2, search_seconds=0.1, fingerprint=fingerprint, created_unix=0.0,
    )


# -- BindingSpace (test_planner.py) -------------------------------------------------------


def test_binding_space_nary_axes_and_bind():
    reg = FunctionBlockRegistry()
    calls = []
    for target, delay in [("ref", 0.02), ("torch", 0.004), ("cuda", 0.012)]:
        def mk(t=target, d=delay):
            def impl(x):
                calls.append(t)
                time.sleep(d)
                return x

            return impl

        reg.register("norm", target, mk())

    space = BindingSpace(lambda: (lambda x: reg.call("norm", x)), registry=reg)
    assert [a.name for a in space.axes] == ["norm"]
    # ref is the baseline (choice 0), generalising "not offloaded"
    assert space.axes[0].choices[0] == "ref"
    assert space.size() == 3

    cand = space.candidate_from_mapping({"norm": "cuda"})
    fn = space.build(cand)
    fn(1)
    assert calls[-1] == "cuda"
    assert space.binding_of(cand) == {"norm": "cuda"}
    # a deployable plan pins every axis, the baseline's choice included
    assert space.deploy_mapping(space.baseline()) == {"norm": "ref"}


def test_binding_space_from_patterns_default_sentinel():
    reg = FunctionBlockRegistry()
    reg.register("m", "ref", lambda x: x)
    reg.register("m", "torch", lambda x: x)
    reg.register("n", "ref", lambda x: x)
    patterns = [{"m": "ref"}, {"m": "torch", "n": "ref"}]
    space = BindingSpace.from_patterns(lambda: (lambda x: x), patterns, registry=reg)
    # "n" is absent from the first pattern -> gets the default sentinel
    ax = {a.name: a for a in space.axes}
    assert ax["n"].choices[0] == planner.DEFAULT_TARGET
    cand = space.candidate_from_mapping(patterns[0])
    assert space.binding_of(cand) == {"m": "ref"}  # no binding for "n"


def test_binding_space_prunes_marked_targets():
    reg = _toy_registry()
    space = _toy_binding_space(reg)
    space.mark_illegal({("norm", "torch"): "not on this host"})
    assert space.pruned(space.candidate_from_mapping({"norm": "torch"})) == (
        "norm->torch: not on this host")
    assert space.pruned(space.baseline()) is None
    sentinel = BindingSpace.from_patterns(lambda: None, [{"norm": "ref"}, {}], registry=reg)
    with pytest.raises(ValueError, match="default"):
        sentinel.mark_illegal({("norm", planner.DEFAULT_TARGET): "no"})


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_zoo_axes_and_order_match_reference(arch, kind):
    """The zoo cell's axes: the same blocks in the same order, each with
    the reference's targets mapped, in the same order (baseline first)."""
    targets = ("ref", "torch", "cuda")
    axes = zoo._cell_blocks(get_config(arch), blocks.registry, targets, kind)
    jaxes = jzoo._cell_blocks(jget(arch), jblocks.registry,
                              tuple(TO_REF[t] for t in targets), kind)
    assert list(axes) == list(jaxes)
    for name in axes:
        assert axes[name] == [TO_PORT[t] for t in jaxes[name]]
    space = BindingSpace(lambda: None, blocks=axes)
    jspace = jplanner.BindingSpace(lambda: None, blocks=jaxes)
    assert [a.name for a in space.axes] == [a.name for a in jspace.axes]
    assert [[TO_REF[c] for c in a.choices] for a in space.axes] == [
        list(a.choices) for a in jspace.axes]


def test_stored_binding_rejects_stale_registry_mapping(tmp_path):
    """A plan naming a block/target that no longer exists must not bind."""
    PlanStore(tmp_path).save(_plan("stale", {"ghost_block": "cuda"},
                                   environment_fingerprint()))
    assert stored_binding(str(tmp_path), "stale") is None


def test_measure_block_pattern_routes_through_cache(monkeypatch):
    reg_calls = {"calls": 0}
    monkeypatch.setitem(blocks.registry._impls, "planner_probe", {})
    blocks.registry.register(
        "planner_probe", "ref",
        lambda x: (reg_calls.__setitem__("calls", reg_calls["calls"] + 1),
                   time.sleep(0.01), x)[-1],
    )
    blocks.registry.register(
        "planner_probe", "torch",
        lambda x: (reg_calls.__setitem__("calls", reg_calls["calls"] + 1), x)[-1],
    )

    def builder():
        return lambda x: blocks.call("planner_probe", x)

    eng = OffloadEngine(device="cpu")
    cache = MeasurementCache()
    patterns = [{"planner_probe": "ref"}, {"planner_probe": "torch"}]
    best, results = eng.measure_block_pattern(builder, patterns, (1,), repeats=1, cache=cache)
    assert best == {"planner_probe": "torch"}
    assert [p for p, _ in results] == patterns
    assert cache.misses == 2

    # same cache, second sweep: everything replays, nothing is re-measured
    calls_before = reg_calls["calls"]
    best2, _ = eng.measure_block_pattern(builder, patterns, (1,), repeats=1, cache=cache)
    assert best2 == best
    assert cache.misses == 2
    assert reg_calls["calls"] == calls_before


# -- the registry (test_blocks.py) --------------------------------------------------------


def test_registry_has_shelf_blocks():
    names = blocks.registry.blocks()
    for expected in ("matmul", "attention", "rmsnorm", "ssd_scan", "fft2d", "lu",
                     "paged_attention"):
        assert expected in names
    assert set(repro_torch.kernels.SHELF_BLOCKS) <= set(names)


def test_default_binding_follows_the_device():
    """Unbound, a block resolves to the target of its tensors' device (the
    reference prefers xla; the port prefers the kernel on the card and its
    plain version on the CPU)."""
    x, w = torch.ones((2, 8)), torch.ones(8)
    fn = blocks.registry.resolve("rmsnorm", x, w)
    assert fn is blocks.registry.implementation("rmsnorm", "torch").fn
    assert fn(x, w).shape == (2, 8)
    with blocks.bind({"rmsnorm": "cuda"}):
        assert blocks.registry.resolve("rmsnorm", x, w) is (
            blocks.registry.implementation("rmsnorm", "cuda").fn)
        assert blocks.registry.current_pattern() == {"rmsnorm": "cuda"}
    assert blocks.registry.current_pattern() == {}


def test_bind_scopes_pattern(monkeypatch):
    calls = []

    def probe(*a, **k):
        calls.append("probe")
        return a[0]

    monkeypatch.setitem(blocks.registry._impls, "probe_block", {})
    blocks.registry.register("probe_block", "ref", probe)
    blocks.registry.register("probe_block", "torch", lambda x: x + 1)
    with blocks.bind({"probe_block": "ref"}):
        blocks.call("probe_block", torch.ones(4))
    assert calls == ["probe"]
    # binding is restored outside the context
    assert float(blocks.call("probe_block", torch.ones(1))) == 2.0
    with pytest.raises(KeyError, match="no target"):
        with blocks.bind({"probe_block": "pallas"}):
            pass


def test_engine_environment_pattern_selection():
    eng = OffloadEngine(device="cpu")
    pat_cpu = eng.select_block_pattern("cpu")
    assert pat_cpu["attention"] == "torch"
    pat_cuda = eng.select_block_pattern("cuda")
    assert pat_cuda["attention"] == "cuda"
    assert pat_cuda["fft2d"] == "cuda"


def test_declared_pattern_matches_reference_mapped():
    names = ("rmsnorm", "attention", "paged_attention", "ssd_scan", "matmul", "fft2d", "lu")
    for env, jenv in (("cpu", "cpu"), ("cuda", "tpu")):
        got = planner.declared_pattern(env, blocks=names)
        want = jplanner.declared_pattern(jenv, blocks=names)
        assert got == {b: TO_PORT[t] for b, t in want.items()}, env


def test_measured_binding_selection():
    eng = OffloadEngine(device="cpu")
    x = torch.ones((4, 64))
    w = torch.ones(64)

    def builder():
        def step(x, w):
            return blocks.call("rmsnorm", x, w)

        return step

    best, results = eng.measure_block_pattern(
        builder, [{"rmsnorm": "ref"}, {"rmsnorm": "torch"}], (x, w), repeats=1)
    assert best["rmsnorm"] in ("ref", "torch")
    assert len(results) == 2


def test_shelf_fingerprint_changes_with_source():
    reg1 = FunctionBlockRegistry()
    reg1.register("b", "torch", _toy_registry)  # any fn with source
    reg2 = FunctionBlockRegistry()
    reg2.register("b", "torch", _toy_binding_space)  # different source
    assert reg1.shelf_fingerprint() != reg2.shelf_fingerprint()
    # restricting to an unrelated block set ignores the difference
    assert reg1.shelf_fingerprint(blocks=[]) == reg2.shelf_fingerprint(blocks=[])


def test_kernel_rewrite_invalidates_stored_plan(tmp_path):
    """A plan whose fingerprint carries a different kernel-shelf hash (the
    CUDA sources' and the wrappers') must not load."""
    fp = environment_fingerprint()
    assert repro_torch.kernels.SHELF_FINGERPRINT in fp["kernel_shelf"]
    store = PlanStore(tmp_path)
    plan = _plan("shelf", {}, fp)
    store.save(plan)
    assert store.load("shelf") is not None
    for stale in ("0" * 16, fp["kernel_shelf"].split(":")[0] + ":" + "0" * 16):
        bad = Plan.from_json(plan.to_json())
        bad.fingerprint = dict(fp, kernel_shelf=stale)
        store.save(bad)
        assert store.load("shelf") is None


# -- the session's binding mode (test_offload_session.py) ---------------------------------


def test_session_binding_mode_from_blocks():
    """Binding mode: a step builder plus a block->targets map builds the
    BindingSpace inside the session."""
    reg = _toy_registry()
    s = OffloadSession(
        lambda: (lambda x: reg.call("norm", x)),
        args=(2,), blocks={"norm": ("ref", "torch")}, registry=reg, repeats=1,
    )
    assert s.analyze() == {"norm": ("ref", "torch")}
    assert s.discover() == ["norm"]
    plan = s.plan()
    assert plan.mapping == {"norm": "torch"}
    res = s.commit()  # verify stage is optional
    assert res.numerics_ok is None
    assert res.fn(7) == 7
    with res.binding_context(reg):
        assert reg.current_pattern() == {"norm": "torch"}


def test_session_binding_mode_from_patterns():
    reg = _toy_registry()
    s = OffloadSession(lambda: (lambda x: reg.call("norm", x)), args=(2,),
                       patterns=[{"norm": "ref"}, {"norm": "torch"}], registry=reg, repeats=1)
    assert s.run(verify=True).mapping == {"norm": "torch"}
    with pytest.raises(TypeError, match="step builder"):
        OffloadSession(object(), blocks={"norm": ("ref",)})


def test_session_store_roundtrip_zero_measurement(tmp_path, monkeypatch):
    reg = _toy_registry()
    s1 = OffloadSession(_toy_binding_space(reg), args=(1,), repeats=1,
                        store=str(tmp_path), key="sess:roundtrip")
    r1 = s1.run(verify=False)
    assert not r1.from_store and r1.report is not None

    s2 = OffloadSession(_toy_binding_space(_toy_registry()), args=(1,), repeats=1,
                        store=str(tmp_path), key="sess:roundtrip")
    r2 = s2.run(verify=False)
    assert r2.from_store and r2.report is None
    assert s2.cache.misses == 0  # nothing measured
    assert r2.mapping == r1.mapping
    # attach: the production zero-search path binds the stored mapping
    monkeypatch.setitem(blocks.registry._impls, "norm", {})
    blocks.registry.register("norm", "torch", lambda x: x)
    with OffloadSession.attach(str(tmp_path), "sess:roundtrip", quiet=True):
        assert blocks.registry.current_pattern()["norm"] == "torch"


def test_measure_block_pattern_shim_matches_session(monkeypatch):
    reg_calls = {"n": 0}
    monkeypatch.setitem(blocks.registry._impls, "shim_probe", {})
    blocks.registry.register(
        "shim_probe", "ref",
        lambda x: (reg_calls.__setitem__("n", reg_calls["n"] + 1), time.sleep(0.012), x)[-1],
    )
    blocks.registry.register(
        "shim_probe", "torch", lambda x: (reg_calls.__setitem__("n", reg_calls["n"] + 1), x)[-1],
    )

    def builder():
        return lambda x: blocks.call("shim_probe", x)

    patterns = [{"shim_probe": "ref"}, {"shim_probe": "torch"}]
    best, results = OffloadEngine(device="cpu").measure_block_pattern(
        builder, patterns, (1,), repeats=1)
    assert best == {"shim_probe": "torch"}
    assert [p for p, _ in results] == patterns


def test_attach_is_the_only_production_bind_path(tmp_path, monkeypatch, capsys):
    reg = _toy_registry()
    OffloadSession(_toy_binding_space(reg), args=(1,), repeats=1,
                   store=str(tmp_path), key="shim:plans").run(verify=False)
    monkeypatch.setitem(blocks.registry._impls, "norm", {})
    blocks.registry.register("norm", "torch", lambda x: x)
    assert stored_binding(str(tmp_path), "shim:plans") == {"norm": "torch"}
    with OffloadSession.attach(str(tmp_path), "shim:plans", quiet=True):
        assert blocks.registry.current_pattern()["norm"] == "torch"
    # unset, missing or half-given plans bind nothing, and say why
    with OffloadSession.attach(str(tmp_path), "absent"):
        assert blocks.registry.current_pattern() == {}
    with OffloadSession.attach(str(tmp_path), None):
        assert blocks.registry.current_pattern() == {}
    out = capsys.readouterr().out
    assert "not found/compatible" in out and "both a plan dir and a plan key" in out


# -- the zoo planner (test_metering.py, test_offload_session.py) ---------------------------


def test_zoo_key_canonicalises_arch_spelling():
    assert zoo.zoo_key("llama3.2_1b", "decode") == "zoo:llama3.2-1b:decode"
    assert zoo.zoo_key("llama3.2-1b", "decode") == "zoo:llama3.2-1b:decode"
    # unknown labels pass through
    assert zoo.zoo_key("selftest", "app") == "zoo:selftest:app"


@pytest.mark.parametrize("arch", ARCHS + ("llama3.2_1b", "selftest"))
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_zoo_keys_match_reference(arch, kind, tmp_path):
    assert zoo.zoo_key(arch, kind) == jzoo.zoo_key(arch, kind)
    assert zoo.default_plan_key(str(tmp_path), arch, kind) is None
    assert jzoo.default_plan_key(str(tmp_path), arch, kind) is None
    key = zoo.zoo_key(arch, kind)
    PlanStore(tmp_path).save(_plan(key, {}, environment_fingerprint()))
    assert zoo.default_plan_key(str(tmp_path), arch, kind) == key
    assert jzoo.default_plan_key(str(tmp_path), arch, kind) == key  # presence only


def test_default_plan_key_requires_stored_plan(tmp_path):
    assert zoo.default_plan_key(str(tmp_path), "llama", "train") is None
    assert zoo.default_plan_key(None, "llama", "train") is None
    PlanStore(tmp_path).save(_plan("zoo:llama:train", {}, environment_fingerprint()))
    assert zoo.default_plan_key(str(tmp_path), "llama", "train") == "zoo:llama:train"
    assert zoo.default_plan_key(str(tmp_path), "llama", "decode") is None
    # a plan verified elsewhere counts as missing when deciding to search
    PlanStore(tmp_path).save(_plan("zoo:llama:decode", {}, {"device": "elsewhere"}))
    assert zoo.default_plan_key(str(tmp_path), "llama", "decode") == "zoo:llama:decode"
    assert zoo.default_plan_key(str(tmp_path), "llama", "decode",
                                match_fingerprint=True) is None


def test_zoo_train_kind_and_unported_options_raise(tmp_path):
    """The train cell is ported: it searches and commits a plan (an eager
    step a trial, one warm-up call).  ``legality`` and ``resources`` (once
    stubs that raised) run the analysis pre-filters: on the CPU every
    ``cuda`` binding is pruned as illegal for the platform, and the reduced
    cell's step fits even ``tiny-32m``, so memory prunes nothing more."""
    builder, args, _ = zoo._cell_target("llama3.2-1b", "train", reduced=True, layers=1,
                                        batch=1, seq=8, seed=0, device="cpu")
    assert builder().warmup_calls == 1
    store = str(tmp_path / "train")
    results = zoo.plan_zoo(store, [("llama3.2-1b", "train")], layers=1, batch=1, seq=8,
                           targets=("ref", "torch"), device="cpu")
    assert results[("llama3.2-1b", "train")].plan is not None
    assert zoo.default_plan_key(store, "llama3.2-1b", "train") == "zoo:llama3.2-1b:train"
    (tmp_path / "train" / "zoo_llama3.2-1b_train.json").unlink()
    (tmp_path / "train").rmdir()
    cell = [("llama3.2-1b", "decode")]
    pruned = zoo.plan_zoo(str(tmp_path / "legal"), cell, layers=1, batch=1, seq=8,
                          targets=("torch", "cuda"), device="cpu", legality=True,
                          resources="tiny-32m")[cell[0]]
    assert pruned.mapping == {"rmsnorm": "torch", "attention": "torch",
                              "paged_attention": "torch"}
    assert pruned.report.pruned > 0
    assert all("requires platform gpu" in r for r in pruned.report.pruned_reasons.values())
    shutil.rmtree(tmp_path / "legal")
    # meter= and the executors are ported: an explicit meter the host lacks
    # fails loudly, an unknown executor is refused, both before any search
    with pytest.raises(RuntimeError, match="not available on this host"):
        zoo.plan_zoo(str(tmp_path), [("llama3.2-1b", "decode")], device="cpu", meter="nvml")
    with pytest.raises(KeyError, match="unknown executor"):
        zoo.plan_zoo(str(tmp_path), [("llama3.2-1b", "decode")], device="cpu",
                     executor="warp-drive")
    with pytest.raises(ValueError, match="unknown cell kind"):
        zoo.plan_zoo(str(tmp_path), [("llama3.2-1b", "serve")], device="cpu")
    assert not list(tmp_path.iterdir())  # nothing searched, nothing stored


def test_plan_zoo_roundtrip_through_store(tmp_path):
    """plan_zoo searches a real decode step per cell, persists a plan, and a
    second sweep resolves every cell from the store with zero search."""
    cells = [("llama3.2-1b", "decode"), ("llama3.2-1b", "prefill")]
    res = OffloadSession.plan_zoo(str(tmp_path), cells, targets=("ref", "torch"),
                                  batch=1, seq=8, layers=1, repeats=1, device="cpu")
    assert set(res) == set(cells)
    first = res[("llama3.2-1b", "decode")]
    assert not first.from_store
    assert first.plan.key == "zoo:llama3.2-1b:decode"
    # every measured axis is pinned, the baseline's choices included
    assert set(first.mapping) == {"rmsnorm", "attention"}

    store = PlanStore(tmp_path)
    assert store.keys() == ["zoo:llama3.2-1b:decode", "zoo:llama3.2-1b:prefill"]
    loaded = store.load("zoo:llama3.2-1b:decode")
    assert loaded is not None and loaded.mapping == first.mapping
    assert "kernel_shelf" in loaded.fingerprint

    res2 = OffloadSession.plan_zoo(str(tmp_path), cells[:1], targets=("ref", "torch"),
                                   batch=1, seq=8, layers=1, repeats=1, device="cpu")
    second = res2[("llama3.2-1b", "decode")]
    assert second.from_store and second.report is None
    assert second.mapping == first.mapping


def test_zoo_cell_is_a_captured_program_timing_replays():
    """A cell's builder returns the step as a captured program (on the
    card: its first call eager, its second captured, every later call one
    replay; a trial's warm-up takes the first two); the decode step starts
    from the cell's positions every call."""
    builder, args, cfg = zoo._cell_target("llama3.2-1b", "decode", reduced=True, layers=1,
                                          batch=3, seq=8, seed=0, device="cpu")
    params, tokens, cache = args
    assert cache["pages"].tolist() == [[0], [1], [2]] and cache["index"].tolist() == [0, 1, 2]
    fn = builder()
    first = fn(*args)[0].clone()
    again = fn(*args)[0]
    assert torch.equal(first, again)
    assert cache["index"].tolist() == [1, 2, 3]
    assert fn.calls == 2  # one program call a call
    prefill, pargs, _ = zoo._cell_target("llama3.2-1b", "prefill", reduced=True, layers=1,
                                         batch=2, seq=8, seed=0, device="cpu")
    logits, _ = prefill()(*pargs)
    assert logits.shape[:2] == (2, 8) and pargs[1]["tokens"].shape == (2, 8)


def test_zoo_decode_plan_searches_paged_block(tmp_path):
    """The zoo decode cell exposes ``paged_attention`` as a search axis; the
    committed plan records the block (on the CPU the cuda target's wrapper
    runs its plain version, so either may win)."""
    results = zoo.plan_zoo(str(tmp_path), [("llama3.2-1b", "decode")],
                           targets=("torch", "cuda"), reduced=True, layers=1, batch=2,
                           seq=8, device="cpu")
    r = results[("llama3.2-1b", "decode")]
    assert r.mapping["paged_attention"] in ("torch", "cuda")
    assert r.report is not None and len(r.report.trials) >= 2


def test_zoo_cli_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.offload.zoo", "--plan-dir", str(tmp_path),
         "--arch", "llama3.2-1b", "--kind", "decode", "--reduced", "--device", "cpu",
         "--layers", "1", "--batch", "1", "--seq", "8"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    assert "zoo cell llama3.2-1b:decode:" in out.stdout
    assert "planned 1/1 cells" in out.stdout
    plan = PlanStore(tmp_path).load("zoo:llama3.2-1b:decode")
    assert set(plan.mapping.values()) <= {"ref", "torch"}  # the CPU's default targets


# -- plan binding in the serve engine (test_serve.py, test_kernels_paged_attention.py) ----


@pytest.fixture(scope="module")
def shared_params():
    jparams = jlm.init_params(J32, seed=0)
    return jparams, bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), F32)


def _trace(engine, request_cls, prompts, gens):
    ids = [engine.submit(request_cls(p, max_new_tokens=g)) for p, g in zip(prompts, gens)]
    engine.run_until_idle(max_steps=800)
    return [engine.completions[i].tokens for i in ids]


def _engine(**kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("seed", 0)
    return ServeEngine(CFG, device="cpu", **kw)


def _store_with_zoo_plans(path, mapping, fingerprint):
    store = PlanStore(path) if fingerprint is environment_fingerprint else JPlanStore(path)
    for kind in ("prefill", "decode"):
        store.save(_plan(f"zoo:llama3.2-1b:{kind}", mapping, fingerprint()))


#: port plans and the reference's, the same blocks on mapped targets (the
#: reference's Pallas targets run on the CPU only in interpret mode, which
#: its registrations do not ask for, so no plan here binds cuda <-> pallas)
PLAN_CASES = {
    "ref": {"rmsnorm": "ref", "attention": "ref"},
    "torch": {"rmsnorm": "torch", "attention": "torch", "paged_attention": "torch"},
    "mixed": {"rmsnorm": "torch", "attention": "ref", "paged_attention": "torch"},
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_bound_trace_token_identical_to_reference(case, shared_params, rng, tmp_path):
    """With a zoo store present the engine binds each phase to its committed
    plan, and its greedy f32 trace equals the reference engine's under the
    mapped plan, and the port's own trace under the default bindings."""
    jparams, tparams = shared_params
    mapping = PLAN_CASES[case]
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    _store_with_zoo_plans(port_dir, mapping, environment_fingerprint)
    _store_with_zoo_plans(ref_dir, {b: TO_REF[t] for b, t in mapping.items()},
                          jplanner.environment_fingerprint)
    prompts = [_prompt(rng, n) for n in (5, 9, 4)]
    gens = (6, 4, 5)
    kw = dict(n_slots=2, max_len=64, seed=0, page_size=4)
    jeng = JServeEngine(J32, params=jparams, plan_dir=str(ref_dir), **kw)
    assert jeng._bindings["decode"] == {b: TO_REF[t] for b, t in mapping.items()}
    want = _trace(jeng, JRequest, prompts, gens)
    teng = ServeEngine(F32, params=tparams, plan_dir=str(port_dir), device="cpu", **kw)
    assert teng.plan_keys == {"prefill": "zoo:llama3.2-1b:prefill",
                              "decode": "zoo:llama3.2-1b:decode"}
    assert teng.bindings() == {"prefill": mapping, "decode": mapping}
    got = _trace(teng, Request, prompts, gens)
    default = _trace(ServeEngine(F32, params=tparams, device="cpu", **kw), Request, prompts, gens)
    assert got == want == default


def test_phases_run_under_their_bindings(tmp_path, rng, monkeypatch):
    """Every program call runs inside its phase's binding: prefill (and the
    chunk programs) under the prefill plan, the decode step under the
    decode plan."""
    store = PlanStore(tmp_path)
    store.save(_plan("p", {"rmsnorm": "ref"}, environment_fingerprint()))
    store.save(_plan("d", {"rmsnorm": "torch", "paged_attention": "cuda"},
                     environment_fingerprint()))
    engine = _engine(plan_dir=str(tmp_path), plan_keys={"prefill": "p", "decode": "d"},
                     page_size=4, prefill_chunk=8)
    seen = []
    for name in engine.graph_stats():  # the step programs
        program = engine.programs[name]
        fn = program.fn
        monkeypatch.setattr(program, "fn", lambda *a, _fn=fn, _n=name, **k: (
            seen.append((_n, blocks.registry.current_pattern())), _fn(*a, **k))[1])
    for n in (5, 20):
        engine.submit(Request(_prompt(rng, n), max_new_tokens=3))
    engine.run_until_idle(max_steps=100)
    phases = {"prefill": "p", "extend": "p", "extend_sample": "p", "decode": "d"}
    assert {name for name, _ in seen} == set(phases)
    for name, pattern in seen:
        assert pattern == engine.bindings()["decode" if phases[name] == "d" else "prefill"]
    assert blocks.registry.current_pattern() == {}


def test_explicit_plan_key_binds_both_phases(tmp_path, rng):
    PlanStore(tmp_path).save(_plan("custom:both", {"rmsnorm": "ref"}, environment_fingerprint()))
    engine = _engine(plan_dir=str(tmp_path), plan_keys="custom:both")
    assert engine.plan_keys == {"prefill": "custom:both", "decode": "custom:both"}
    assert engine._bindings["prefill"] == {"rmsnorm": "ref"}
    engine.submit(Request(_prompt(rng, 4), max_new_tokens=2))
    assert engine.run_until_idle(max_steps=50)[0].tokens


def test_explicit_plan_key_fails_loudly(tmp_path):
    """A key the caller *named* must bind or raise — never silently fall
    back to default bindings; store-derived defaults still degrade."""
    with pytest.raises(ValueError, match="not.*found/compatible"):
        _engine(plan_dir=str(tmp_path), plan_keys="zoo:llama3.2-1b:typo")
    with pytest.raises(ValueError, match="without plan_dir"):
        _engine(plan_keys="zoo:llama3.2-1b:prefill")
    with pytest.raises(KeyError, match="unknown serve phases"):
        _engine(plan_dir=str(tmp_path), plan_keys={"train": "k"})


def test_missing_plan_degrades_to_default_bindings(tmp_path, rng, capsys):
    """An empty store (or an incompatible plan) must serve, not crash."""
    engine = _engine(plan_dir=str(tmp_path))
    assert engine.plan_keys == {"prefill": None, "decode": None}
    engine.submit(Request(_prompt(rng, 4), max_new_tokens=2))
    assert len(engine.run_until_idle(max_steps=50)) == 1
    # a plan verified under another environment is found, then refused
    _store_with_zoo_plans(tmp_path, {"rmsnorm": "ref"}, lambda: {"device": "elsewhere"})
    engine = _engine(plan_dir=str(tmp_path), quiet=False)
    assert engine.bindings() == {"prefill": None, "decode": None}
    assert "decode runs on default bindings" in capsys.readouterr().out


def test_serve_decode_impl_token_identical(shared_params, rng):
    """Greedy paged traces under ``decode_impl`` torch and cuda (the kernel's
    wrapper runs its plain version on the CPU) equal the default binding's
    and the reference's ``decode_impl="xla"``."""
    jparams, tparams = shared_params
    prompts = [_prompt(rng, n) for n in (5, 9, 4)]
    gens = (6, 4, 5)
    kw = dict(n_slots=3, max_len=32, seed=0, page_size=4)
    want = _trace(JServeEngine(J32, params=jparams, decode_impl="xla", **kw),
                  JRequest, prompts, gens)
    for impl in ("auto", "torch", "cuda"):
        engine = ServeEngine(F32, params=tparams, decode_impl=impl, device="cpu", **kw)
        assert _trace(engine, Request, prompts, gens) == want, impl
        if impl != "auto":
            assert engine.bindings()["decode"] == {"paged_attention": impl}


def test_engine_decode_impl_validation():
    with pytest.raises(ValueError, match="decode_impl"):
        _engine(page_size=4, decode_impl="pallas")
    with pytest.raises(ValueError, match="page"):
        _engine(decode_impl="cuda")  # paged cache required
    with pytest.raises(ValueError, match="decode_impl"):
        JServeEngine(J32, n_slots=2, max_len=32, page_size=4, decode_impl="cuda")


def test_decode_impl_overrides_the_decode_plan(tmp_path):
    _store_with_zoo_plans(tmp_path, {"rmsnorm": "ref", "paged_attention": "cuda"},
                          environment_fingerprint)
    engine = _engine(plan_dir=str(tmp_path), page_size=4, decode_impl="torch")
    assert engine.bindings() == {
        "prefill": {"rmsnorm": "ref", "paged_attention": "cuda"},
        "decode": {"rmsnorm": "ref", "paged_attention": "torch"},
    }


def test_serve_cli_binds_plans_on_cpu(tmp_path):
    """``--plan-dir --plan-search`` searches and commits both phases' plans,
    binds them (``serve: <phase> bound to plan ...``), and a second run
    binds the stored plans without searching; ``--decode-impl`` pins decode's
    paged attention."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--reduced", "--device", "cpu",
            "--requests", "3", "--prompt-len", "8", "--len-jitter", "2", "--gen", "3",
            "--slots", "2", "--max-len", "32", "--page-size", "8",
            "--plan-dir", str(tmp_path)]
    runs = []
    for extra in (["--plan-search"], ["--decode-impl", "torch"]):
        out = subprocess.run(base + extra, capture_output=True, text=True, timeout=300,
                             env=env, cwd=ROOT)
        assert out.returncode == 0, out.stderr
        runs.append(out.stdout)
    assert "searching offload plans for llama3.2-1b: ['prefill', 'decode']" in runs[0]
    for phase in ("prefill", "decode"):
        assert f"serve: {phase} bound to plan 'zoo:llama3.2-1b:{phase}'" in runs[0]
        assert f"serve: {phase} bound to plan 'zoo:llama3.2-1b:{phase}'" in runs[1]
    assert "searching" not in runs[1]
    assert sorted(PlanStore(tmp_path).keys()) == ["zoo:llama3.2-1b:decode",
                                                  "zoo:llama3.2-1b:prefill"]
