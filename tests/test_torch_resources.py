"""``repro_torch.analysis.resources`` and ``devices`` against the
reference's: the capacity planner field by field for every arch, reduced
and full, paged and contiguous, on three envelopes; the estimator's
operands, constants, intermediates, in-place and view rules and the
frame a local lives in; envelopes; the OOM pre-filter through a real
search; the serve CLI's ``--preflight``; and the lint CLI against the
committed ``analysis_baseline_torch.json``.  CPU only.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import resources as jresources
from repro.configs import ARCH_NAMES
from repro.configs import get_config as jget
from repro.models import lm as jlm
from repro_torch.analysis import (
    STATIC_ENVELOPES,
    DeviceEnvelope,
    Diagnostic,
    ResourceHint,
    check_binding_space_resources,
    estimate_memory,
    lint_shelf_coverage,
    plan_serve_capacity,
    resolve_envelope,
)
from repro_torch.analysis.devices import KiB, MiB
from repro_torch.configs import get_config
from repro_torch.core.blocks import FunctionBlockRegistry
from repro_torch.core.planner import BindingSpace, SingleThenCombine
from repro_torch.models import lm
from repro_torch.offload import OffloadSession

ROOT = Path(__file__).resolve().parents[1]

# -- the capacity planner against the reference ----------------------------------------


def _compute_metas(jcfg):
    """The reference's meta tree with the port engine's dtypes: each
    matrix per layer in the compute dtype, as ``lm.cast_for_compute``
    leaves it (the reference's engine keeps its parameter dtype and casts
    inside its programs)."""
    def cast(tree, stacked):
        if dataclasses.is_dataclass(tree):
            if len(tree.shape) - stacked >= 2:
                return dataclasses.replace(tree, dtype=jcfg.compute_dtype)
            return tree
        return {k: cast(v, stacked or k == "blocks") for k, v in tree.items()}

    return cast(_JBUILD(jcfg), False)


#: the reference's own ``build_metas`` (the tests patch the module's name)
_JBUILD = jlm.build_metas


INT_FIELDS = ("params_bytes", "cache_bytes", "per_slot_bytes", "per_page_bytes", "total_bytes",
              "budget_bytes", "headroom_bytes", "fits", "max_slots", "max_pages", "pool_tokens",
              "n_pages")


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_capacity_plan_equals_the_references_field_by_field(arch, monkeypatch):
    """Every arch, reduced and full, paged and contiguous, against
    cpu-host-16g, h100-80g and tiny-32m, from metadata only: the integer
    fields equal the reference planner's given the same parameter bytes
    (its metas cast as the port's engine casts them)."""
    monkeypatch.setattr(jlm, "build_metas", _compute_metas)
    for reduced in (True, False):
        cfg, jcfg = get_config(arch), jget(arch)
        if reduced:
            cfg, jcfg = cfg.reduced(), jcfg.reduced()
        for page_size in (None, 16):
            for env in ("cpu-host-16g", "h100-80g", "tiny-32m"):
                kw = dict(n_slots=3, max_len=100, page_size=page_size, envelope=env,
                          prefill_bound=False)
                ours = plan_serve_capacity(cfg, **kw)
                theirs = jresources.plan_serve_capacity(jcfg, **kw)
                for field in INT_FIELDS:
                    assert getattr(ours, field) == getattr(theirs, field), (reduced, page_size,
                                                                             env, field)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-2.7b", "zamba2-7b", "deepseek-v2-236b"])
def test_plan_params_and_cache_are_the_engines_tensors(arch):
    """``params_bytes`` and ``cache_bytes`` are the bytes the engine's
    parameter and cache tensors hold (the card's check, phase 23, at full
    size)."""
    from repro_torch.models.params import count_params, param_bytes

    cfg = get_config(arch).reduced()
    page_size = None if "m" in cfg.pattern() and "s" not in cfg.pattern() else 16
    plan = plan_serve_capacity(cfg, n_slots=2, max_len=32, page_size=page_size,
                               envelope="cpu-host-16g", prefill_bound=False)
    params = lm.cast_for_compute(lm.init_params(cfg, seed=0), cfg)
    cache = lm.init_cache(cfg, 2, 32, page_size=page_size,
                          n_pages=plan.n_pages if page_size else None)
    nbytes = lambda tree: sum(t.numel() * t.element_size()  # noqa: E731
                              for t in jax.tree.leaves(tree))
    assert plan.params_bytes == nbytes(params) == param_bytes(lm.compute_metas(cfg))
    assert plan.cache_bytes == nbytes(cache)
    assert count_params(lm.compute_metas(cfg)) == count_params(lm.build_metas(cfg))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-2.7b"])
def test_prefill_bound_within_the_references(arch, monkeypatch):
    """``max_prefill_tokens`` comes from each package's own prefill trace
    (eager torch ops with frame-held locals against XLA's jaxpr): within a
    factor of 4 of the reference's either way."""
    monkeypatch.setattr(jlm, "build_metas", _compute_metas)
    kw = dict(n_slots=2, max_len=64, page_size=16, envelope="tiny-32m")
    ours = plan_serve_capacity(get_config(arch).reduced(), **kw).max_prefill_tokens
    theirs = jresources.plan_serve_capacity(jget(arch).reduced(), **kw).max_prefill_tokens
    assert ours and theirs and 0.25 <= ours / theirs <= 4.0, (ours, theirs)


def test_capacity_plan_matches_pagepool_math():
    from repro_torch.serve.kv.pool import PagePool, pages_for

    cfg = get_config("llama3.2-1b").reduced()
    plan = plan_serve_capacity(cfg, n_slots=3, max_len=64, page_size=16, envelope="cpu-host-16g")
    n_pages = 3 * pages_for(64, 16)
    assert plan.n_pages == n_pages
    assert plan.pool_tokens == PagePool(n_pages, 16).token_capacity
    assert plan.fits and plan.headroom_bytes > 0 and plan.per_page_bytes > 0
    assert plan.max_slots >= 3 and plan.max_pages >= n_pages


def test_full_config_rejected_by_the_tiny_envelope():
    plan = plan_serve_capacity(get_config("llama3.2-1b"), n_slots=2, max_len=64,
                               envelope="tiny-32m")
    assert not plan.fits and plan.headroom_bytes < 0
    (diag,) = plan.diagnostics(program="serve:llama3.2-1b:capacity")
    assert (diag.code, diag.severity, diag.platform) == ("capacity-oom", "warning", "tiny-32m")


def test_engine_plan_capacity_cross_checks_the_live_pool():
    from repro_torch.serve import ServeEngine

    engine = ServeEngine(get_config("llama3.2-1b").reduced(), n_slots=2, max_len=32,
                         page_size=8, seed=0, device="cpu")
    plan = engine.plan_capacity("cpu-host-16g")
    assert plan.pool_tokens == engine.kv.pool.token_capacity and plan.fits
    prom = engine.registry.render_prometheus()
    assert "serve_capacity_fits 1" in prom and "serve_capacity_headroom_bytes" in prom
    assert f"serve_capacity_max_slots {plan.max_slots}" in prom
    assert [d.code for d in engine.lint(envelope="cpu-host-16g")] == ["capacity-fit"]


# -- the estimator ------------------------------------------------------------------------


def _chain(x, w):
    for _ in range(4):
        x = torch.tanh(x @ w)
    return x.sum()


def _jchain(x, w):
    for _ in range(4):
        x = jnp.tanh(x @ w)
    return x.sum()


def test_estimator_bounds_the_references_estimate():
    """The reference's liveness walk frees a value at its last use (XLA
    fuses the rest away); the port's eager program holds a local until
    its frame returns.  Both count operands alike, and the port's bound
    sits above the reference's by at most the chain's intermediates."""
    x = np.zeros((256, 256), np.float32)
    ours = estimate_memory(_chain, torch.from_numpy(x), torch.from_numpy(x))
    theirs = jresources.estimate_memory(_jchain, x, x)
    assert ours.operand_bytes == theirs.operand_bytes == 2 * x.nbytes
    assert theirs.peak_live_bytes <= ours.peak_live_bytes <= 4 * theirs.peak_live_bytes
    # the rebound x holds each step's product and tanh until the return
    assert ours.peak_intermediate_bytes == 8 * x.nbytes + 512


def test_estimator_counts_operands_consts_and_intermediates():
    w = torch.ones(128, 128)  # closed over: a constant of the trace

    def f(x):
        return (x @ w).sum()

    x = torch.zeros(128, 128)
    est = estimate_memory(f, x)
    jw = jnp.ones((128, 128))
    jest = jresources.estimate_memory(lambda v: (v @ jw).sum(), x.numpy())
    assert est.operand_bytes == jest.operand_bytes == 128 * 128 * 4
    assert est.const_bytes == jest.const_bytes == 128 * 128 * 4
    assert est.peak_intermediate_bytes >= 128 * 128 * 4  # the product
    assert est.peak_live_bytes >= est.operand_bytes + est.const_bytes


def test_donation_credit_reduces_the_peak():
    def f(cache, delta):
        return {k: c + delta for k, c in cache.items()}

    cache = {"k": torch.zeros(64, 64)}
    plain = estimate_memory(f, cache, torch.ones(()))
    donated = estimate_memory(f, cache, torch.ones(()), donate_argnums=(0,))
    assert donated.donated_bytes == 64 * 64 * 4
    assert donated.peak_live_bytes < plain.peak_live_bytes


def test_in_place_and_views_add_no_bytes():
    def write(cache, new, idx, one):
        cache["k"][:, 0].copy_(new)
        cache["k"].add_(1.0)
        cache["i"].index_copy_(0, idx, one)
        return cache

    def views(x):
        return x.view(-1).reshape(64, 64).t().unsqueeze(0).expand(2, 64, 64)[:, :8]

    cache = {"k": torch.zeros(64, 64), "i": torch.zeros(4)}
    est = estimate_memory(write, cache, torch.ones(64), torch.zeros(1, dtype=torch.long),
                          torch.ones(1))
    assert est.peak_intermediate_bytes == 0
    assert estimate_memory(views, torch.zeros(64, 64)).peak_intermediate_bytes == 0


def test_a_local_lives_until_its_frame_returns():
    """An eager run frees a tensor when its last reference goes: a local
    of a called function is held until that function returns, a value
    passed on dies at its last use in the caller."""
    n = 64 * 64 * 4

    def inner(x):
        a = x * 2
        b = a + 1  # a is dead after this line, but held by inner's frame
        return b * 3

    def outer(x):
        y = inner(x)
        return y.sum()

    est = estimate_memory(outer, torch.zeros(64, 64))
    assert est.peak_intermediate_bytes == 3 * n  # a, b and the product live at once


# -- envelopes ------------------------------------------------------------------------------


def test_envelope_resolution():
    tiny = resolve_envelope("tiny-32m")
    assert tiny.memory_bytes == 32 * MiB and tiny is STATIC_ENVELOPES["tiny-32m"]
    custom = DeviceEnvelope("mine", "cpu", 123)
    assert resolve_envelope(custom) is custom
    with pytest.raises(KeyError, match="tiny-32m"):
        resolve_envelope("no-such-board")
    with pytest.raises(TypeError):
        resolve_envelope(3.14)
    probed = resolve_envelope("host", device="cpu")
    assert probed.source == "probed" and probed.platform == "cpu" and probed.memory_bytes > 0
    assert tiny.headroom_bytes(48 * MiB) < 0 < tiny.headroom_bytes(MiB)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_envelope("host")


def test_static_envelopes_keep_the_references_gpu_and_cpu_rows():
    """The reference's GPU and CPU rows at its bytes; its TPU rows are not
    carried, and asking for one raises its KeyError."""
    from repro.analysis.devices import STATIC_ENVELOPES as JSTATIC

    kept = {k: v for k, v in JSTATIC.items() if v.platform != "tpu"}
    assert set(STATIC_ENVELOPES) == set(kept)
    for name, env in kept.items():
        assert (STATIC_ENVELOPES[name].platform, STATIC_ENVELOPES[name].memory_bytes) == (
            env.platform, env.memory_bytes)
    assert STATIC_ENVELOPES["h100-80g"].smem_bytes == 227 * KiB
    with pytest.raises(KeyError, match="unknown device envelope 'tpu-v5e'"):
        resolve_envelope("tpu-v5e")


# -- the OOM pre-filter through a real search ---------------------------------------------


def _toy_registry():
    reg = FunctionBlockRegistry()
    reg.register("norm", "ref", lambda x: x * 1.0)
    reg.register("norm", "torch", lambda x: x + 0.0)
    reg.register("norm", "cuda", lambda x: x - 0.0)
    return reg


def _toy_space(reg):
    return BindingSpace(lambda: (lambda x: reg.call("norm", x)), registry=reg, tag="toy")


SMALL_ENVELOPE = DeviceEnvelope("test-64m", "cpu", 64 * MiB)
OOM_HINTS = {("norm", "cuda"): ResourceHint(workspace_bytes=128 * MiB)}
TIMES = {"ref": 0.02, "torch": 0.001, "cuda": 5.0}


class FakeExecutor:
    name = "fake"

    def __init__(self, times):
        self.times, self.measured = times, []

    def run(self, jobs, meter=None):
        from repro_torch.core.verify import Measurement

        out = []
        for job in jobs:
            binding = job.space.binding_of(job.candidate)
            self.measured.append(binding)
            out.append(Measurement(seconds=self.times[binding.get("norm", "ref")],
                                   compile_seconds=0.0, repeats=1))
        return out


def _searched_session(resources):
    session = OffloadSession(
        _toy_space(_toy_registry()), args=(torch.ones(4, 4),), strategy=SingleThenCombine(),
        executor=FakeExecutor(TIMES), repeats=1,
        resources=SMALL_ENVELOPE if resources else False,
        resource_hints=OOM_HINTS if resources else None, device="cpu")
    session.analyze()
    session.discover()
    return session, session.plan()


def test_oom_candidate_pruned_with_winner_parity():
    pruned_session, pruned_plan = _searched_session(resources=True)
    control_session, control_plan = _searched_session(resources=False)
    assert pruned_session._report.pruned > 0
    assert any("memory" in r for r in pruned_session._report.pruned_reasons.values())
    assert all(b.get("norm") != "cuda" for b in pruned_session.cache.executor.measured)
    assert any(b.get("norm") == "cuda" for b in control_session.cache.executor.measured)
    assert pruned_plan.mapping == control_plan.mapping == {"norm": "torch"}
    rep = pruned_session.resources_report
    assert ("norm", "cuda") in rep.oom and rep.verdicts[("norm", "torch")].fits
    assert control_session.resources_report is None


def test_resource_report_diagnostics_are_info_with_the_envelope_platform():
    rep = check_binding_space_resources(_toy_space(_toy_registry()), (torch.ones(4, 4),),
                                        envelope=SMALL_ENVELOPE, hints=OOM_HINTS, program="toy")
    diags = rep.diagnostics()
    assert diags and all(d.severity == "info" and d.platform == "test-64m" for d in diags)
    assert [d.subject for d in diags if d.code == "resource-oom"] == ["norm->cuda"]
    assert rep.counts()["oom"] == 1


def test_shared_memory_tile_verdict():
    """The counterpart of the reference's VMEM verdict: a CTA's tiles past
    the envelope's shared memory a block."""
    env = DeviceEnvelope("h100-ish", "gpu", 1 << 34, smem_bytes=227 * KiB)
    rep = check_binding_space_resources(
        _toy_space(_toy_registry()), (torch.ones(4, 4),), envelope=env,
        hints={("norm", "cuda"): ResourceHint(smem_tile_bytes=300 * KiB)})
    assert rep.verdicts[("norm", "cuda")].status == "smem-oom"
    assert "shared memory" in rep.oom[("norm", "cuda")]


# -- the CLIs -----------------------------------------------------------------------------


def test_preflight_cli_rejects_an_undersized_device(capsys):
    from repro_torch.launch.serve import main

    assert main(["--arch", "llama3.2-1b", "--envelope", "tiny-32m", "--preflight"]) == 2
    out = capsys.readouterr()
    assert "DOES NOT FIT" in out.out and "preflight: FAIL" in out.err


def test_preflight_cli_accepts_a_fitting_config(capsys):
    from repro_torch.launch.serve import main

    assert main(["--arch", "llama3.2-1b", "--reduced", "--envelope", "cpu-host-16g",
                 "--page-size", "16", "--max-len", "64", "--preflight"]) == 0
    out = capsys.readouterr().out
    assert "preflight: OK" in out and "FITS" in out


def test_shelf_coverage_flags_an_undeclared_impl():
    (d,) = lint_shelf_coverage(impls=(("newkernel", "cuda"),), legality={}, hints={})
    assert (d.code, d.severity) == ("shelf-coverage", "warning")
    assert "BLOCK_LEGALITY" in d.message and "BLOCK_RESOURCES" in d.message


def test_platform_normalized_out_of_the_fingerprint():
    on_cpu = Diagnostic("legality", "illegal-binding", "warning", "p", "x->cuda", "m", "cpu")
    on_gpu = dataclasses.replace(on_cpu, platform="gpu")
    assert on_cpu.fingerprint == on_gpu.fingerprint and "cpu" not in on_cpu.fingerprint
    assert Diagnostic.from_dict(on_cpu.to_dict()) == on_cpu
    legacy = {k: v for k, v in on_cpu.to_dict().items() if k != "platform"}
    assert Diagnostic.from_dict(legacy).platform == ""


def test_lint_cli_passes_against_the_committed_baseline(monkeypatch, capsys):
    """``python -m repro_torch.analysis.lint --fail-on-new --device cpu``:
    every zoo cell and both serve engines, nothing above the committed
    ``analysis_baseline_torch.json`` (which accepts no finding)."""
    from repro_torch.analysis.lint import main

    monkeypatch.chdir(ROOT)
    assert main(["--fail-on-new", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "0 new vs baseline 'analysis_baseline_torch.json'" in out
    assert "0 error, 0 warning" in out
