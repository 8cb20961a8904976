"""``repro_torch.analysis`` against ``repro.analysis``: diagnostics and the
baseline file, the page-table sanitizer, the abstract path through every
CUDA wrapper, legality (verdicts of every reduced zoo cell under the target
map, the pre-filter through a real search) and the hot-path lints (the
counterparts of ``tests/test_analysis.py``, and the engines' lints against
the reference engine's).

Everything runs on the CPU.  Fake CUDA tensors stand in for the card's
where a wrapper's abstract path is exercised: the wrappers never build or
launch under them.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import repro_torch.kernels as kernels
from repro import analysis as janalysis
from repro.configs import get_config as jget
from repro.models import lm as jlm
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve.kv import pool as jpool
from repro_torch import bridge
from repro_torch.analysis import (
    AnalysisReport,
    Baseline,
    Diagnostic,
    PageAliasError,
    ProgramSet,
    assert_page_table,
    check_binding_space,
    check_page_table,
    lint_shelf_coverage,
    lint_traced_program,
    trace_features,
)
from repro_torch.analysis.legality import TARGET_MAP, TargetConstraints
from repro_torch.apps import fourier, matrix
from repro_torch.configs import get_config
from repro_torch.core.blocks import FunctionBlockRegistry
from repro_torch.core.planner import BindingSpace, SingleThenCombine
from repro_torch.kernels import attention, build, fft, matmul, paged_attention, rmsnorm, ssd
from repro_torch.offload import OffloadSession
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.kv import pool as tpool

# -- diagnostics and the baseline file ----------------------------------------------


FIELDS = [("hotpath", "host-sync", "warning", "decode", "output[1]", "a", "cpu"),
          ("legality", "illegal-binding", "info", "zoo:x:decode", "rmsnorm->cuda", "b", "gpu"),
          ("paging", "page-alias", "error", "t:page-table", "page3:slot0+slot1", "c", "")]


@pytest.mark.parametrize("fields", FIELDS, ids=lambda f: f[1])
def test_fingerprints_equal_the_references_for_equal_fields(fields):
    ours, theirs = Diagnostic(*fields), janalysis.Diagnostic(*fields)
    assert ours.fingerprint == theirs.fingerprint
    assert ours.to_dict() == theirs.to_dict()
    # the fingerprint leaves out the message and the platform
    assert Diagnostic(*fields[:5], "other", "tpu").fingerprint == ours.fingerprint


def test_baselines_load_across_the_two_packages(tmp_path):
    diags = [Diagnostic(*f) for f in FIELDS]
    jdiags = [janalysis.Diagnostic(*f) for f in FIELDS]
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    Baseline().save(ours, AnalysisReport(diags))
    janalysis.Baseline().save(theirs, janalysis.AnalysisReport(jdiags))
    want = {d.fingerprint for d in diags if d.severity != "info"}
    assert janalysis.Baseline.load(ours).fingerprints == want
    assert Baseline.load(theirs).fingerprints == want
    assert set(json.loads(ours.read_text())) == set(json.loads(theirs.read_text()))
    assert AnalysisReport(diags).new_versus(Baseline.load(theirs)) == []


def test_unknown_severity_rejected():
    with pytest.raises(ValueError):
        Diagnostic("p", "c", "fatal", "prog", "s", "m")


# -- the page-table sanitizer ---------------------------------------------------------


def _drive(mod, seed=0):
    """One seeded alloc / ensure / free sequence over a module's PageTable."""
    rng = np.random.default_rng(seed)
    table = mod.PageTable(4, 4, mod.PagePool(14, 4))
    live = set()
    for _ in range(30):
        slot = int(rng.integers(0, 4))
        if slot in live and rng.random() < 0.3:
            table.free_slot(slot)
            live.discard(slot)
        elif slot in live:
            try:
                table.ensure(slot, min(16, table.lengths[slot] + int(rng.integers(1, 6))))
            except mod.PoolExhausted:
                pass
        elif table.can_admit(4):
            table.alloc_slot(slot, int(rng.integers(1, 9)))
            live.add(slot)
    return table, live


def _keys(diags):
    return sorted((d.code, d.severity, d.program, d.subject, d.message) for d in diags)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_table_diagnostics_equal_the_references(seed):
    ours, live = _drive(tpool, seed)
    theirs, jlive = _drive(jpool, seed)
    assert live == jlive and ours.array().tolist() == theirs.array().tolist()
    assert check_page_table(ours, live_slots=live) == []
    # induce the faults the sanitizer exists for, the same in both: an
    # alias between two live rows, a page named by a freed row
    for table in (ours, theirs):
        rows = sorted(s for s in range(4) if table._pages[s])
        if len(rows) >= 2:
            table._pages[rows[1]][0] = table._pages[rows[0]][0]
        dead = [s for s in range(4) if s not in live]
        if dead:
            table._pages[dead[0]].append(1)
        table._array_cache = None
    got = check_page_table(ours, live_slots=live)
    want = janalysis.check_page_table(theirs, live_slots=jlive)
    assert got and _keys(got) == _keys(want)


def test_page_table_validation_catches_an_induced_alias():
    table = tpool.PageTable(2, 4, tpool.PagePool(6, 8), validate=True)
    table.alloc_slot(0, 10)
    table.alloc_slot(1, 10)
    table.check_invariants()  # healthy
    table._pages[1][1] = table._pages[0][0]  # slot 1's second page aliases slot 0's first
    with pytest.raises(PageAliasError):
        table.ensure(1, 11)  # any mutation re-validates
    with pytest.raises(PageAliasError):
        assert_page_table(np.array([[0, 1], [1, 4]], np.int32), null_page=4, page_size=8)


@pytest.mark.parametrize("table,live,codes", [
    (np.array([[0, 9], [2, 4]], np.int32), {0}, {"page-range", "freed-slot-write"}),
    (np.array([[4, 2]], np.int32), None, {"page-hole"}),
    (np.array([[0, 1], [2, 4]], np.int32), None, set()),
], ids=["range_and_freed", "hole", "clean"])
def test_raw_table_checks_match_the_reference(table, live, codes):
    got = check_page_table(table, null_page=4, page_size=8, live_slots=live)
    want = janalysis.check_page_table(table, null_page=4, page_size=8, live_slots=live)
    assert {d.code for d in got} == codes and _keys(got) == _keys(want)


# -- the abstract path: every CUDA wrapper under fake tensors --------------------------


def _cases():
    """(kernel, call on tensors made by ``t(shape, dtype)``); the plain
    version is the same call on CPU tensors."""
    bf, f32, i32 = torch.bfloat16, torch.float32, torch.int32

    def norm_plain(t):
        return rmsnorm.rmsnorm(t((2, 8, 64), bf), t((64,), f32))

    def norm_add(t):
        return rmsnorm.rmsnorm(t((2, 8, 64), bf), t((64,), f32), delta=t((2, 8, 64), bf))

    def norm_gated(t):
        return rmsnorm.rmsnorm(t((1, 4, 2, 8), f32), t((16,), f32),
                               gate=(t((1, 4, 2, 8), bf), t((2,), f32), t((1, 4, 16), bf)))

    def norm_bwd(t):
        return rmsnorm.rmsnorm_bwd(t((2, 8, 64), bf), t((2, 8, 64), bf), t((64,), f32))

    def norm_bwd_add(t):
        x = t((2, 8, 64), bf)
        return rmsnorm.rmsnorm_bwd(x, t((2, 8, 64), bf), t((64,), f32), ds=t((2, 8, 64), bf))

    def flash(t):
        return attention.flash_attention(t((1, 4, 16, 64), bf), t((1, 2, 16, 64), bf),
                                         t((1, 2, 16, 64), bf))

    def flash_f32_mla(t):
        return attention.flash_attention(t((1, 4, 16, 48), f32), t((1, 2, 16, 48), f32),
                                         t((1, 2, 16, 32), f32))

    def flash_bwd(t):
        q = t((1, 4, 16, 64), bf)
        return attention.flash_attention_bwd(q, t((1, 2, 16, 64), bf), t((1, 2, 16, 64), bf),
                                             t((1, 4, 16, 64), bf), t((1, 4, 16), f32),
                                             t((1, 4, 16, 64), bf))

    def paged(t):
        return paged_attention.paged_attention(
            t((2, 4, 1, 64), bf), t((9, 2, 4, 64), bf), t((9, 2, 4, 64), bf),
            t((2, 4), i32), t((2,), i32))

    def paged_mla(t):
        return paged_attention.paged_attention(
            t((2, 8, 1, 32), bf), t((9, 1, 4, 32), bf), t((9, 1, 4, 32), bf),
            t((2, 4), i32), t((2,), i32), q_rope=t((2, 8, 1, 16), bf),
            kr_pool=t((9, 1, 4, 16), bf), scale=0.1)

    def mm(t):
        return matmul.matmul(t((128, 128), f32), t((128, 128), f32))

    def schur(t):
        return matmul.schur_update(t((128, 128), f32), t((128, 128), f32), t((128, 128), f32))

    def cmm(t):
        return fft.complex_matmul(*(t((128, 128), f32) for _ in range(4)))

    def ssd_bf16(t):
        return ssd.ssd_chunks(t((1, 32, 2, 8), bf), t((1, 32, 2), f32), t((2,), f32),
                              t((1, 32, 16), bf), t((1, 32, 16), bf), chunk=16)

    def ssd_f32(t):
        return ssd.ssd_chunks(t((1, 32, 2, 8), f32), t((1, 32, 2), f32), t((2,), f32),
                              t((1, 32, 16), f32), t((1, 32, 16), f32), chunk=16)

    return {"rmsnorm": [norm_plain, norm_add, norm_gated],
            "rmsnorm_bwd": [norm_bwd, norm_bwd_add],
            "flash_attention": [flash, flash_f32_mla], "flash_attention_bwd": [flash_bwd],
            "paged_attention": [paged, paged_mla], "matmul": [mm], "schur_update": [schur],
            "complex_matmul": [cmm], "ssd_chunks": [ssd_bf16, ssd_f32]}


CASES = [(name, call) for name, calls in _cases().items() for call in calls]


def _leaves(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.fixture
def no_library(monkeypatch):
    """The library build and the launch both raise: an abstract call must
    reach neither."""
    def refuse(*args):
        raise AssertionError("the abstract path reached the CUDA library")

    monkeypatch.setattr(build, "library", refuse)
    monkeypatch.setattr(build, "launch", refuse)


def test_every_kernel_has_an_abstract_case():
    assert {name for name, _ in CASES} == set(kernels.KERNELS)


@pytest.mark.parametrize("name,call", CASES, ids=[c.__name__ for _, c in CASES])
def test_wrapper_abstract_path_under_fake_cuda_tensors(name, call, no_library):
    """From fake CUDA operands each wrapper returns outputs of its plain
    version's shapes and dtypes, builds and launches nothing, moves no
    launch counter and notes its kernel as traced."""
    rng = np.random.default_rng(0)

    def cpu(shape, dtype):
        if dtype == torch.int32:
            return torch.from_numpy(rng.integers(0, 4, shape).astype(np.int32))
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)

    want = _leaves(call(cpu))
    before, traced = kernels.counters(), kernels.traced_counts()[name]
    with FakeTensorMode():
        got = _leaves(call(lambda shape, dtype: torch.empty(shape, dtype=dtype, device="cuda")))
    assert [(tuple(t.shape), t.dtype) for t in got] == [(tuple(t.shape), t.dtype) for t in want]
    assert all(t.device.type == "cuda" for t in got)
    assert kernels.counters() == before
    assert kernels.traced_counts()[name] > traced


@pytest.mark.parametrize("call,error", [
    (lambda e: attention.flash_attention(e(1, 4, 16, 520), e(1, 2, 16, 520), e(1, 2, 16, 520)),
     "exceed 512"),
    (lambda e: matmul.matmul(e(96, 128), e(128, 128)), "must tile"),
    (lambda e: rmsnorm.rmsnorm(e(2, 8, 64), e(32)), "must be float32 or bfloat16"),
    (lambda e: paged_attention.paged_attention(e(2, 4, 1, 600), e(9, 2, 4, 600), e(9, 2, 4, 600),
                                               torch.empty(2, 4, dtype=torch.int32, device="cuda"),
                                               torch.empty(2, dtype=torch.int32, device="cuda")),
     "exceeds 512"),
    (lambda e: ssd.ssd_chunks(e(1, 30, 2, 8), e(1, 30, 2), e(2), e(1, 30, 16), e(1, 30, 16),
                              chunk=16), "% chunk"),
], ids=["flash_head_dim", "matmul_tiles", "rmsnorm_weight", "paged_head_dim", "ssd_chunk"])
def test_abstract_path_keeps_the_wrappers_refusals(call, error, no_library):
    with FakeTensorMode(), pytest.raises((ValueError, TypeError), match=error):
        call(lambda *shape: torch.empty(shape, device="cuda"))


def test_probe_of_a_kernel_without_a_backward_is_illegal_in_a_train_step():
    """``ssd_scan -> cuda`` under autograd: the wrapper's GradRefused raises
    inside the probe trace, so the binding is illegal with that reason."""
    reg = FunctionBlockRegistry()
    # (this host's torch has no CUDA: autograd over a fake CUDA tensor
    # aborts it, so the stand-in for the plain version leaves x alone)
    reg.register("ssd_scan", "torch", lambda x, dt, a, b, c: (dt.clone(),))
    reg.register("ssd_scan", "cuda", lambda *args: ssd.ssd_chunks(*args, chunk=16))

    def builder():
        def step(x, dt, a, b, c):
            x = x.requires_grad_()
            return reg.call("ssd_scan", x, dt, a, b, c)[0].sum()

        return step

    with FakeTensorMode():
        args = (torch.empty(1, 32, 2, 8, device="cuda"), torch.empty(1, 32, 2, device="cuda"),
                torch.empty(2, device="cuda"), torch.empty(1, 32, 16, device="cuda"),
                torch.empty(1, 32, 16, device="cuda"))
    space = BindingSpace(builder, blocks={"ssd_scan": ["torch", "cuda"]}, registry=reg)
    report = check_binding_space(space, args, constraints={}, platform="gpu", program="train")
    (verdict,) = [v for v in report.verdicts if v.target == "cuda"]
    assert verdict.status == "illegal" and "GradRefused" in verdict.reason


# -- legality ---------------------------------------------------------------------------


def _zoo_cells():
    from repro_torch.configs import ARCH_NAMES

    return [(a, k) for a in ARCH_NAMES for k in ("prefill", "decode")]


@pytest.mark.parametrize("arch,kind", _zoo_cells())
def test_zoo_cell_verdicts_equal_the_references_under_the_target_map(arch, kind):
    """Every reduced zoo cell: the port's verdict of each (block, target),
    probe traces included, equals the reference's under pallas -> cuda,
    xla -> torch (both on a CPU host: the kernels are illegal for the
    platform)."""
    from repro.analysis.legality import check_binding_space as jcheck
    from repro.core import blocks as jblocks
    from repro.core.planner.space import BindingSpace as JBindingSpace
    from repro.offload import zoo as jzoo
    from repro_torch.core import blocks as tblocks
    from repro_torch.offload import zoo as tzoo

    kw = dict(reduced=True, layers=1, batch=1, seq=8, seed=0)
    builder, args, cfg = tzoo._cell_target(arch, kind, device="cpu", **kw)
    space = BindingSpace(builder, blocks=tzoo._cell_blocks(cfg, tblocks.registry, None, kind),
                         registry=tblocks.registry, tag=f"zoo:{arch}:{kind}")
    ours = check_binding_space(space, args, device="cpu")
    jbuilder, jargs, jcfg = jzoo._cell_target(arch, kind, **kw)
    jspace = JBindingSpace(jbuilder, blocks=jzoo._cell_blocks(jcfg, jblocks.registry, None, kind),
                           registry=jblocks.registry, tag=f"zoo:{arch}:{kind}")
    theirs = jcheck(jspace, jargs)
    assert ours.platform == theirs.platform == "cpu"
    assert {(v.block, v.target): (v.status, v.severity) for v in ours.verdicts} == {
        (v.block, TARGET_MAP[v.target]): (v.status, v.severity) for v in theirs.verdicts}
    assert ours.counts() == theirs.counts()


def _toy_registry():
    reg = FunctionBlockRegistry()
    reg.register("norm", "ref", lambda x: x * 1.0)
    reg.register("norm", "torch", lambda x: x + 0.0)

    def cuda_like(x):
        raise NotImplementedError("the kernel needs the card")

    reg.register("norm", "cuda", cuda_like)
    return reg


def _toy_space(reg):
    return BindingSpace(lambda: (lambda x: reg.call("norm", x)), registry=reg, tag="toy")


def test_probe_trace_rejects_an_untraceable_binding():
    report = check_binding_space(_toy_space(_toy_registry()), (torch.ones(4, 4),),
                                 constraints={}, program="toy", device="cpu")
    verdicts = {(v.block, v.target): v.status for v in report.verdicts}
    assert verdicts == {("norm", "ref"): "legal", ("norm", "torch"): "legal",
                        ("norm", "cuda"): "illegal"}
    (reason,) = [v.reason for v in report.verdicts if v.target == "cuda"]
    assert "probe trace failed" in reason


def test_platform_metadata_rejects_without_a_probe():
    constraints = {("norm", "cuda"): TargetConstraints(requires_platform=("gpu",)),
                   ("norm", "torch"): TargetConstraints()}
    report = check_binding_space(_toy_space(_toy_registry()), (torch.ones(4, 4),),
                                 constraints=constraints, platform="cpu", probe_trace=False)
    assert "requires platform gpu" in report.illegal[("norm", "cuda")]
    assert all(d.severity == "info" for d in report.diagnostics() if d.subject == "norm->cuda")


def test_shelf_declares_legality_and_resources_for_every_impl():
    assert set(kernels.BLOCK_LEGALITY) == set(kernels.SHELF_IMPL_PAIRS)
    assert set(kernels.BLOCK_RESOURCES) == set(kernels.SHELF_IMPL_PAIRS)
    assert len(kernels.SHELF_IMPL_PAIRS) == 19
    assert lint_shelf_coverage() == []
    for (block, target), spec in kernels.BLOCK_LEGALITY.items():
        assert spec.requires_platform == (("gpu",) if target == "cuda" else ()), (block, target)
        if target == "cuda":
            assert kernels.BLOCK_RESOURCES[(block, target)].smem_tile_bytes <= 227 * 1024


class FakeExecutor:
    """Deterministic measurements keyed on the candidate's binding (or its
    offloaded subset); never calls the built function."""

    name = "fake"

    def __init__(self, times):
        self.times = times
        self.measured: list[dict] = []

    def run(self, jobs, meter=None):
        from repro_torch.core.verify import Measurement

        out = []
        for job in jobs:
            mapping = job.space.mapping_of(job.candidate)
            self.measured.append(mapping)
            key = mapping.get("norm", "ref") if "ref" in self.times else len(mapping)
            out.append(Measurement(seconds=self.times[key], compile_seconds=0.0, repeats=1))
        return out


def _searched_session(legality, target=None, args=None, times=None, **kw):
    session = OffloadSession(
        target or _toy_space(_toy_registry()), args=args or (torch.ones(4, 4),),
        strategy=SingleThenCombine(), executor=FakeExecutor(times or {"ref": 0.02,
                                                                      "torch": 0.001,
                                                                      "cuda": 5.0}),
        repeats=1, legality=legality, **kw)
    session.analyze()
    session.discover()
    return session, session.plan()


def test_pruned_search_commits_the_same_winner_as_unpruned():
    pruned_session, pruned_plan = _searched_session(legality=True, device="cpu")
    control_session, control_plan = _searched_session(legality=False, device="cpu")
    assert pruned_session._report.pruned > 0
    assert any("cuda" in k for k in pruned_session._report.pruned_reasons)
    assert all(b.get("norm") != "cuda" for b in pruned_session.cache.executor.measured)
    assert any(b.get("norm") == "cuda" for b in control_session.cache.executor.measured)
    assert pruned_plan.mapping == control_plan.mapping == {"norm": "torch"}
    assert pruned_session.legality_report is not None
    assert control_session.legality_report is None


@pytest.mark.parametrize("app,x", [(fourier.fourier_app_libcall, fourier.make_input(64)),
                                   (matrix.matrix_app_libcall, matrix.make_input(96))],
                         ids=["fft", "lu"])
def test_app_sessions_commit_the_same_winner_with_legality(app, x):
    """An application's space (offload-or-not per discovered block) takes
    no pre-filter, as the reference's; the committed winner is the same."""
    times = {0: 1.0, 1: 0.1}  # offloading wins
    ours = [_searched_session(flag, target=app, args=(x,), times=times, device="cpu")
            for flag in (True, False)]
    assert ours[0][1].mapping == ours[1][1].mapping != {}
    assert ours[0][0]._report.pruned == 0 and ours[0][0].legality_report is None


# -- hot path: the counterparts of tests/test_analysis.py --------------------------------


def test_trace_features_collects_constants_and_kernels():
    big = torch.ones(512, 1024)  # 2 MiB

    def f(x):
        return x @ big

    feats = trace_features(f, torch.empty(4, 512))
    assert feats.largest_const_bytes >= big.numel() * 4
    assert "float32" in feats.dtypes and feats.flops == 2 * 4 * 512 * 1024
    assert not (feats.has_scan or feats.has_while or feats.callbacks)


def _cache_like():
    return torch.empty(2, 4, 16, 8)


def test_host_sync_flagged_for_a_logit_returning_decode_loop():
    def decode(tok, cache):
        logits = torch.zeros(4, 50_000) + tok[:, None]
        return cache, logits  # cache is the carry; the logits go to the host

    ps = ProgramSet()
    ps.register("decode", decode, loop=True, carry_outputs=(0,), expected_signatures=1)
    ps.observe("decode", torch.empty(4, dtype=torch.int32), _cache_like())
    assert "host-sync" in [d.code for d in ps.lint()]


def test_fused_sampling_decode_contract_is_clean():
    def decode(tok, cache):
        return tok.argmax()[None].to(torch.int32), cache

    ps = ProgramSet()
    ps.register("decode", decode, loop=True, carry_outputs=(1,), expected_signatures=1)
    ps.observe("decode", torch.empty(4, dtype=torch.int32), _cache_like())
    assert ps.lint() == []


def test_shape_drift_flagged_as_retrace_risk():
    ps = ProgramSet()
    ps.register("insert", lambda x: x * 2, expected_signatures=1)
    ps.observe("insert", torch.empty(4, 8))
    assert ps.lint() == []
    ps.observe("insert", torch.empty(4, 9))
    diags = ps.lint()
    assert [d.code for d in diags] == ["retrace-risk"] and diags[0].severity == "warning"


def test_python_scalar_in_a_loop_program_flagged():
    ps = ProgramSet()
    ps.register("decode", lambda x, t: x * t, loop=True)
    ps.observe("decode", torch.empty(4), 0.8)
    assert "weak-type" in [d.code for d in ps.lint()]


def test_const_capture_and_host_reads_flagged():
    table = torch.ones(600, 600)  # ~1.4 MB > the 1 MiB budget

    def f(x):
        return x @ table

    assert "const-capture" in [d.code for d in lint_traced_program("p", f, [torch.empty(2, 600)])]

    def g(x):
        return x * x.sum().item()

    diags = lint_traced_program("p", g, [torch.empty(4)])
    assert [(d.code, d.subject) for d in diags] == [("callback", "aten._local_scalar_dense")]


def test_observed_wrapper_records_without_changing_results():
    ps = ProgramSet()
    wrapped = ps.register("f", lambda x: x + 1)
    assert int(wrapped(torch.zeros((), dtype=torch.int32))) == 1
    assert wrapped.record.calls == 1 and ps["f"](torch.ones(())) == 2


# -- the engines' lints against the reference engine's --------------------------------------


@pytest.mark.parametrize("arch,page_size", [("llama3.2-1b", 8), ("mamba2-2.7b", None)],
                         ids=["llama_paged", "mamba2_contiguous"])
def test_engine_lint_codes_equal_the_reference_engines(arch, page_size):
    """Reduced f32 engines serve one short trace under page-table
    validation; ``engine.lint()`` gives the reference engine's codes (none:
    decode transfers token ids only, recomposing the batch adds no
    signature, no page aliasing), and every program called is traced."""
    jcfg = dataclasses.replace(jget(arch).reduced(), compute_dtype="float32", remat="none")
    cfg = dataclasses.replace(get_config(arch).reduced(), compute_dtype="float32")
    jparams = jax.tree.map(np.asarray, jlm.init_params(jcfg, seed=0))
    kw = dict(n_slots=2, max_len=32, page_size=page_size, seed=0)
    jeng = JServeEngine(jcfg, params=jparams, kv_validate=page_size is not None, **kw)
    teng = ServeEngine(cfg, params=bridge.params_from_numpy(jparams, cfg), device="cpu",
                       kv_validate=page_size is not None, **kw)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 5 + i).tolist() for i in range(3)]
    for engine, request in ((jeng, JRequest), (teng, Request)):
        for p in prompts:
            engine.submit(request(p, max_new_tokens=4))
        assert len(engine.run_until_idle(max_steps=64)) == 3
    assert [d.code for d in teng.lint()] == [d.code for d in jeng.lint()] == []
    stats = teng.programs.stats()
    assert stats["decode"]["signatures"] == 1 and stats["decode"]["calls"] > 0
    assert stats["insert"]["calls"] == 3 and stats["insert"]["signatures"] == 1
    assert set(jeng.programs.records) >= set(teng.programs.records)
    for name in teng.programs.records:
        assert teng.programs.features(name).n_eqns > 0
    # the engine's step programs stay reachable by name
    assert set(teng.graph_stats()) == {"prefill", "decode"}
    assert teng.programs["decode"] is teng.programs.records["decode"].fn


def test_lint_leaves_the_engine_serving_as_before():
    """A lint between steps swaps the engine's state for fake tensors only
    while it traces: the next requests decode the same tokens as an engine
    that was never linted."""
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(), compute_dtype="float32")
    engines = [ServeEngine(cfg, n_slots=2, max_len=32, page_size=8, seed=0, device="cpu")
               for _ in range(2)]
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, 6 + i).tolist() for i in range(4)]
    outs = []
    for i, engine in enumerate(engines):
        for p in prompts[:2]:
            engine.submit(Request(p, max_new_tokens=3))
        engine.run_until_idle(max_steps=64)
        if i == 0:
            assert engine.lint() == []
        for p in prompts[2:]:
            engine.submit(Request(p, max_new_tokens=3))
        outs.append([c.tokens for c in engine.run_until_idle(max_steps=64)])
    assert outs[0] == outs[1]
