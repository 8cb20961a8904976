"""The port's function-block offload pipeline against the JAX package, on
the CPU (``device="cpu"``: the replacement blocks run their plain
versions; ``chip_smoke.py`` runs them through the CUDA kernels).

Step 1-2 are pure Python on both sides, so the DB, the AST reports of the
Numerical Recipes code (verbatim in both packages) and the similarity
scores are equal, the scores to 1e-12.  The chosen patterns come from
timings and agree because each block wins by a wide margin at these sizes
(tests/test_engine.py's).  Outputs: the FFT apps within 1e-5 of the
spectrum's max (two f32 DFT stages against XLA's f32 FFT); determinants
within 1e-5 (f32 LU); staged variants within 1e-5 of the reference's (the
same f32 device stages).  The search strategies are held to the
reference's with injected timings: one measurement table answers both, so
the same seed must visit and choose the same candidates.

torch runs on one CPU thread in this module: parallel test workers each
spinning a torch thread pool on the same cores stall the plain matmuls by
tenths of a second, which would decide the timed searches instead of the
code.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.apps import fourier as jfourier
from repro.apps import matrix as jmatrix
from repro.core import OffloadEngine as JEngine
from repro.core import planner as jplanner
from repro.core import similarity as jsimilarity
from repro.core import verify as jverify
from repro.core.pattern_db import default_db as jdefault_db
from repro.offload import OffloadSession as JSession
from repro_torch.apps import fourier, matrix
from repro_torch.core import OffloadEngine, planner, similarity, verify
from repro_torch.core.pattern_db import default_db
from repro_torch.metering import DeviceParallelExecutor, SerialExecutor, resolve_meter
from repro_torch.offload import OffloadSession

APPS = {
    "fourier_app_libcall": (fourier, jfourier, lambda m: m.make_input(64)),
    "fourier_app_copied": (fourier, jfourier, lambda m: m.make_input(64)),
    "matrix_app_libcall": (matrix, jmatrix, lambda m: m.make_input(96)),
    "matrix_app_copied": (matrix, jmatrix, lambda m: m.make_input(96)),
}
WANT_PATTERN = {
    "fourier_app_libcall": ("fft2d",), "fourier_app_copied": ("fft2d",),
    "matrix_app_libcall": ("lu",), "matrix_app_copied": ("lu",),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def sessions():
    """Both pipelines run once per app; the tests below read the results."""
    out = {}
    for name, (mod, jmod, make) in APPS.items():
        x = make(mod)
        port = OffloadSession(getattr(mod, name), args=(x,), repeats=1, device="cpu").run()
        ref = JSession(getattr(jmod, name), args=(x,), repeats=1).run()
        out[name] = (x, port, ref)
    return out


def _ported(name: str) -> bool:
    """Definitions whose source is the reference's verbatim (the device
    stages and the variant builders are the port's own torch code)."""
    return not name.startswith(("_dev_", "build_"))


def _verbatim(report):
    """(defs, loops) of a report outside the port's own code, nested
    helpers of the device stages included."""
    own = [(d.lineno, d.lineno + d.source.count("\n"))
           for d in report.func_defs if not _ported(d.name)]

    def outside(line):
        return not any(a <= line <= b for a, b in own)

    defs = [d for d in report.func_defs if outside(d.lineno)]
    loops = [(lp.enclosing, lp.kind, lp.depth, lp.body_len)
             for lp in report.loops if outside(lp.lineno)]
    return defs, loops


def test_pattern_db_matches_reference():
    db, jdb = default_db(), jdefault_db()
    assert [e.name for e in db.entries()] == [e.name for e in jdb.entries()]
    assert db.known_library_names == jdb.known_library_names
    for e, je in zip(db.entries(), jdb.entries()):
        assert e.source_names == je.source_names
        assert (e.interface and dataclasses.asdict(e.interface)) == (
            je.interface and dataclasses.asdict(je.interface)
        )
        assert e.reference_code == je.reference_code
        assert e.impl.startswith("repro_torch.kernels.") and e.target == "cuda"


@pytest.mark.parametrize("name", sorted(APPS))
def test_ast_report_matches_reference(name):
    mod, jmod, _ = APPS[name]
    rep = OffloadEngine(device="cpu").analyze(getattr(mod, name))
    jrep = JEngine().analyze(getattr(jmod, name))
    assert [(c.call_name, c.enclosing) for c in rep.library_calls] == [
        (c.call_name, c.enclosing) for c in jrep.library_calls
    ]
    defs, loops = _verbatim(rep)
    jdefs, jloops = _verbatim(jrep)
    assert [(d.name, d.source, d.calls, d.kind) for d in defs] == [
        (d.name, d.source, d.calls, d.kind) for d in jdefs
    ]
    assert loops == jloops


@pytest.mark.parametrize("module", ["fourier", "matrix"])
def test_similarity_scores_match_reference(module):
    mod, jmod = (fourier, jfourier) if module == "fourier" else (matrix, jmatrix)
    rep = OffloadEngine(device="cpu").analyze(mod.make_input)
    refs = [e.reference_code for e in default_db().entries_with_reference()]
    for fd in _verbatim(rep)[0]:
        for code in refs:
            assert abs(similarity.similarity(fd.source, code)
                       - jsimilarity.similarity(fd.source, code)) < 1e-12
            assert abs(similarity.cosine(fd.source, code)
                       - jsimilarity.cosine(fd.source, code)) < 1e-12
    assert similarity.similarity(mod.REFERENCE_CODE, jmod.REFERENCE_CODE) == 1.0


@pytest.mark.parametrize("name", sorted(APPS))
def test_discoveries_and_pattern_match_reference(name, sessions):
    _, port, ref = sessions[name]
    assert port.pattern == ref.pattern == WANT_PATTERN[name]
    assert port.numerics_ok and ref.numerics_ok
    assert [(d.kind, d.source_name, d.entry.name) for d in port.discoveries] == [
        (d.kind, d.source_name, d.entry.name) for d in ref.discoveries
    ]
    for d, jd in zip(port.discoveries, ref.discoveries):
        assert abs(d.score - jd.score) < 1e-12
    assert port.skipped == [] and ref.skipped == []
    assert port.speedup > 1.0


@pytest.mark.parametrize("name", sorted(APPS))
def test_adapted_outputs_match_reference(name, sessions):
    x, port, ref = sessions[name]
    got, want = port.fn(x), ref.fn(x)
    if name.startswith("fourier"):
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape and got.dtype == want.dtype
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-5
        assert np.abs(got - np.fft.fft2(x)).max() / np.abs(want).max() < 1e-5
    else:
        assert abs(float(got) - float(want)) < 1e-5
        assert abs(abs(float(got)) - 1.0) < 1e-4  # orthogonal input


def test_unrelated_code_not_discovered():
    engine = OffloadEngine(device="cpu")
    rep = engine.analyze(fourier.fourier_app_libcall)
    assert engine.discover(rep, entry_fn="unrelated_helper") == []


@pytest.mark.parametrize("genome", [(0,) * 6, (1,) * 6, (1, 0, 1, 0, 1, 0), (0, 1, 1, 0, 0, 1)])
def test_fft_staged_variants_match_reference(genome):
    x = fourier.make_input(16)
    got = fourier.build_fft_variant(genome, device="cpu")(x)
    want = jfourier.build_fft_variant(genome)(x)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5
    np.testing.assert_allclose(got, np.fft.fft2(x), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("genome", [(0, 0, 0), (1, 1, 1), (0, 1, 0), (1, 0, 1)])
def test_lu_staged_variants_match_reference(genome):
    a = matrix.make_input(16)
    got = float(matrix.build_lu_variant(genome, device="cpu")(a))
    want = float(jmatrix.build_lu_variant(genome)(a))
    assert abs(got - want) < 1e-5
    assert abs(got - np.linalg.det(a)) < 1e-4


# -- search strategies with injected timings ---------------------------------------------


def _timing(cand) -> float:
    """A fixed, non-monotone landscape: genes 0 and 2 help, gene 1 hurts,
    genes 3-4 help only together."""
    g = tuple(cand)
    t = 1.0 - 0.3 * g[0] + 0.2 * g[1] - 0.25 * g[2]
    t -= 0.15 * (g[3] and g[4])
    return t + 0.01 * sum(g)


class _TableExecutor(SerialExecutor):
    """Answers every job from ``_timing`` instead of running it."""

    measurement = verify.Measurement

    def run(self, jobs, meter=None):
        return [self.measurement(_timing(j.candidate), 0.0, 1) for j in jobs]


class _JTableExecutor(_TableExecutor):
    measurement = jverify.Measurement


def _spaces():
    names = [f"g{i}" for i in range(5)]
    return (planner.SubsetSpace(lambda s: (lambda x: x), names, tag="table"),
            jplanner.SubsetSpace(lambda s: (lambda x: x), names, tag="table"))


@pytest.mark.parametrize("strategy", ["single_then_combine", "genetic"])
def test_strategies_choose_what_the_reference_chooses(strategy):
    space, jspace = _spaces()
    if strategy == "genetic":
        ours = planner.GeneticSearch(population=6, generations=4, seed=3)
        theirs = jplanner.GeneticSearch(population=6, generations=4, seed=3)
    else:
        ours, theirs = planner.SingleThenCombine(), jplanner.SingleThenCombine()
    rep = ours.search(space, (0,), cache=planner.MeasurementCache(executor=_TableExecutor()))
    jrep = theirs.search(jspace, (0,), cache=jplanner.MeasurementCache(executor=_JTableExecutor()))
    assert [t.candidate for t in rep.trials] == [t.candidate for t in jrep.trials]
    assert rep.best.candidate == jrep.best.candidate
    assert rep.best.pattern == jrep.best.pattern
    assert rep.generations == jrep.generations
    assert rep.evaluations == jrep.evaluations


def test_session_stages_and_unported_options():
    """Stages run in order; ``tracer=`` (once a stub) records one
    ``stage:<name>`` span per stage, as the reference's session does;
    ``meter=`` and the device-parallel executor (once stubs) are wired into
    the cache."""
    from repro_torch.obs import Tracer

    x = fourier.make_input(16)
    session = OffloadSession(fourier.fourier_app_libcall, args=(x,), device="cpu")
    with pytest.raises(Exception, match="before analyze"):
        session.discover()
    tracer = Tracer()
    OffloadSession(fourier.fourier_app_libcall, args=(x,), device="cpu", repeats=1,
                   tracer=tracer).run()
    stages = [r.name for r in tracer.records() if r.name.startswith("stage:")]
    assert stages == ["stage:analyze", "stage:discover", "stage:plan", "stage:verify",
                      "stage:commit"]
    cache = planner.MeasurementCache(executor="device-parallel")
    assert isinstance(cache.executor, DeviceParallelExecutor)
    metered = OffloadSession(fourier.fourier_app_libcall, args=(x,), device="cpu", meter="auto")
    assert type(metered.cache.meter) is type(resolve_meter("auto"))
    with pytest.raises(RuntimeError, match="not available on this host"):
        OffloadSession.plan_zoo("unused", [("llama3.2-1b", "train")], device="cpu",
                                meter="tpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            OffloadSession(fourier.fourier_app_libcall, args=(x,)).run()


# -- measurements of captured units ----------------------------------------------------


class _StubGraph:
    """A captured call for the CPU: capture records nothing, a replay runs."""

    def __init__(self, run, pool):
        self.run = run
        self.outputs = None

    def replay(self):
        return self.run()


def test_measure_times_a_captured_unit_only_after_its_capture(monkeypatch):
    """A unit with the capture rule of ``runtime.programs.Captures`` reports
    two warm-up calls (eager, then capture): ``measure`` makes both before
    it times, so every timed call is a replay.  A function that reports
    none keeps its ``warmup`` calls."""
    from repro_torch.runtime import programs

    monkeypatch.setattr(programs, "Graph", _StubGraph)
    captures = programs.Captures()
    calls = []

    def unit():
        replays = captures.replays
        out = captures("key", lambda: calls.append("run"))
        calls[-1] = "replay" if captures.replays > replays else calls[-1]
        return out

    unit.warmup_calls = programs.Captures.WARMUP_CALLS
    m = verify.measure(unit, (), repeats=3, warmup=1)
    assert m.repeats == 3
    # call 1 eager, call 2 captured and replayed; the three timed calls replay
    assert calls == ["run", "replay", "replay", "replay", "replay"]
    assert len(captures.keys()) == 1

    plain = []
    verify.measure(lambda: plain.append(1), (), repeats=3, warmup=1)
    assert len(plain) == 4
    verify.measure(lambda: plain.append(1), (), repeats=2, warmup=0)
    assert len(plain) == 6


def test_units_report_their_warmup_through_every_wrapper():
    """A captured program reports two warm-up calls on CUDA and one off it;
    the wrappers a measured variant is built of (a device block, its host
    glue and interface adaptation, a staged variant, a bound step) carry
    the report, and a CPU variant reports one, so no CPU measurement makes
    another call."""
    from repro_torch.apps import common, matrix
    from repro_torch.core import engine as core_engine
    from repro_torch.core.interface import Adaptation
    from repro_torch.core.planner import BindingSpace
    from repro_torch.kernels import ops
    from repro_torch.runtime.programs import Program

    step = lambda x: x  # noqa: E731
    assert Program("p", step, "cuda").warmup_calls == 2
    assert Program("p", step, "cuda", graphs=False).warmup_calls == 1
    assert Program("p", step, "cpu").warmup_calls == 1
    on_card = core_engine._device_wrap(ops.lu_nr_compat, torch.device("cuda"))
    assert on_card.warmup_calls == 2
    assert core_engine._host_wrap(on_card).warmup_calls == 2
    assert Adaptation((), (), (), (), (), True).wrap(on_card).warmup_calls == 2
    assert core_engine._device_wrap(ops.lu_nr_compat, torch.device("cpu")).warmup_calls == 1
    variant = common.build_staged_variant(matrix.LU_STAGES, [1] * len(matrix.LU_STAGES),
                                          device="cpu")
    assert variant.warmup_calls == 1
    space = BindingSpace(lambda: Program("step", step, "cuda"), blocks={"rmsnorm": ("torch",)})
    assert space.build(space.baseline()).warmup_calls == 2
