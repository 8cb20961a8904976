"""``CostGuidedSearch``, ``rank_candidates_by_cost`` and
``GeneticSearch(seed_from_cost=True)`` of the port (``repro_torch.core.
planner``) against the reference's: the port's mirrors of
``tests/test_planner.py``'s cost-guided tests and
``tests/test_offload_session.py``'s objective and GA-seeding tests, run
on a table of timings in place of sleeps (the same trials, no clock), the
roofline cost function of a fake trace, the legality seam that keeps a
pruned candidate from being traced, and ``plan_zoo(strategy=)``.  CPU only.
"""

import warnings

import pytest
import torch

from repro.core import planner as jplanner
from repro.core import verify as jverify
from repro_torch.core import planner, verify
from repro_torch.core.blocks import FunctionBlockRegistry
from repro_torch.core.planner import (
    CostGuidedSearch,
    ExhaustiveSearch,
    GeneticSearch,
    Latency,
    MeasurementCache,
    PerfPerWatt,
    PowerMeter,
    SingleThenCombine,
)
from repro_torch.metering import SerialExecutor

COSTS3 = {
    frozenset(): 0.040,
    frozenset({"a"}): 0.025,
    frozenset({"b"}): 0.030,
    frozenset({"c"}): 0.050,
    frozenset({"a", "b"}): 0.012,
    frozenset({"a", "c"}): 0.030,
    frozenset({"b", "c"}): 0.035,
    frozenset({"a", "b", "c"}): 0.020,
}
# offloading "blk" is 3x faster but drawn at 1000x the power
POWER_COSTS = {frozenset(): 0.018, frozenset({"blk"}): 0.006}
POWER_WATTS = {(): 1.0, ("blk",): 1000.0}


class _TableExecutor(SerialExecutor):
    """Times each job from a table keyed by its offload pattern (what the
    reference's tests sleep for), the meter bracketing it as ``run_job``
    does."""

    measurement = verify.Measurement

    def __init__(self, costs):
        self.costs = costs

    def run(self, jobs, meter=None):
        out = []
        for job in jobs:
            m = self.measurement(self.costs[frozenset(job.space.pattern(job.candidate))], 0.0, 1)
            if meter is not None:
                m.energy_joules = meter.end(m, space=job.space, candidate=job.candidate)
                m.energy_provenance = getattr(meter, "provenance", None)
            out.append(m)
        return out


class _JTableExecutor(_TableExecutor):
    measurement = jverify.Measurement


def _space(names, pkg=planner):
    return pkg.SubsetSpace(lambda subset: (lambda x: x), names)


def _cache(costs, meter=None):
    return MeasurementCache(executor=_TableExecutor(costs), meter=meter)


def _est3():
    return {c: COSTS3[frozenset(p)] for c, p in [
        ((1, 0, 0), {"a"}), ((0, 1, 0), {"b"}), ((0, 0, 1), {"c"}),
        ((1, 1, 0), {"a", "b"}), ((1, 0, 1), {"a", "c"}),
        ((0, 1, 1), {"b", "c"}), ((1, 1, 1), {"a", "b", "c"}),
    ]}


def test_cost_guided_search_measures_only_top_k():
    est = _est3()
    cache = _cache(COSTS3)
    rep = CostGuidedSearch(
        top_k=2, cost_fn=lambda space, cand, args: est[cand]
    ).search(_space(["a", "b", "c"]), (0,), cache=cache, repeats=1)
    # baseline + the 2 cheapest-by-model candidates, nothing else
    assert cache.misses == 3
    assert rep.best.pattern == ("a", "b")
    assert rep.strategy == "cost_guided"


def test_cost_guided_search_same_trials_as_the_reference():
    est = _est3()
    cost_fn = lambda space, cand, args: est[cand]  # noqa: E731
    rep = CostGuidedSearch(top_k=3, cost_fn=cost_fn).search(
        _space(["a", "b", "c"]), (0,), cache=_cache(COSTS3), repeats=1)
    jrep = jplanner.CostGuidedSearch(top_k=3, cost_fn=cost_fn).search(
        _space(["a", "b", "c"], jplanner), (0,),
        cache=jplanner.MeasurementCache(executor=_JTableExecutor(COSTS3)), repeats=1)
    assert [t.candidate for t in rep.trials] == [t.candidate for t in jrep.trials]
    assert rep.best.pattern == jrep.best.pattern and rep.evaluations == jrep.evaluations


def test_cost_guided_search_falls_back_when_model_fails():
    costs = {frozenset(): 0.02, frozenset({"a"}): 0.005}

    def broken(space, cand, args):
        raise RuntimeError("untraceable")

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        rep = CostGuidedSearch(top_k=1, cost_fn=broken).search(
            _space(["a"]), (0,), cache=_cache(costs), repeats=1
        )
    assert any("falling back" in str(x.message) for x in w)
    assert rep.best.pattern == ("a",)


def test_roofline_cost_ranks_torch_variants():
    small = torch.ones(8, 8)
    t_small = planner.roofline_seconds(lambda x: x @ x, (small,))
    big = torch.ones(64, 64)
    t_big = planner.roofline_seconds(lambda x: x @ x, (big,))
    assert 0 < t_small < t_big


# -- objectives through every strategy ----------------------------------------------------


class _PatternPower(PowerMeter):
    """Test meter: per-candidate draw looked up by offload pattern."""

    def __init__(self, watts_by_pattern, default=1.0):
        self.watts_by_pattern = watts_by_pattern
        self.default = default

    def end(self, measurement, space=None, candidate=None):
        return measurement.seconds * self.watts_by_pattern.get(space.pattern(candidate),
                                                               self.default)


@pytest.mark.parametrize(
    "strategy_factory",
    [
        lambda: SingleThenCombine(),
        lambda: ExhaustiveSearch(),
        lambda: GeneticSearch(population=2, generations=2, seed=0),
        lambda: CostGuidedSearch(top_k=1, cost_fn=lambda space, cand, args: 0.0),
    ],
    ids=["single_then_combine", "exhaustive", "genetic", "cost_guided"],
)
def test_every_strategy_selects_by_injected_objective(strategy_factory):
    """All four strategies pick the offload under Latency and the baseline
    under PerfPerWatt — same space, same measurements, different winner."""
    cache = _cache(POWER_COSTS, meter=_PatternPower(POWER_WATTS))
    space = _space(["blk"])

    lat = strategy_factory().search(space, (0,), cache=cache, repeats=1, objective=Latency())
    assert lat.best.pattern == ("blk",)
    assert lat.objective == "latency"

    # identical trials (replayed from the shared cache, energy included)
    ppw = strategy_factory().search(space, (0,), cache=cache, repeats=1,
                                    objective=PerfPerWatt())
    assert ppw.evaluations == 0  # nothing re-measured
    assert ppw.best.pattern == ()
    assert ppw.objective == "perf_per_watt"
    assert ppw.best.energy_joules is not None


# -- GA cost seeding -------------------------------------------------------------------------


def test_ga_seeds_population_from_cost_model():
    """With seed_from_cost, generation zero contains the cost model's top
    pick instead of random genomes."""
    costs = {
        frozenset(): 0.030,
        frozenset({"a"}): 0.024,
        frozenset({"b"}): 0.012,
        frozenset({"a", "b"}): 0.018,
    }
    est = {(0, 0): 9.0, (1, 0): 3.0, (0, 1): 1.0, (1, 1): 2.0}
    asked = []

    def cost_fn(space, cand, args):
        asked.append(cand)
        return est[cand]

    ga = GeneticSearch(population=2, generations=1, seed=0, seed_from_cost=True,
                       cost_fn=cost_fn)
    rep = ga.search(_space(["a", "b"]), (0,), cache=_cache(costs), repeats=1)
    assert asked  # the static model was consulted
    # population = [baseline, cost-model best] -> both were measured
    measured = {t.candidate for t in rep.trials}
    assert (0, 1) in measured
    assert rep.best.pattern == ("b",)
    jga = jplanner.GeneticSearch(population=2, generations=1, seed=0, seed_from_cost=True,
                                 cost_fn=lambda space, cand, args: est[cand])
    jrep = jga.search(_space(["a", "b"], jplanner), (0,),
                      cache=jplanner.MeasurementCache(executor=_JTableExecutor(costs)), repeats=1)
    assert [t.candidate for t in rep.trials] == [t.candidate for t in jrep.trials]


def test_ga_cost_seeding_falls_back_on_failure():
    def broken(space, cand, args):
        raise RuntimeError("untraceable")

    ga = GeneticSearch(population=2, generations=1, seed=0, seed_from_cost=True, cost_fn=broken)
    with pytest.warns(UserWarning, match="seeding randomly"):
        rep = ga.search(_space(["blk"]), (0,), cache=_cache(POWER_COSTS), repeats=1)
    assert rep.best.pattern == ("blk",)


# -- the roofline over a binding space: the legality seam -------------------------------------


def _binding_space():
    """One block, three targets: ``ref`` (one product), ``torch`` (two),
    ``cuda`` (marked illegal: it must never be traced)."""
    reg = FunctionBlockRegistry()
    traced = []

    def target(name, n):
        def fn(x):
            traced.append(name)
            for _ in range(n):
                x = x @ x
            return x
        return fn

    reg.register("mm", "ref", target("ref", 1))
    reg.register("mm", "torch", target("torch", 2))
    reg.register("mm", "cuda", target("cuda", 1))
    space = planner.BindingSpace(lambda: (lambda x: reg.call("mm", x)),
                                 blocks={"mm": ["ref", "torch", "cuda"]}, registry=reg)
    space.mark_illegal({("mm", "cuda"): "no card"})
    return space, traced


def test_legality_pruned_candidate_is_never_traced():
    space, traced = _binding_space()
    costs = {frozenset(): 0.02, frozenset({"mm"}): 0.01}

    class Exec(_TableExecutor):
        def run(self, jobs, meter=None):
            return [self.measurement(0.01 if job.candidate != (0,) else 0.02, 0.0, 1)
                    for job in jobs]

    strategy = CostGuidedSearch(top_k=2)  # the default cost model: the roofline
    rep = strategy.search(space, (torch.ones(32, 32),),
                          cache=MeasurementCache(executor=Exec(costs)), repeats=1)
    assert "cuda" not in traced and "torch" in traced
    assert rep.pruned == 1
    assert {t.candidate for t in rep.trials} == {(0,), (1,)}
    ranked = planner.rank_candidates_by_cost(space, (torch.ones(32, 32),))
    assert [c for _, c in ranked] == [(2,), (1,)]  # one product before two


def test_plan_zoo_with_cost_guided_search(tmp_path):
    """``plan_zoo(strategy=CostGuidedSearch(top_k=1))`` on a reduced decode
    cell: the roofline ranks the cell's bindings from their traces and only
    the baseline and the top pick are measured."""
    from repro_torch.core.planner import make_roofline_cost_fn
    from repro_torch.offload.zoo import plan_zoo

    roofline, ranked = make_roofline_cost_fn(), []

    def cost_fn(space, cand, args):
        ranked.append(roofline(space, cand, args))
        return ranked[-1]

    strategy = CostGuidedSearch(top_k=1, cost_fn=cost_fn)
    out = plan_zoo(str(tmp_path), [("llama3.2-1b", "decode")], layers=1, batch=1, seq=8,
                   targets=["ref", "torch"], strategy=strategy, device="cpu")
    result = out[("llama3.2-1b", "decode")]
    assert result.report.strategy == "cost_guided"
    assert len(result.report.trials) == 2
    # every binding but the baseline ranked, each a positive roofline
    assert len(ranked) == 2 ** len(result.report.trials[0].candidate) - 1
    assert all(r > 0 for r in ranked)
