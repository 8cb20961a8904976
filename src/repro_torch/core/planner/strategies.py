"""SearchStrategy implementations over any SearchSpace (the port of
``repro/core/planner/strategies.py``).

All strategies measure through a shared ``MeasurementCache`` and produce a
``PlanReport`` whose trials keep the compile/runtime split per candidate.
Winner selection goes through a pluggable ``Objective``
(``objectives.Latency`` by default) — strategies never compare
``trial.seconds`` directly, so power-aware objectives work everywhere.

  SingleThenCombine   the paper's §4.2 Step-3 procedure, generalised to
                      n-ary axes: baseline, every (axis, choice) alone,
                      then the combination of per-axis winners, adopted
                      only if it beats the best single.
  GeneticSearch       the prior-work loop-offload GA (paper §3.2, refs
                      [32][33]), now working over arbitrary axis
                      cardinalities (n-ary genome: gene = choice index).
  CostGuidedSearch    rank candidates by a static cost model (the roofline
                      of a fake trace by default, ``planner.cost``) and
                      measure only the top-k — the FPGA pre-filter the
                      paper motivates with hours-long compilations.
  ExhaustiveSearch    measure a listed (or fully enumerated) candidate set.

``GeneticSearch(seed_from_cost=True)`` seeds its first generation from the
same ranking.  The static pre-filters (legality, resources) run first: a
pruned candidate is never traced.
"""

from __future__ import annotations

import dataclasses
import random
import time
import warnings
from typing import Any, Callable, Iterable, Sequence

from repro_torch.core import verify
from repro_torch.core.planner.cache import MeasurementCache
from repro_torch.core.planner.objectives import Objective, resolve_objective
from repro_torch.core.planner.space import Candidate, SearchSpace


@dataclasses.dataclass
class PlanTrial:
    candidate: Candidate
    pattern: tuple[str, ...]  # axes moved off baseline, sorted
    mapping: dict[str, str]  # axis -> non-baseline choice label
    seconds: float
    compile_seconds: float
    speedup: float  # vs the report's baseline
    cached: bool  # satisfied from the MeasurementCache
    energy_joules: float | None = None  # per call, when a PowerMeter is wired
    energy_provenance: str | None = None  # "measured" | "estimated" | None
    score: float = 0.0  # objective score; lower is better


@dataclasses.dataclass
class PlanReport:
    # the measured baseline candidate; when a strategy skips the baseline
    # (ExhaustiveSearch(include_baseline=False)), this is the first measured
    # trial and all speedups are relative to that reference instead
    baseline_seconds: float
    trials: list[PlanTrial]
    best: PlanTrial
    search_seconds: float
    evaluations: int  # newly measured (non-cached) trials
    strategy: str
    generations: list[float] | None = None  # GA: best speedup per generation
    objective: str = "latency"  # objective that selected ``best``
    pruned: int = 0  # candidates skipped by the static legality pre-filter
    pruned_reasons: dict[str, str] = dataclasses.field(default_factory=dict)

    def trial(self, pattern: Iterable[str]) -> PlanTrial | None:
        key = tuple(sorted(pattern))
        for t in self.trials:
            if t.pattern == key:
                return t
        return None


def to_verification_report(report: PlanReport) -> verify.VerificationReport:
    """Downgrade a PlanReport to the legacy ``verify.VerificationReport``."""
    trials = [
        verify.Trial(t.pattern, t.seconds, t.speedup) for t in report.trials
    ]
    best = verify.Trial(
        report.best.pattern, report.best.seconds, report.best.speedup
    )
    return verify.VerificationReport(
        baseline_seconds=report.baseline_seconds,
        trials=trials,
        best=best,
        search_seconds=report.search_seconds,
    )


def rank_candidates_by_cost(
    space: SearchSpace,
    args: Sequence[Any],
    cost_fn: Callable[[SearchSpace, Candidate, Sequence[Any]], float]
    | None = None,
    skip: Callable[[Candidate], bool] | None = None,
) -> list[tuple[float, Candidate]]:
    """Every non-baseline candidate with its static cost estimate, sorted
    cheapest first.  Unrankable candidates (cost_fn raised) estimate as
    inf and sort last; callers detect a fully failed model by checking
    ``all(est == inf)``.  ``cost_fn`` defaults to the roofline of a fake
    trace.  ``skip`` drops candidates before the (tracing) cost model runs
    — the legality pre-filter seam, so illegal bindings cost nothing."""
    if cost_fn is None:
        from repro_torch.core.planner.cost import make_roofline_cost_fn

        cost_fn = make_roofline_cost_fn()
    baseline = space.baseline()
    ranked: list[tuple[float, Candidate]] = []
    for cand in space.enumerate():
        if cand == baseline:
            continue
        if skip is not None and skip(cand):
            continue
        try:
            est = float(cost_fn(space, cand, args))
        except Exception:  # noqa: BLE001 — unrankable candidate
            est = float("inf")
        ranked.append((est, cand))
    ranked.sort(key=lambda rc: rc[0])
    return ranked


class SearchStrategy:
    name = "base"

    def search(
        self,
        space: SearchSpace,
        args: Sequence[Any],
        cache: MeasurementCache | None = None,
        repeats: int = 3,
        min_seconds: float = 0.0,
        objective: Objective | str | None = None,
    ) -> PlanReport:
        raise NotImplementedError


class _Run:
    """Bookkeeping shared by the concrete strategies: measure via the cache,
    collect unique trials, track baseline and evaluation counts.  All winner
    selection goes through ``objective.score`` (lower is better), never
    directly through ``trial.seconds``."""

    def __init__(
        self,
        space: SearchSpace,
        args: Sequence[Any],
        cache: MeasurementCache,
        repeats: int,
        min_seconds: float,
        objective: Objective | str | None = None,
    ) -> None:
        self.space = space
        self.args = args
        self.cache = cache
        self.repeats = repeats
        self.min_seconds = min_seconds
        self.objective = resolve_objective(objective)
        self.t0 = time.perf_counter()
        self.misses0 = cache.misses
        self.trials: list[PlanTrial] = []
        self._seen: dict[tuple, PlanTrial] = {}
        self.baseline_seconds: float | None = None
        self._pruned: dict[tuple, str] = {}  # canonical -> reason

    def _trial_from(
        self, cand: Candidate, m: verify.Measurement, cached: bool
    ) -> PlanTrial:
        base = self.baseline_seconds
        trial = PlanTrial(
            candidate=tuple(cand),
            pattern=self.space.pattern(cand),
            mapping=self.space.mapping_of(cand),
            seconds=m.seconds,
            compile_seconds=m.compile_seconds,
            speedup=(base / m.seconds) if base else 1.0,
            cached=cached,
            energy_joules=m.energy_joules,
            energy_provenance=m.energy_provenance,
        )
        trial.score = self.objective.score(trial)
        if base is None:
            self.baseline_seconds = m.seconds
            trial.speedup = 1.0
        return trial

    def is_pruned(self, cand: Candidate) -> bool:
        """True when the space's static pre-filter rejects this candidate.
        The baseline is never pruned — every report needs its reference
        measurement, and the un-offloaded program is definitionally legal."""
        cand = tuple(cand)
        if cand == self.space.baseline():
            return False
        key = self.space.canonical(cand)
        if key in self._pruned:
            return True
        reason = self.space.pruned(cand)
        if reason is not None:
            self._pruned[key] = reason
            return True
        return False

    def prune(self, cands: Sequence[Candidate]) -> list[Candidate]:
        """Drop statically-illegal candidates, recording each skip (once
        per canonical pattern) for the report's ``pruned`` count."""
        return [tuple(c) for c in cands if not self.is_pruned(c)]

    def measure(self, cand: Candidate) -> PlanTrial:
        return self.measure_many([cand])[0]

    def measure_many(self, cands: Sequence[Candidate]) -> list[PlanTrial]:
        """Bulk measurement: every not-yet-seen candidate goes to the cache
        (and through its executor) in one batch, so independent trials can
        run concurrently.  Returns one trial per candidate, in order."""
        cands = [tuple(c) for c in cands]
        fresh: list[Candidate] = []
        fresh_keys: set[tuple] = set()
        for cand in cands:
            key = self.cache.key_for(self.space, cand, self.args)
            if key not in self._seen and key not in fresh_keys:
                fresh.append(cand)
                fresh_keys.add(key)
        if fresh:
            measured = self.cache.measure_many(
                self.space,
                fresh,
                self.args,
                repeats=self.repeats,
                min_seconds=self.min_seconds,
            )
            for cand, (m, cached) in zip(fresh, measured):
                key = self.cache.key_for(self.space, cand, self.args)
                trial = self._trial_from(cand, m, cached)
                self._seen[key] = trial
                self.trials.append(trial)
        return [
            self._seen[self.cache.key_for(self.space, c, self.args)]
            for c in cands
        ]

    def seconds_of(self, cand: Candidate) -> float:
        return self.measure(cand).seconds

    def score_of(self, cand: Candidate) -> float:
        """Objective score of a candidate (the strategies' fitness)."""
        return self.measure(cand).score

    def report(self, strategy: str, generations: list[float] | None = None) -> PlanReport:
        best = min(self.trials, key=lambda t: t.score)
        base = self.baseline_seconds or best.seconds
        for t in self.trials:
            t.speedup = base / t.seconds
        return PlanReport(
            baseline_seconds=base,
            trials=self.trials,
            best=best,
            search_seconds=time.perf_counter() - self.t0,
            evaluations=self.cache.misses - self.misses0,
            strategy=strategy,
            generations=generations,
            objective=self.objective.name,
            pruned=len(self._pruned),
            pruned_reasons={
                "+".join(f"{n}={t}" for n, t in key): reason
                for key, reason in self._pruned.items()
            },
        )


class SingleThenCombine(SearchStrategy):
    """Paper §4.2: measure each block offloaded alone, then the combination
    of individually-improving blocks, adopting it only if it beats the best
    single.  For n-ary axes, "alone" means each (axis, choice) pair alone,
    and the combination takes each axis's best improving choice."""

    name = "single_then_combine"

    def search(
        self,
        space: SearchSpace,
        args: Sequence[Any],
        cache: MeasurementCache | None = None,
        repeats: int = 3,
        min_seconds: float = 0.0,
        objective: Objective | str | None = None,
    ) -> PlanReport:
        cache = MeasurementCache() if cache is None else cache
        run = _Run(space, args, cache, repeats, min_seconds, objective)

        baseline = space.baseline()
        base_t = run.measure(baseline)

        # every (axis, choice) measured alone — independent trials, so the
        # whole round goes to the executor as one batch
        singles: list[tuple[int, int, Candidate]] = []
        for i, axis in enumerate(space.axes):
            for c in range(1, len(axis.choices)):
                cand = list(baseline)
                cand[i] = c
                singles.append((i, c, tuple(cand)))
        # statically-illegal bindings are pruned, not timed (paper Step 1)
        singles = [s for s in singles if not run.is_pruned(s[2])]
        trials = run.measure_many([cand for _, _, cand in singles])

        # best improving choice per axis ("improving" by the configured
        # objective, not necessarily by wall time)
        winners: dict[int, int] = {}
        best_scores: dict[int, float] = {}
        for (i, c, _cand), t in zip(singles, trials):
            if t.score < best_scores.get(i, base_t.score):
                best_scores[i] = t.score
                winners[i] = c

        if len(winners) >= 2:
            combo = list(baseline)
            for i, c in winners.items():
                combo[i] = c
            # paper: the combination is adopted only if faster than the best
            # single pattern — run.report picks the global minimum, so a
            # slower combination simply doesn't win
            if not run.is_pruned(tuple(combo)):
                run.measure(tuple(combo))

        return run.report(self.name)


class GeneticSearch(SearchStrategy):
    """Elitist generational GA with tournament selection, single-point
    crossover and per-gene mutation (prior work, paper §3.2).  Genes index
    into each axis's choice list, so the genome is binary on a SubsetSpace
    and n-ary on spaces with more choices per axis.

    With ``seed_from_cost=True`` the initial population is not uniform
    random: candidates are ranked by a static cost model (the roofline by
    default, the ranking CostGuidedSearch measures the top of) and the
    cheapest ones seed generation zero, so the GA starts from the cost
    model's belief instead of noise.
    """

    name = "genetic"

    def __init__(
        self,
        population: int = 8,
        generations: int = 8,
        mutation_rate: float = 0.1,
        elite: int = 2,
        tournament: int = 3,
        seed: int = 0,
        seed_from_cost: bool = False,
        cost_fn: Callable[[SearchSpace, Candidate, Sequence[Any]], float]
        | None = None,
        max_enumeration: int = 1024,
    ) -> None:
        self.population = population
        self.generations = generations
        self.mutation_rate = mutation_rate
        self.elite = elite
        self.tournament = tournament
        self.seed = seed
        self.seed_from_cost = seed_from_cost
        self.cost_fn = cost_fn
        self.max_enumeration = max_enumeration

    def _cost_seeded(
        self, space: SearchSpace, args: Sequence[Any], skip: Callable[[Candidate], bool]
    ) -> list[Candidate]:
        """Initial genomes from the static cost ranking (cheapest first),
        or [] when the space is too large / no candidate is rankable."""
        if space.size() > self.max_enumeration:
            warnings.warn(
                f"seed_from_cost: space has {space.size()} candidates "
                f"(> max_enumeration={self.max_enumeration}); seeding "
                "randomly instead",
                stacklevel=2,
            )
            return []
        ranked = rank_candidates_by_cost(space, args, self.cost_fn, skip=skip)
        if not ranked or all(est == float("inf") for est, _ in ranked):
            warnings.warn(
                "seed_from_cost: cost model failed on every candidate; "
                "seeding randomly instead",
                stacklevel=2,
            )
            return []
        # baseline always participates so the GA can report "don't offload"
        seeds = [space.baseline()]
        seeds.extend(c for _, c in ranked[: max(self.population - 1, 1)])
        return seeds[: self.population]

    def _mutate_gene(
        self, rng: random.Random, axis_card: int, gene: int
    ) -> int:
        if axis_card <= 1:
            return gene
        if axis_card == 2:
            return 1 - gene
        other = rng.randrange(axis_card - 1)
        return other + 1 if other >= gene else other

    def search(
        self,
        space: SearchSpace,
        args: Sequence[Any],
        cache: MeasurementCache | None = None,
        repeats: int = 3,
        min_seconds: float = 0.0,
        objective: Objective | str | None = None,
    ) -> PlanReport:
        cache = MeasurementCache() if cache is None else cache
        run = _Run(space, args, cache, repeats, min_seconds, objective)
        rng = random.Random(self.seed)
        cards = [len(a.choices) for a in space.axes]
        n_genes = len(cards)

        run.measure(space.baseline())

        def fitness(cand: Candidate) -> float:
            # pruned genomes survive in the pool (their genes may recombine
            # into legal children) but are never measured and never win
            if run.is_pruned(cand):
                return float("inf")
            return run.score_of(cand)

        pop: list[Candidate] = []
        if self.seed_from_cost:
            pop = self._cost_seeded(space, args, run.is_pruned)
        guard = 0
        while len(pop) < self.population and guard < self.population * 50:
            g = tuple(rng.randrange(c) for c in cards)
            if g not in pop:
                pop.append(g)
            guard += 1

        history: list[float] = []
        base = run.baseline_seconds or 1.0
        for _gen in range(self.generations):
            # measure the whole generation as one batch (the executor may
            # run its members concurrently); fitness below replays from
            # the per-run trial table.  Pruned members are skipped here.
            run.measure_many(run.prune(pop))
            scored = sorted(pop, key=fitness)
            # Fig. 4 curve stays a *speedup* (time ratio) regardless of the
            # objective that ranks the population
            legal_best = next(
                (c for c in scored if not run.is_pruned(c)), space.baseline()
            )
            history.append(base / run.measure(legal_best).seconds)
            nxt: list[Candidate] = scored[: self.elite]
            while len(nxt) < self.population:

                def pick() -> Candidate:
                    cand = [
                        pop[rng.randrange(len(pop))]
                        for _ in range(self.tournament)
                    ]
                    return min(cand, key=fitness)

                a, b = pick(), pick()
                if n_genes > 1:
                    cut = rng.randrange(1, n_genes)
                    child = a[:cut] + b[cut:]
                else:
                    child = a
                child = tuple(
                    self._mutate_gene(rng, card, gene)
                    if rng.random() < self.mutation_rate
                    else gene
                    for card, gene in zip(cards, child)
                )
                nxt.append(child)
            pop = nxt

        return run.report(self.name, generations=history)


class ExhaustiveSearch(SearchStrategy):
    """Measure every candidate in a listed set (or the whole space).

    With ``include_baseline=False`` the report's baseline (and therefore
    every speedup) is the first listed candidate, not the space baseline —
    fine for picking a winner, misleading if the report is persisted as a
    Plan whose speedup readers take as "vs un-offloaded".
    """

    name = "exhaustive"

    def __init__(
        self,
        candidates: Sequence[Candidate] | None = None,
        include_baseline: bool = True,
        max_enumeration: int = 4096,
    ) -> None:
        self.candidates = candidates
        self.include_baseline = include_baseline
        self.max_enumeration = max_enumeration

    def search(
        self,
        space: SearchSpace,
        args: Sequence[Any],
        cache: MeasurementCache | None = None,
        repeats: int = 3,
        min_seconds: float = 0.0,
        objective: Objective | str | None = None,
    ) -> PlanReport:
        cache = MeasurementCache() if cache is None else cache
        run = _Run(space, args, cache, repeats, min_seconds, objective)
        if self.candidates is not None:
            cands = list(self.candidates)
        else:
            if space.size() > self.max_enumeration:
                raise ValueError(
                    f"space has {space.size()} candidates; pass an explicit "
                    f"candidate list or raise max_enumeration"
                )
            cands = list(space.enumerate())
        if self.include_baseline:
            run.measure(space.baseline())
        run.measure_many(run.prune(cands))
        return run.report(self.name)


class CostGuidedSearch(SearchStrategy):
    """Rank candidates by a static cost model, measure only the top-k.

    The paper motivates this for FPGA: a single candidate compilation takes
    hours, so candidates are narrowed by arithmetic intensity *before* any
    measurement.  ``cost_fn(space, candidate, args) -> estimated seconds``
    defaults to the roofline of the candidate's fake trace
    (``planner.cost``: nothing is launched); candidates whose cost cannot be
    estimated rank last, and if no candidate can be ranked the strategy
    degrades to exhaustive measurement with a warning.
    """

    name = "cost_guided"

    def __init__(
        self,
        top_k: int = 4,
        cost_fn: Callable[[SearchSpace, Candidate, Sequence[Any]], float]
        | None = None,
        max_enumeration: int = 1024,
    ) -> None:
        self.top_k = top_k
        self.cost_fn = cost_fn
        self.max_enumeration = max_enumeration

    def search(
        self,
        space: SearchSpace,
        args: Sequence[Any],
        cache: MeasurementCache | None = None,
        repeats: int = 3,
        min_seconds: float = 0.0,
        objective: Objective | str | None = None,
    ) -> PlanReport:
        cache = MeasurementCache() if cache is None else cache
        run = _Run(space, args, cache, repeats, min_seconds, objective)

        if space.size() > self.max_enumeration:
            raise ValueError(
                f"space has {space.size()} candidates; CostGuidedSearch "
                f"enumerates the space — raise max_enumeration or shrink it"
            )
        # legality-pruned candidates are skipped before the cost model even
        # traces them: an illegal binding may not trace at all
        ranked = rank_candidates_by_cost(
            space, args, self.cost_fn, skip=run.is_pruned
        )

        run.measure(space.baseline())
        if ranked and all(est == float("inf") for est, _ in ranked):
            warnings.warn(
                "CostGuidedSearch: cost model failed on every candidate; "
                "falling back to exhaustive measurement",
                stacklevel=2,
            )
            chosen = [cand for _, cand in ranked]
        else:
            chosen = [cand for _, cand in ranked[: max(self.top_k, 1)]]
        run.measure_many(chosen)
        return run.report(self.name)
