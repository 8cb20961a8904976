"""OffloadSession — one lifecycle for every offload path (the port of
``repro/offload/session.py``: the application and space modes).

The paper's pipeline is a single flow: analyze the application, discover
offloadable function blocks, search candidate patterns in a verification
environment, verify the winner, deploy it.  Historically this repo exposed
that flow as three unrelated APIs (``OffloadEngine.adapt`` returning an
``AdaptedApp``, ``measure_block_pattern`` returning a bare tuple, and
``launch/plans.py`` hand-rolling plan loading).  ``OffloadSession`` subsumes
all of them behind explicit stages::

    session = OffloadSession(app_fn, args=(x,), objective=PerfPerWatt())
    session.analyze()    # Step 1: source / axis structure
    session.discover()   # Step 2: offloadable blocks -> SearchSpace
    session.plan()       # Step 3: store-first measured search
    session.verify()     # numerics check of the winner
    result = session.commit()   # persist + build the deployable callable

or, in one call, ``result = session.run()``.  Stages must run in order —
calling one before its prerequisite raises ``StageError`` — so "measured
before analyzed" bugs fail loudly instead of silently measuring the wrong
thing.

Two kinds of target are accepted:

* an **application callable** (the paper's existing-app path): Steps 1-2 run
  through an ``OffloadEngine`` and the search space is a ``SubsetSpace`` of
  source-substituted variants, whose replacement blocks run on ``device``
  (the CUDA card unless the caller passes ``device="cpu"``);
* a **SearchSpace** (power users, pre-built spaces).

Not ported yet (``NotImplementedError``): the binding mode over a step
builder (``patterns=`` / ``blocks=``), the legality and resource
pre-filters, tracing spans and ``plan_zoo``.  Trials are timed by the
``MeasurementCache``'s serial executor; the reference's ``meter=`` and
``executor=`` session options come with the parallel executors and the
power meters.  The reference's zero-search ``attach`` / ``stored_binding``
bind registry targets, which only the binding mode produces; they come
with it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

from repro_torch.core import verify as verify_mod
from repro_torch.core.planner import (
    MeasurementCache,
    Objective,
    Plan,
    Planner,
    PlanReport,
    PlanStore,
    SearchSpace,
    SearchStrategy,
    SingleThenCombine,
    resolve_objective,
)
from repro_torch.core.planner.strategies import to_verification_report


class StageError(RuntimeError):
    """A lifecycle stage was invoked before its prerequisite stage."""


@dataclasses.dataclass
class OffloadResult:
    """The one result type for every offload path.

    Replaces ``AdaptedApp`` (engine path) and the bare ``(best, results)``
    tuples (binding path): the chosen pattern, the per-candidate trials with
    their objective scores, the persisted ``Plan``, and the deployable
    callable.
    """

    plan: Plan
    report: PlanReport | None  # None when the plan came from the store
    mapping: dict[str, str]
    pattern: tuple[str, ...]
    objective: str
    fn: Callable[..., Any] | None
    numerics_ok: bool | None  # None when the verify stage was skipped
    discoveries: list[Any] | None  # engine path only
    skipped: list[Any] | None  # engine path only
    from_store: bool

    @property
    def trials(self) -> list[Any]:
        return [] if self.report is None else self.report.trials

    @property
    def baseline_seconds(self) -> float:
        return self.plan.baseline_seconds

    @property
    def best_seconds(self) -> float:
        return self.plan.best_seconds

    @property
    def speedup(self) -> float:
        return self.plan.speedup

    @property
    def verification(self) -> verify_mod.VerificationReport:
        """Legacy ``VerificationReport`` view (AdaptedApp compatibility)."""
        if self.report is not None:
            return to_verification_report(self.report)
        best = verify_mod.Trial(
            self.plan.pattern, self.plan.best_seconds, self.plan.speedup
        )
        return verify_mod.VerificationReport(
            baseline_seconds=self.plan.baseline_seconds,
            trials=[best],
            best=best,
            search_seconds=0.0,
        )


class OffloadSession:
    """One offload lifecycle: analyze -> discover -> plan -> verify -> commit."""

    def __init__(
        self,
        target: Callable[..., Any] | SearchSpace,
        *,
        args: Sequence[Any] = (),
        objective: Objective | str | None = None,
        strategy: SearchStrategy | None = None,
        store: PlanStore | str | None = None,
        key: str | None = None,
        cache: MeasurementCache | None = None,
        engine: Any = None,
        patterns: Sequence[Mapping[str, str]] | None = None,
        blocks: Mapping[str, Sequence[str]] | None = None,
        repeats: int = 3,
        min_seconds: float = 0.0,
        rtol: float = 1e-3,
        force_search: bool = False,
        legality: bool = False,
        resources: Any = False,
        resource_hints: Mapping[tuple[str, str], Any] | None = None,
        tracer: Any = None,
        device: Any = None,
    ) -> None:
        unported = {
            "patterns": patterns is not None, "blocks": blocks is not None,
            "legality": bool(legality), "resources": resources not in (False, None),
            "resource_hints": resource_hints is not None, "tracer": tracer is not None,
        }
        asked = sorted(k for k, v in unported.items() if v)
        if asked:
            raise NotImplementedError(
                f"OffloadSession options {asked} are not ported yet"
            )
        self.target = target
        self.device = device
        self.args = tuple(args)
        self.objective = resolve_objective(objective)
        self.strategy = strategy or SingleThenCombine()
        self.store = PlanStore(store) if isinstance(store, str) else store
        self.key = key
        self.cache = cache if cache is not None else MeasurementCache()
        self.repeats = repeats
        self.min_seconds = min_seconds
        self.rtol = rtol
        self.force_search = force_search
        self._engine = engine

        if isinstance(target, SearchSpace):
            self.mode = "space"
            self._space: SearchSpace | None = target
        elif callable(target):
            self.mode = "app"
            self._space = None
        else:
            raise TypeError(
                f"target must be a callable or a SearchSpace, got "
                f"{type(target).__name__}"
            )

        self._done: set[str] = set()
        self._analysis: Any = None
        self._discoveries: list[Any] | None = None
        self._skipped: list[Any] | None = None
        self._plan: Plan | None = None
        self._report: PlanReport | None = None
        self._from_store = False
        self._numerics_ok: bool | None = None
        self._built_fn: Callable[..., Any] | None = None

    # -- stage machinery -------------------------------------------------------
    def _require(self, stage: str, prerequisite: str) -> None:
        if prerequisite not in self._done:
            raise StageError(
                f"OffloadSession.{stage}() called before "
                f"{prerequisite}() — stages run in order "
                "analyze -> discover -> plan -> [verify] -> commit"
            )

    @property
    def space(self) -> SearchSpace:
        if self._space is None:
            raise StageError(
                "search space not built yet — run discover() first"
            )
        return self._space

    # -- Step 1 ----------------------------------------------------------------
    def analyze(self) -> Any:
        """Grasp the target's structure.

        App mode: AST source analysis (library calls, local defs, loops)
        via the engine.  Space mode: the axis structure — every searchable
        position and its registered choices.
        """
        if self.mode == "app":
            self._analysis = self._get_engine().analyze(self.target)
        else:  # space
            self._analysis = {a.name: a.choices for a in self.space.axes}
        self._done.add("analyze")
        return self._analysis

    def _get_engine(self) -> Any:
        if self._engine is None:
            from repro_torch.core.engine import OffloadEngine

            self._engine = OffloadEngine(device=self.device)
        return self._engine

    # -- Step 2 ----------------------------------------------------------------
    def discover(self) -> list[Any]:
        """Find what can move.

        App mode: DB name matching + similarity discovery, interface
        reconciliation, and construction of the ``SubsetSpace`` of
        source-substituted variants.  Space mode: the axes with more than
        one choice.
        """
        self._require("discover", "analyze")
        if self.mode == "app":
            prepared = self._get_engine().prepare(
                self.target, self.args, report=self._analysis
            )
            self._space = prepared.space
            self._discoveries = prepared.discoveries
            self._skipped = prepared.skipped
            found: list[Any] = prepared.discoveries
        else:
            found = [a.name for a in self.space.axes if len(a.choices) > 1]
        self._done.add("discover")
        return found

    # -- Step 3 ----------------------------------------------------------------
    def plan(self) -> Plan:
        """Store-first measured search: a compatible stored plan (same
        space signature, same objective) short-cuts to zero measurements,
        otherwise the strategy searches the space and ranks candidates
        with the session objective.

        One plan-lifecycle policy exists — ``Planner.plan`` — and this
        stage delegates to it; persistence is deferred to ``commit``.
        """
        self._require("plan", "discover")
        planner = Planner(
            self.space,
            strategy=self.strategy,
            cache=self.cache,
            store=self.store,
            objective=self.objective,
        )
        self._plan, self._report = planner.plan(
            self.args,
            key=self.key,
            repeats=self.repeats,
            min_seconds=self.min_seconds,
            force_search=self.force_search,
            save=False,  # the commit stage persists
        )
        self._from_store = self._report is None
        self._done.add("plan")
        return self._plan

    # -- verification ----------------------------------------------------------
    def verify(self) -> bool:
        """Functional check: the winning pattern must reproduce the baseline
        results (within ``rtol``) before it may be deployed."""
        self._require("verify", "plan")
        plan = self._plan
        assert plan is not None
        if not plan.mapping:  # winner is baseline: trivially faithful
            self._numerics_ok = True
        else:
            best_fn = self._winning_fn()
            if self.mode == "app":
                reference: Callable[..., Any] = self.target  # type: ignore[assignment]
            else:
                reference = self.space.build(self.space.baseline())
            self._numerics_ok = verify_mod.verify_numerics(
                reference, best_fn, self.args,
                rtol=self.rtol, atol=self.rtol,
            )
        self._done.add("verify")
        return bool(self._numerics_ok)

    def _winning_fn(self) -> Callable[..., Any]:
        """Build the winning variant once; verify and commit share it."""
        if self._built_fn is None:
            assert self._plan is not None
            cand = self.space.candidate_from_mapping(self._plan.mapping)
            self._built_fn = self.space.build(cand)
        return self._built_fn

    # -- deployment ------------------------------------------------------------
    def commit(self, build: bool = True) -> OffloadResult:
        """Persist the plan (when a store+key are configured) and build the
        deployable callable for the winning pattern.

        A plan whose verify stage FAILED numerics is never persisted —
        ``attach`` would otherwise bind a numerically-wrong pattern in
        production with zero re-verification.  ``build=False`` skips
        constructing the callable (measurement-only callers that consume
        just the trials; ``result.fn`` is then None).
        """
        self._require("commit", "plan")
        plan = self._plan
        assert plan is not None
        if (
            self.store is not None
            and self.key is not None
            and not self._from_store
            and self._numerics_ok is not False
        ):
            self.store.save(plan)
        fn: Callable[..., Any] | None
        if not build:
            fn = None
        elif plan.mapping or self.mode != "app":
            fn = self._winning_fn()
        else:
            fn = self.target  # type: ignore[assignment]
        self._done.add("commit")
        return OffloadResult(
            plan=plan,
            report=self._report,
            mapping=dict(plan.mapping),
            pattern=tuple(plan.pattern),
            objective=plan.objective,
            fn=fn,
            numerics_ok=self._numerics_ok,
            discoveries=self._discoveries,
            skipped=self._skipped,
            from_store=self._from_store,
        )

    def run(self, verify: bool = True, build: bool = True) -> OffloadResult:
        """The whole lifecycle in order.  ``verify=False`` skips the
        numerics stage and ``build=False`` the deployable callable
        (measurement-only callers, e.g. binding sweeps)."""
        self.analyze()
        self.discover()
        self.plan()
        if verify:
            self.verify()
        return self.commit(build=build)

    # -- zoo-wide planning ------------------------------------------------------
    @classmethod
    def plan_zoo(cls, *args: Any, **kwargs: Any):
        """The reference's zoo-wide binding sweep: not ported yet."""
        raise NotImplementedError("OffloadSession.plan_zoo is not ported yet")
