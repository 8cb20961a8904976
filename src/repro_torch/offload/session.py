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

Three kinds of target are accepted:

* an **application callable** (the paper's existing-app path): Steps 1-2 run
  through an ``OffloadEngine`` and the search space is a ``SubsetSpace`` of
  source-substituted variants, whose replacement blocks run on ``device``
  (the CUDA card unless the caller passes ``device="cpu"``);
* a **SearchSpace** (power users, pre-built spaces);
* a **step builder** plus ``patterns=`` or ``blocks=`` (the framework-native
  model-zoo path): the space is a ``BindingSpace`` over registered targets.

Production startup never runs a session at all — ``OffloadSession.attach``
binds a previously committed plan with zero search or measurement, and
``plan_zoo`` (:mod:`repro_torch.offload.zoo`) commits one per model cell.

``meter=`` (a ``PowerMeter`` or a name ``repro_torch.metering.resolve_meter``
takes, e.g. ``"nvml"``) meters every trial, and ``executor=`` picks how the
``MeasurementCache`` times them (serial, device-parallel or batched).
``legality=`` and ``resources=`` run the ``repro_torch.analysis``
pre-filters in ``discover`` on a ``BindingSpace`` (as the reference, not on
an application's ``SubsetSpace``), so the search prunes the bindings that
cannot run or cannot fit before timing any; ``tracer=`` records one
``stage:<name>`` span per stage.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Mapping, Sequence

from repro_torch.core import blocks as blocks_mod
from repro_torch.core import verify as verify_mod
from repro_torch.core.planner import (
    BindingSpace,
    MeasurementCache,
    Objective,
    Plan,
    Planner,
    PlanReport,
    PlanStore,
    SearchSpace,
    SearchStrategy,
    SingleThenCombine,
    declared_pattern,  # noqa: F401 — re-exported lifecycle helper
    resolve_objective,
)
from repro_torch.core.planner.strategies import to_verification_report
from repro_torch.metering import resolve_executor, resolve_meter


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

    def binding_context(self, registry: Any = None):
        """Context manager entering this result's block->target binding."""
        registry = registry or blocks_mod.registry
        return registry.bind(self.mapping)


def stored_binding(
    plan_dir: str,
    key: str,
    match_fingerprint: bool = True,
    registry: Any = None,
) -> dict[str, str] | None:
    """Fetch a committed plan's block->target mapping, or None when no plan
    (or a plan verified under a different environment) is available.

    The mapping is validated against the current block registry: a plan
    naming a block or target that no longer exists (kernel removed or
    renamed since the plan was verified) is treated as incompatible rather
    than binding something that would KeyError mid-step.
    """
    if registry is None:
        registry = blocks_mod.registry
    plan = PlanStore(plan_dir).load(key, match_fingerprint=match_fingerprint)
    if plan is None:
        return None
    mapping = dict(plan.mapping)
    for block, target in mapping.items():
        if target not in registry.targets(block):
            return None
    return mapping


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
        meter: Any = None,
        executor: Any = None,
        engine: Any = None,
        registry: Any = None,
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
        #: ``repro_torch.obs.Tracer`` carrying one "stage:<name>" span per
        #: lifecycle stage (defaults to the process tracer, disabled
        #: unless someone turned it on)
        self.tracer = tracer
        self.target = target
        self.device = device
        self.args = tuple(args)
        self.objective = resolve_objective(objective)
        self.strategy = strategy or SingleThenCombine()
        self.store = PlanStore(store) if isinstance(store, str) else store
        self.key = key
        meter = resolve_meter(meter)
        self._owns_cache = cache is None
        if cache is None:
            cache = MeasurementCache(meter=meter, executor=executor)
        else:
            if meter is not None:
                if cache.meter is not None and cache.meter is not meter:
                    raise ValueError(
                        "the shared MeasurementCache already carries a "
                        "different PowerMeter; wire the meter into the cache "
                        "itself (MeasurementCache(meter=...)) or give this "
                        "session its own cache"
                    )
                cache.meter = meter
            if executor is not None:
                self._set_cache_executor(cache, executor)
        self.cache = cache
        self.registry = registry or blocks_mod.registry
        self.repeats = repeats
        self.min_seconds = min_seconds
        self.rtol = rtol
        self.force_search = force_search
        self.legality = legality
        self.legality_report: Any = None
        #: Memory-envelope pre-filter (paper Step 5): False = off; True /
        #: "host" = probe the session's device; a name = STATIC_ENVELOPES
        #: entry; or a DeviceEnvelope.  Statically-OOM bindings are pruned
        #: like illegal ones, with "memory:"-tagged reasons.
        self.resources = resources
        self.resource_hints = resource_hints
        self.resources_report: Any = None
        self._engine = engine
        self._patterns = patterns
        self._blocks = blocks

        if isinstance(target, SearchSpace):
            self.mode = "space"
            self._space: SearchSpace | None = target
        elif patterns is not None or blocks is not None:
            if not callable(target):
                raise TypeError(
                    "binding mode needs a zero-arg step builder as target"
                )
            self.mode = "binding"
            self._space = None
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

    def _set_cache_executor(self, cache: MeasurementCache, executor: Any) -> None:
        """Install an executor on a *shared* cache, refusing to silently
        displace a different one another session relies on (mirrors the
        PowerMeter conflict guard above)."""
        executor = resolve_executor(executor)
        current = cache.executor
        # equivalent configuration counts as the same executor: two
        # resolve_executor("serial") calls yield distinct-but-equal
        # instances and must not be treated as a conflict
        same = current is None or current is executor or (
            type(current) is type(executor)
            and current.__dict__ == executor.__dict__
        )
        if not same:
            raise ValueError(
                "the shared MeasurementCache already carries a different "
                "executor; wire the executor into the cache itself "
                "(MeasurementCache(executor=...)) or give this session "
                "its own cache"
            )
        cache.executor = executor

    # -- stage machinery -------------------------------------------------------
    def _stage_span(self, stage: str, **args: Any):
        """Context manager spanning one lifecycle stage on the session's
        tracer (or the process tracer) — no-op when tracing is off."""
        from repro_torch.obs import get_tracer

        tracer = self.tracer if self.tracer is not None else get_tracer()
        if not tracer.enabled:
            return contextlib.nullcontext()
        return tracer.span(f"stage:{stage}", mode=self.mode, **args)

    def _analysis_device(self) -> Any:
        """The device the pre-filters judge for: the session's, else the
        first tensor argument's, else the card."""
        import torch
        from torch.utils._pytree import tree_leaves

        if self.device is not None:
            return torch.device(self.device)
        for leaf in tree_leaves(self.args):
            if isinstance(leaf, torch.Tensor):
                return leaf.device
        return torch.device("cuda")

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
        via the engine.  Space/binding modes: the axis structure — every
        searchable position and its registered choices.
        """
        with self._stage_span("analyze"):
            if self.mode == "app":
                self._analysis = self._get_engine().analyze(self.target)
            elif self.mode == "binding":
                space = BindingSpace(
                    self.target,
                    blocks=self._blocks,
                    registry=self.registry,
                ) if self._patterns is None else BindingSpace.from_patterns(
                    self.target, self._patterns, registry=self.registry
                )
                self._space = space
                self._analysis = {a.name: a.choices for a in space.axes}
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
        source-substituted variants.  Space/binding modes: the axes with
        more than one choice.

        With ``legality=True`` (and a ``BindingSpace``) the
        ``repro_torch.analysis`` legality pass then classifies every
        (block, target) choice and marks the illegal ones on the space, so
        the plan stage's strategy prunes them instead of measuring — the
        paper's static pre-filter, run before any timing is spent.  With
        ``resources`` the memory-envelope pass marks the bindings that
        cannot fit.  Both judge for the session's device (a ``cuda`` target
        is illegal on the CPU).
        """
        self._require("discover", "analyze")
        with self._stage_span("discover"):
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
            if self.legality and isinstance(self._space, BindingSpace):
                from repro_torch.analysis.legality import check_binding_space

                report = check_binding_space(self._space, self.args,
                                             device=self._analysis_device())
                self._space.mark_illegal(report.illegal)
                self.legality_report = report
            if self.resources not in (False, None) and isinstance(self._space, BindingSpace):
                from repro_torch.analysis.resources import check_binding_space_resources

                rreport = check_binding_space_resources(
                    self._space, self.args, envelope=self.resources,
                    hints=self.resource_hints, device=self._analysis_device(),
                )
                self._space.mark_illegal(rreport.oom)
                self.resources_report = rreport
            self._done.add("discover")
        return found

    # -- Step 3 ----------------------------------------------------------------
    def plan(self, executor: Any = None) -> Plan:
        """Store-first measured search: a compatible stored plan (same
        space signature, same objective) short-cuts to zero measurements,
        otherwise the strategy searches the space and ranks candidates
        with the session objective.

        ``executor`` (a ``repro_torch.metering`` executor instance or name)
        overrides how this search's trials are timed — e.g.
        ``plan(executor="batched")`` fuses short variants into one timed
        window.

        One plan-lifecycle policy exists — ``Planner.plan`` — and this
        stage delegates to it; persistence is deferred to ``commit``.
        """
        self._require("plan", "discover")
        if executor is not None:
            if self._owns_cache:
                self.cache.executor = executor
            else:
                self._set_cache_executor(self.cache, executor)
        with self._stage_span("plan", key=self.key):
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
        with self._stage_span("verify"):
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
        with self._stage_span("commit", key=self.key):
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

    # -- production attach (zero search) ---------------------------------------
    @classmethod
    def attach(
        cls,
        plan_dir: str | None,
        key: str | None,
        registry: Any = None,
        quiet: bool = False,
    ):
        """Binding context for a previously committed plan: the zero-search
        production path.

        A no-op context when unset or when the plan is missing/incompatible
        (default bindings then apply)."""
        def say(msg: str) -> None:
            if not quiet:
                print(msg)

        if not plan_dir or not key:
            if plan_dir or key:
                say(
                    "offload plan ignored: both a plan dir and a plan key "
                    f"are required (got plan_dir={plan_dir!r}, "
                    f"plan_key={key!r})"
                )
            return contextlib.nullcontext()
        mapping = stored_binding(plan_dir, key, registry=registry)
        if mapping is None:
            say(
                f"plan '{key}' not found/compatible in {plan_dir}; "
                "running with default bindings"
            )
            return contextlib.nullcontext()
        say(f"bound offload plan '{key}': {mapping} (no re-measurement)")
        registry = registry or blocks_mod.registry
        return registry.bind(mapping)

    # -- zoo-wide planning ------------------------------------------------------
    @classmethod
    def plan_zoo(cls, *args: Any, **kwargs: Any):
        """Search a BindingSpace over real prefill/decode step programs for
        every requested (arch, kind) cell and persist a plan per cell.  See
        ``repro_torch.offload.zoo.plan_zoo`` for parameters."""
        from repro_torch.offload.zoo import plan_zoo

        return plan_zoo(*args, **kwargs)
