"""Planner — store-first search orchestration (the port of
``repro/core/planner/planner.py``).

``Planner.plan`` is the one entry point every search path routes through:
check the PlanStore for a previously verified plan (zero measurements on
hit), otherwise run the configured SearchStrategy over the SearchSpace via
the shared MeasurementCache, persist the winner, and return it.
"""

from __future__ import annotations

from typing import Any, Sequence

from repro_torch.core.planner.cache import MeasurementCache
from repro_torch.core.planner.objectives import Objective, resolve_objective
from repro_torch.core.planner.space import SearchSpace
from repro_torch.core.planner.store import Plan, PlanStore, plan_from_report
from repro_torch.core.planner.strategies import (
    PlanReport,
    SearchStrategy,
    SingleThenCombine,
)


def plan_compatible(space: SearchSpace, plan: Plan) -> bool:
    """A stored plan is usable when every chosen (axis, target) still
    exists in the space being planned over."""
    by_name = {a.name: a for a in space.axes}
    for name, label in plan.mapping.items():
        axis = by_name.get(name)
        if axis is None or label not in axis.choices:
            return False
    return True


def declared_pattern(
    environment: str,
    blocks: Sequence[str] | None = None,
    registry: Any = None,
) -> dict[str, str]:
    """Declared-environment binding selection (the dry-run case: no machine
    to measure on, only a target environment declaration).

    environment: "cpu" -> prefer the plain torch formulations; "cuda" ->
    prefer the hand-written kernels where registered (the reference's
    "tpu" -> Pallas).
    """
    if registry is None:
        from repro_torch.core.blocks import registry as registry_mod

        registry = registry_mod
    pattern: dict[str, str] = {}
    names = blocks if blocks is not None else registry.blocks()
    for b in names:
        targets = registry.targets(b)
        if environment == "cuda" and "cuda" in targets:
            pattern[b] = "cuda"
        elif "torch" in targets:
            pattern[b] = "torch"
        elif targets:
            pattern[b] = targets[0]
    return pattern


class Planner:
    def __init__(
        self,
        space: SearchSpace,
        strategy: SearchStrategy | None = None,
        cache: MeasurementCache | None = None,
        store: PlanStore | None = None,
        objective: "Objective | str | None" = None,
    ) -> None:
        self.space = space
        self.strategy = strategy or SingleThenCombine()
        self.cache = MeasurementCache() if cache is None else cache
        self.store = store
        self.objective = objective

    def _compatible(self, plan: Plan) -> bool:
        return plan_compatible(self.space, plan)

    def plan(
        self,
        args: Sequence[Any],
        key: str | None = None,
        repeats: int = 3,
        min_seconds: float = 0.0,
        force_search: bool = False,
        save: bool = True,
    ) -> tuple[Plan, PlanReport | None]:
        """Return ``(plan, report)``.

        ``report`` is None when the plan came straight from the store —
        the zero-measurement production path.  ``save=False`` defers
        persistence to the caller (the session persists at its commit
        stage, not its plan stage).
        """
        if self.store is not None and key is not None and not force_search:
            cached = self.store.load(key)
            # a stored plan only short-cuts the search when it answers the
            # same question: same space (axes AND workload tag, via the
            # signature) ranked by the same objective — otherwise a
            # latency-selected plan would silently satisfy a PerfPerWatt
            # caller, or a plan searched over one workload would silently
            # satisfy a session planning a different one
            if (
                cached is not None
                and self._compatible(cached)
                and cached.space == self.space.signature()
                and cached.objective == resolve_objective(self.objective).name
            ):
                return cached, None
        report = self.strategy.search(
            self.space,
            args,
            cache=self.cache,
            repeats=repeats,
            min_seconds=min_seconds,
            objective=self.objective,
        )
        plan = plan_from_report(
            key or self.space.signature(), self.space.signature(), report
        )
        # the deployable binding may pin more axes than the offload pattern
        plan.mapping = dict(self.space.deploy_mapping(report.best.candidate))
        if save and self.store is not None and key is not None:
            self.store.save(plan)
        return plan, report
