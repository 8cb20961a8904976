"""Planner — the unified offload-pattern search subsystem (the port of
``repro/core/planner``).

  SearchSpace   *what* is being searched.  ``SubsetSpace`` is the paper's
                binary offload-or-not choice per discovered block;
                ``BindingSpace`` generalises the GPU-vs-FPGA destination
                choice to an n-ary choice among registered targets
                ({ref, torch, cuda}) per function block.
  SearchStrategy  *how* the space is explored.  ``SingleThenCombine`` is the
                paper's Step-3 procedure (§4.2); ``GeneticSearch`` is the
                prior-work GA (``seed_from_cost=True`` seeds it from the
                cost model); ``CostGuidedSearch`` ranks candidates with
                the roofline of their fake traces (``planner.cost`` on
                ``launch/graph_cost.py``) and measures only the top-k;
                ``ExhaustiveSearch`` measures a listed set.
  Objective     *what "best" means*: ``Latency`` (the paper's
                wall-seconds), ``PerfPerWatt``, ``WeightedCost``.
  MeasurementCache  shared memoisation keyed by canonical pattern, so no
                strategy ever re-measures a visited pattern.
  PlanStore     persistent JSON plans keyed by name + environment
                fingerprint.

``Planner`` ties them together: check the store, otherwise search, then
persist the winner; ``declared_pattern`` picks a binding for a declared
environment without measuring.  The timed work runs through a pluggable
``repro_torch.metering`` executor (serial / device-parallel / batched) under
an optional power meter.
"""

from repro_torch.core.planner.cache import MeasurementCache  # noqa: F401
from repro_torch.core.planner.cost import make_roofline_cost_fn, roofline_seconds  # noqa: F401
from repro_torch.core.planner.objectives import (  # noqa: F401
    DEFAULT_DEVICE_WATTS,
    Latency,
    Objective,
    PerfPerWatt,
    PowerMeter,
    TimeProportionalPower,
    WeightedCost,
    resolve_objective,
)
from repro_torch.core.planner.planner import (  # noqa: F401
    Planner,
    declared_pattern,
    plan_compatible,
)
from repro_torch.core.planner.space import (  # noqa: F401
    DEFAULT_TARGET,
    Axis,
    BindingSpace,
    Candidate,
    SearchSpace,
    SubsetSpace,
)
from repro_torch.core.planner.store import (  # noqa: F401
    Plan,
    PlanStore,
    environment_fingerprint,
)
from repro_torch.core.planner.strategies import (  # noqa: F401
    CostGuidedSearch,
    ExhaustiveSearch,
    GeneticSearch,
    PlanReport,
    PlanTrial,
    SearchStrategy,
    SingleThenCombine,
    rank_candidates_by_cost,
    to_verification_report,
)
