"""Core: automatic function-block offloading (the paper's contribution) —
the port of ``repro/core``.

Public API:
    OffloadEngine      Steps 1-3 for existing applications
    CodePatternDB      the replacement registry (B-1/B-2)
    default_db         the stock DB with the CUDA kernel shelf
    blocks             framework-native FunctionBlock registry
    planner            pattern-search subsystem (spaces, strategies,
                       MeasurementCache, persistent PlanStore)
    run_ga             prior-work loop-offload GA baseline (shim over
                       planner.GeneticSearch)
"""

from repro_torch.core import blocks, planner  # noqa: F401
from repro_torch.core.engine import AdaptedApp, Discovery, OffloadEngine  # noqa: F401
from repro_torch.core.ga import GAReport, run_ga  # noqa: F401
from repro_torch.core.interface import (  # noqa: F401
    InterfaceMismatch,
    InterfaceSpec,
    Param,
    Policy,
    match_interfaces,
)
from repro_torch.core.planner import (  # noqa: F401
    CostGuidedSearch,
    ExhaustiveSearch,
    GeneticSearch,
    MeasurementCache,
    Plan,
    Planner,
    PlanStore,
    SingleThenCombine,
    SubsetSpace,
)
from repro_torch.core.pattern_db import (  # noqa: F401
    CodePatternDB,
    ReplacementEntry,
    default_db,
)
from repro_torch.core.verify import (  # noqa: F401
    VerificationReport,
    measure,
    verify_numerics,
)
