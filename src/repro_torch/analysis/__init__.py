"""repro_torch.analysis — static analysis over traced programs (paper
Step 1; the port of ``repro.analysis``).

Four passes, each producing typed :class:`~repro_torch.analysis.Diagnostic`s:

* **legality** (``repro_torch.analysis.legality``) — classify every
  shelf-block (block, target) binding legal / illegal / unknown before
  measurement; feeds ``BindingSpace.mark_illegal`` so search strategies
  prune instead of timing.
* **resources** (``repro_torch.analysis.resources``) — the paper's FPGA
  resource-fit check (Step 5) for GPU memory: peak-live-bytes per traced
  program by a liveness walk over its fake ``make_fx`` graph, per-binding
  fit verdicts against a :class:`DeviceEnvelope`, and a static serve
  capacity planner (``plan_serve_capacity`` / ``serve --preflight``).
* **hotpath** (``repro_torch.analysis.hotpath``) — lint the serve
  engine's step programs for host-sync, retrace-risk, host reads and
  constant-capture bloat.
* **paging** (``repro_torch.analysis.paging``) — prove the paged-KV
  page-table operand free of page aliasing and freed-slot writes.

Programs are traced with fake tensors: nothing runs on the device, and
the CUDA kernels' wrappers take their abstract path (``kernels/build.py``).
``python -m repro_torch.analysis.lint`` runs all passes over the configs
zoo and live engines, diffing against the checked-in
``analysis_baseline_torch.json``.
"""

from repro_torch.analysis.devices import (  # noqa: F401
    STATIC_ENVELOPES,
    DeviceEnvelope,
    probe_device_envelope,
    resolve_envelope,
)
from repro_torch.analysis.diagnostics import (  # noqa: F401
    AnalysisReport,
    Baseline,
    Diagnostic,
)
from repro_torch.analysis.features import (  # noqa: F401
    ProgramFeatures,
    extract_features,
    trace_features,
)
from repro_torch.analysis.hotpath import (  # noqa: F401
    ProgramSet,
    lint_traced_program,
)
from repro_torch.analysis.legality import (  # noqa: F401
    BlockVerdict,
    LegalityReport,
    TargetConstraints,
    check_binding_space,
)
from repro_torch.analysis.paging import (  # noqa: F401
    PageAliasError,
    assert_page_table,
    check_page_table,
)
from repro_torch.analysis.resources import (  # noqa: F401
    CapacityPlan,
    MemoryEstimate,
    ResourceHint,
    ResourceReport,
    ResourceVerdict,
    check_binding_space_resources,
    estimate_memory,
    lint_shelf_coverage,
    plan_serve_capacity,
)

__all__ = [
    "AnalysisReport",
    "Baseline",
    "Diagnostic",
    "ProgramFeatures",
    "extract_features",
    "trace_features",
    "ProgramSet",
    "lint_traced_program",
    "BlockVerdict",
    "LegalityReport",
    "TargetConstraints",
    "check_binding_space",
    "PageAliasError",
    "assert_page_table",
    "check_page_table",
    "DeviceEnvelope",
    "STATIC_ENVELOPES",
    "probe_device_envelope",
    "resolve_envelope",
    "CapacityPlan",
    "MemoryEstimate",
    "ResourceHint",
    "ResourceReport",
    "ResourceVerdict",
    "check_binding_space_resources",
    "estimate_memory",
    "lint_shelf_coverage",
    "plan_serve_capacity",
]
