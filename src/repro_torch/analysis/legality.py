"""Offload-legality pass: which (block, target) bindings may be measured
(the port of ``repro/analysis/legality.py``).

The paper's Step 1 decides *statically* which function blocks are offload
candidates before any measurement is spent on them.  Here a binding is
classified from cheap facts first:

1. **registry metadata** — ``repro_torch.kernels.BLOCK_LEGALITY`` declares
   each shelf implementation's platform and dtype envelope (a ``cuda``
   kernel needs the card: it is illegal on a CPU device);
2. **program features** — dtype universe and dynamic-shape presence of the
   traced step (a float64 program cannot bind a float32-only kernel);
3. **probe trace** — the step is traced under the candidate binding with
   fake tensors (``make_fx``; the kernels' wrappers take their abstract
   path, so nothing is built or launched); a trace failure — a wrapper's
   own refusal of a shape, a dtype or a gradient — is a definitive illegal
   verdict.

Verdicts are ``legal`` / ``illegal`` / ``unknown`` (no metadata and probe
disabled).  Illegal pairs feed ``BindingSpace.mark_illegal`` so search
strategies prune them instead of timing (or crashing on) them.

The platform is the device's: ``"gpu"`` for a CUDA device, ``"cpu"``
otherwise.  Platform-dependent verdicts carry severity ``info`` — they
flip between a CPU CI host and a GPU production host, so they never enter
the lint baseline ratchet.  Structural verdicts (dtype, trace failure) are
``warning``.  The reference's target names map across one to one:
``pallas`` <-> ``cuda``, ``xla`` <-> ``torch``, ``ref`` <-> ``ref``
(:data:`TARGET_MAP`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import torch

from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.analysis.features import ProgramFeatures, trace_features
from repro_torch.core import graph_analysis

LEGAL = "legal"
ILLEGAL = "illegal"
UNKNOWN = "unknown"

#: the reference's target names -> the port's
TARGET_MAP = {"pallas": "cuda", "xla": "torch", "ref": "ref"}


def platform_of(device: "torch.device | str") -> str:
    """The legality platform of a device: ``gpu`` for CUDA, else ``cpu``."""
    return "gpu" if torch.device(device).type == "cuda" else "cpu"


@dataclasses.dataclass(frozen=True)
class TargetConstraints:
    """Static envelope of one registered block implementation.

    ``requires_platform`` — the platforms the implementation runs on
    (empty = any).  ``dtypes`` — float dtypes the kernel supports (empty =
    any); only *floating* program dtypes are checked against it, since
    integer index/id operands ride along in every program.
    """

    requires_platform: tuple[str, ...] = ()
    dtypes: tuple[str, ...] = ()
    allow_dynamic_shapes: bool = True
    notes: str = ""


@dataclasses.dataclass(frozen=True)
class BlockVerdict:
    block: str
    target: str
    status: str  # legal | illegal | unknown
    reason: str = ""
    severity: str = "info"  # severity of the diagnostic this verdict emits


@dataclasses.dataclass
class LegalityReport:
    program: str
    platform: str
    verdicts: list[BlockVerdict] = dataclasses.field(default_factory=list)
    features: ProgramFeatures | None = None
    #: Resource verdicts when ``check_binding_space`` ran with an envelope
    #: (a ``repro_torch.analysis.resources.ResourceReport``), else None.
    resources: Any = None

    @property
    def illegal(self) -> dict[tuple[str, str], str]:
        """The ``(block, target) -> reason`` map ``mark_illegal`` consumes.
        Legality reasons take precedence; statically-OOM bindings from the
        resource pass (when it ran) merge in with their ``memory:`` tag."""
        out: dict[tuple[str, str], str] = {}
        if self.resources is not None:
            out.update(self.resources.oom)
        out.update({
            (v.block, v.target): v.reason
            for v in self.verdicts
            if v.status == ILLEGAL
        })
        return out

    def counts(self) -> dict[str, int]:
        out = {LEGAL: 0, ILLEGAL: 0, UNKNOWN: 0}
        for v in self.verdicts:
            out[v.status] += 1
        return out

    def diagnostics(self) -> list[Diagnostic]:
        diags = []
        for v in self.verdicts:
            if v.status == LEGAL:
                continue
            code = "illegal-binding" if v.status == ILLEGAL else "no-metadata"
            diags.append(
                Diagnostic(
                    pass_name="legality",
                    code=code,
                    severity=v.severity if v.status == ILLEGAL else "info",
                    program=self.program,
                    subject=f"{v.block}->{v.target}",
                    message=v.reason or f"no legality metadata for {v.target}",
                    platform=self.platform,
                )
            )
        if self.resources is not None:
            diags.extend(self.resources.diagnostics())
        return diags


def _float_dtypes(dtypes: frozenset[str]) -> set[str]:
    return {d for d in dtypes if d.startswith(("float", "bfloat", "complex"))}


def shelf_constraints() -> Mapping[tuple[str, str], TargetConstraints]:
    """The kernel shelf's declared legality metadata (imported here: the
    kernels package imports this module for the TargetConstraints type)."""
    from repro_torch.kernels import BLOCK_LEGALITY

    return BLOCK_LEGALITY


def classify_binding(
    block: str,
    target: str,
    spec: TargetConstraints | None,
    features: ProgramFeatures | None,
    platform: str,
) -> BlockVerdict:
    """Metadata-only classification of one (block, target) binding."""
    if spec is None:
        return BlockVerdict(block, target, UNKNOWN, reason="no registry legality metadata")
    if spec.requires_platform and platform not in spec.requires_platform:
        return BlockVerdict(
            block, target, ILLEGAL,
            reason=(
                f"requires platform {'/'.join(spec.requires_platform)}, "
                f"host backend is {platform}"
            ),
            severity="info",  # flips between CI (cpu) and production (gpu) hosts
        )
    if features is not None:
        if spec.dtypes:
            unsupported = _float_dtypes(features.dtypes) - set(spec.dtypes)
            if unsupported:
                return BlockVerdict(
                    block, target, ILLEGAL,
                    reason=(
                        f"program uses {sorted(unsupported)}, kernel "
                        f"supports {list(spec.dtypes)}"
                    ),
                    severity="warning",
                )
        if features.dynamic_shapes and not spec.allow_dynamic_shapes:
            return BlockVerdict(
                block, target, ILLEGAL,
                reason="program has dynamic shapes; kernel requires static",
                severity="warning",
            )
    return BlockVerdict(block, target, LEGAL)


def _probe(space: Any, cand: tuple, args: Sequence[Any]) -> str | None:
    """The probe trace of one candidate: None when it traces, else why not."""
    try:
        graph_analysis.trace(space.build(cand), *args)
    except Exception as e:  # noqa: BLE001 — the probe's verdict
        return f"probe trace failed: {type(e).__name__}: {e}"
    return None


def check_binding_space(
    space: Any,
    args: Sequence[Any],
    constraints: Mapping[tuple[str, str], TargetConstraints] | None = None,
    platform: str | None = None,
    probe_trace: bool = True,
    program: str = "",
    envelope: Any = None,
    resource_hints: Mapping[tuple[str, str], Any] | None = None,
    device: "torch.device | str" = "cuda",
) -> LegalityReport:
    """Classify every (block, target) choice of a ``BindingSpace``.

    Cheap checks run first (registry metadata against the platform of
    ``device`` and the program's dtype/shape features); only pairs that
    survive them are probe-traced under their single-block binding — a
    fake trace only, so no measurement is spent on a binding the probe can
    reject (the paper's FPGA pre-filter economics).

    When ``envelope`` is given (a ``DeviceEnvelope``, a static-table name,
    or ``"host"``/``True`` to probe ``device``), the memory-envelope pass
    also runs — the paper's FPGA resource-fit check — and its
    statically-OOM bindings join ``report.illegal`` tagged ``memory:``.
    """
    from repro_torch.core.planner.space import DEFAULT_TARGET

    if constraints is None:
        constraints = shelf_constraints()
    if platform is None:
        platform = platform_of(device)
    report = LegalityReport(program=program or space.tag, platform=platform)
    if envelope is not None:
        from repro_torch.analysis.resources import check_binding_space_resources

        report.resources = check_binding_space_resources(
            space, tuple(args), envelope=envelope, hints=resource_hints,
            program=program or space.tag, device=device,
        )

    features: ProgramFeatures | None = None
    try:
        features = trace_features(space.build(space.baseline()), *args)
    except Exception:  # noqa: BLE001 — feature-less classification still works
        features = None
    report.features = features

    baseline = space.baseline()
    for i, axis in enumerate(space.axes):
        for c, label in enumerate(axis.choices):
            if label == DEFAULT_TARGET:
                continue
            verdict = classify_binding(
                axis.name, label, constraints.get((axis.name, label)), features, platform,
            )
            if verdict.status in (LEGAL, UNKNOWN) and probe_trace:
                # with no metadata the probe alone decides legal-vs-illegal
                cand = list(baseline)
                cand[i] = c
                failure = _probe(space, tuple(cand), args)
                if failure is not None:
                    verdict = BlockVerdict(axis.name, label, ILLEGAL, reason=failure,
                                           severity="warning")
                elif verdict.status == UNKNOWN:
                    verdict = BlockVerdict(axis.name, label, LEGAL)
            report.verdicts.append(verdict)
    return report
