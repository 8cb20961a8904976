"""Typed diagnostics shared by every ``repro_torch.analysis`` pass (a copy
of ``repro/analysis/diagnostics.py``; the baseline file keeps its format).

A :class:`Diagnostic` is one finding of one pass about one program (or one
block binding).  Reports aggregate diagnostics, serialize to JSON for the
lint CLI, and diff against a checked-in *baseline* file so CI fails only on
**new** violations — the same ratchet discipline as a type-checker baseline.

Severities:

* ``error``   — a contract violation (page aliasing, double write): always
  actionable, never baselined silently.
* ``warning`` — a hot-path hazard (host sync in the decode loop, retrace
  drift, constant-capture bloat): participates in ``--fail-on-new``.
* ``info``    — environment-dependent facts (a cuda binding illegal on
  this host's platform): recorded for the planner, exempt from the baseline
  ratchet because they flip between a CPU CI host and a GPU production host.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Iterable, Mapping

SEVERITIES = ("info", "warning", "error")

#: Severities the baseline ratchet tracks (``info`` is host-dependent).
RATCHET_SEVERITIES = ("warning", "error")


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding: ``pass_name`` flagged ``subject`` inside ``program``."""

    pass_name: str  # "legality" | "hotpath" | "paging" | "resources"
    code: str  # machine-readable rule id, e.g. "host-sync"
    severity: str  # "info" | "warning" | "error"
    program: str  # traced program / zoo cell / engine program name
    subject: str  # block binding, output index, slot/page — the *what*
    message: str  # human-readable explanation
    platform: str = ""  # host backend / envelope the finding was made on

    def __post_init__(self) -> None:
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity '{self.severity}'")

    @property
    def fingerprint(self) -> str:
        """Stable identity used for baseline matching.  Deliberately
        excludes ``message`` (rewording an explanation shouldn't churn the
        baseline file) and ``platform`` (the same finding on a CPU CI host
        and a GPU production host must ratchet as one entry — host facts
        are normalized out of the checked-in baseline)."""
        return f"{self.pass_name}:{self.code}:{self.program}:{self.subject}"

    def to_dict(self) -> dict[str, str]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Diagnostic":
        return cls(
            pass_name=d["pass_name"],
            code=d["code"],
            severity=d["severity"],
            program=d["program"],
            subject=d["subject"],
            message=d.get("message", ""),
            platform=d.get("platform", ""),
        )

    def __str__(self) -> str:
        plat = f" [{self.platform}]" if self.platform else ""
        return (
            f"{self.severity}[{self.pass_name}/{self.code}] "
            f"{self.program} :: {self.subject}{plat} — {self.message}"
        )


@dataclasses.dataclass
class AnalysisReport:
    """Aggregated diagnostics from one or more passes."""

    diagnostics: list[Diagnostic] = dataclasses.field(default_factory=list)

    def extend(self, diags: Iterable[Diagnostic]) -> None:
        self.diagnostics.extend(diags)

    def by_severity(self, severity: str) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == severity]

    def by_pass(self, pass_name: str) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.pass_name == pass_name]

    def counts(self) -> dict[str, int]:
        out = {s: 0 for s in SEVERITIES}
        for d in self.diagnostics:
            out[d.severity] += 1
        return out

    def ratchet_fingerprints(self) -> set[str]:
        """Fingerprints of the diagnostics the baseline ratchet tracks."""
        return {
            d.fingerprint
            for d in self.diagnostics
            if d.severity in RATCHET_SEVERITIES
        }

    def new_versus(self, baseline: "Baseline") -> list[Diagnostic]:
        """Ratchet-tracked diagnostics not present in the baseline —
        the set ``--fail-on-new`` fails on."""
        known = baseline.fingerprints
        return sorted(
            (
                d
                for d in self.diagnostics
                if d.severity in RATCHET_SEVERITIES
                and d.fingerprint not in known
            ),
            key=lambda d: d.fingerprint,
        )

    def to_dict(self) -> dict[str, Any]:
        return {
            "counts": self.counts(),
            "diagnostics": [
                d.to_dict()
                for d in sorted(
                    self.diagnostics, key=lambda d: d.fingerprint
                )
            ],
        }


@dataclasses.dataclass
class Baseline:
    """The checked-in set of accepted diagnostic fingerprints."""

    fingerprints: set[str] = dataclasses.field(default_factory=set)

    SCHEMA = 1

    @classmethod
    def load(cls, path: str | Path) -> "Baseline":
        path = Path(path)
        if not path.exists():
            return cls()
        data = json.loads(path.read_text())
        return cls(fingerprints=set(data.get("fingerprints", [])))

    def save(self, path: str | Path, report: AnalysisReport) -> None:
        """Rewrite the baseline from a report (``--update-baseline``)."""
        payload = {
            "schema": self.SCHEMA,
            "note": (
                "Accepted repro_torch.analysis diagnostics; regenerate with "
                "`python -m repro_torch.analysis.lint --update-baseline`."
            ),
            "fingerprints": sorted(report.ratchet_fingerprints()),
        }
        Path(path).write_text(json.dumps(payload, indent=2) + "\n")
