"""PlanStore — persistent offload plans for production startup (the port
of ``repro/core/planner/store.py``).

The paper's flow ends with "the verified pattern is deployed"; this module
makes that a first-class artifact.  A ``Plan`` is the winning pattern of a
search (block -> choice mapping) plus the environment fingerprint it was
verified under.  Plans are JSON files under a configurable directory, so
``launch/serve.py`` / ``launch/train.py`` can load a previously verified
plan at startup and bind it via ``blocks.bind`` with zero re-measurement.
A fingerprint mismatch (different device kind, torch version, ...) makes the
stored plan invisible, forcing a fresh search rather than silently reusing
a pattern verified on different hardware.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import re
import time
from typing import Any, Mapping


def environment_fingerprint(extra: Mapping[str, str] | None = None) -> dict[str, str]:
    """What the measured plan is conditional on."""
    import platform

    fp: dict[str, str] = {
        "python": platform.python_version(),
        "machine": platform.machine(),
    }
    import torch

    import repro_torch.kernels as shelf
    from repro_torch.kernels import build

    fp["torch"] = torch.__version__
    fp["backend"] = "cuda" if torch.cuda.is_available() else "cpu"
    if torch.cuda.is_available():
        fp["device"] = torch.cuda.get_device_name(0)
    # the kernel shelf is part of the environment: a plan measured against
    # one set of CUDA sources (and build flags) or of wrappers must not
    # silently bind after either is rewritten, so both are hashed in
    fp["kernel_shelf"] = f"{build.source_hash()}:{shelf.SHELF_FINGERPRINT}"
    if extra:
        fp.update(extra)
    return fp


@dataclasses.dataclass
class Plan:
    key: str  # user-chosen plan name, e.g. "serve:llama3.2-1b:decode"
    space: str  # SearchSpace signature the plan was searched over
    mapping: dict[str, str]  # axis/block -> chosen non-baseline target
    pattern: tuple[str, ...]
    baseline_seconds: float
    best_seconds: float
    speedup: float
    strategy: str
    evaluations: int
    search_seconds: float
    fingerprint: dict[str, str]
    created_unix: float = 0.0
    objective: str = "latency"  # objective that selected this pattern
    best_energy_joules: float | None = None  # when a PowerMeter was wired
    # "measured" (hardware counter) vs "estimated" (modelled draw); None
    # when no meter produced a reading
    best_energy_provenance: str | None = None

    def to_json(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["pattern"] = list(self.pattern)
        return d

    @classmethod
    def from_json(cls, d: Mapping[str, Any]) -> "Plan":
        d = dict(d)
        d["pattern"] = tuple(d.get("pattern", ()))
        d["mapping"] = dict(d.get("mapping", {}))
        d["fingerprint"] = dict(d.get("fingerprint", {}))
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def _slug(key: str) -> str:
    return re.sub(r"[^A-Za-z0-9._-]+", "_", key) or "plan"


class PlanStore:
    def __init__(self, root: str | pathlib.Path) -> None:
        self.root = pathlib.Path(root)

    def path_for(self, key: str) -> pathlib.Path:
        return self.root / f"{_slug(key)}.json"

    def keys(self) -> list[str]:
        if not self.root.is_dir():
            return []
        out = []
        for p in sorted(self.root.glob("*.json")):
            try:
                out.append(json.loads(p.read_text())["key"])
            except Exception:  # noqa: BLE001 — skip foreign/corrupt files
                continue
        return out

    def save(self, plan: Plan) -> pathlib.Path:
        self.root.mkdir(parents=True, exist_ok=True)
        path = self.path_for(plan.key)
        tmp = path.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(plan.to_json(), indent=1, sort_keys=True))
        tmp.replace(path)  # atomic publish
        return path

    def load(
        self,
        key: str,
        fingerprint: Mapping[str, str] | None = None,
        match_fingerprint: bool = True,
    ) -> Plan | None:
        """Load a plan, or None when absent / verified under a different
        environment (so the caller falls back to a fresh search)."""
        path = self.path_for(key)
        if not path.exists():
            return None
        try:
            plan = Plan.from_json(json.loads(path.read_text()))
        except Exception:  # noqa: BLE001 — corrupt plan == no plan
            return None
        if plan.key != key:
            # distinct keys can slug to the same filename ('a:b' vs 'a_b');
            # never hand back a plan verified under a different key
            return None
        if match_fingerprint:
            current = dict(fingerprint) if fingerprint is not None else (
                environment_fingerprint()
            )
            # strict equality, both directions: a key only one side can
            # produce is a mismatch, not a wildcard.  Plan-side extras
            # mean hardware we can't even identify; current-side extras
            # mean the plan predates a fingerprint component (e.g. the
            # kernel-shelf hash) and could silently survive the very
            # change that component exists to detect.
            if dict(plan.fingerprint) != current:
                return None
        return plan


def plan_from_report(key: str, space_signature: str, report: Any) -> Plan:
    """Build a Plan from a strategies.PlanReport (kept here so stores can be
    used without importing the strategy layer)."""
    return Plan(
        key=key,
        space=space_signature,
        mapping=dict(report.best.mapping),
        pattern=tuple(report.best.pattern),
        baseline_seconds=report.baseline_seconds,
        best_seconds=report.best.seconds,
        speedup=report.best.speedup,
        strategy=report.strategy,
        evaluations=report.evaluations,
        search_seconds=report.search_seconds,
        fingerprint=environment_fingerprint(),
        created_unix=time.time(),
        objective=getattr(report, "objective", "latency"),
        best_energy_joules=getattr(report.best, "energy_joules", None),
        best_energy_provenance=getattr(report.best, "energy_provenance", None),
    )
