"""Store-diff reports and search traces — quantifying the paper's trade-off
(the port of ``repro/metering/report.py``).

The paper ranks offload winners on wall time; the follow-up power work
(arXiv:2110.11520) ranks them on measured draw.  Once both searches have
run (e.g. a ``Latency`` zoo and a ``PerfPerWatt`` zoo committed to two
``PlanStore`` directories), this module diffs them into a per-(arch, kind)
table: winner pattern on each side, speedups, joules (with their
``measured``/``estimated`` provenance marked), and what switching winners
costs in seconds vs saves in joules — the power/performance trade-off as
one table.

  PYTHONPATH=src python -m repro_torch.metering.report \\
      results/plans_latency results/plans_ppw \\
      --label-a latency --label-b perf_per_watt

``search_trace`` reconstructs the paper's Fig. 4 curve (trials measured vs
best-so-far) from a ``PlanReport``'s trials or a ``MeasurementCache``'s
records.  ``--selftest`` builds two tiny stores in-process and diffs them —
the CI smoke path, on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any, Iterable, Sequence

from repro_torch.core.planner.objectives import resolve_objective
from repro_torch.core.planner.store import Plan, PlanStore


def parse_zoo_key(key: str) -> tuple[str, str]:
    """(arch, kind) of a ``zoo:<arch>:<kind>`` key; other keys map to the
    whole key as "arch" with kind "-" so non-zoo stores still diff."""
    parts = key.split(":")
    if len(parts) == 3 and parts[0] == "zoo":
        return parts[1], parts[2]
    return key, "-"


@dataclasses.dataclass
class DiffRow:
    """One (arch, kind) cell's winners side by side."""

    key: str
    arch: str
    kind: str
    pattern_a: dict[str, str]
    pattern_b: dict[str, str]
    agree: bool  # both sides picked the same binding
    objective_a: str
    objective_b: str
    speedup_a: float
    speedup_b: float
    seconds_a: float
    seconds_b: float
    joules_a: float | None
    joules_b: float | None
    provenance_a: str | None
    provenance_b: str | None
    # relative cost of deploying B's winner instead of A's:
    # >0 means B's winner is slower / hungrier on that axis
    seconds_delta_pct: float | None
    joules_delta_pct: float | None

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def _pct(b: float | None, a: float | None) -> float | None:
    if a is None or b is None or a <= 0:
        return None
    return (b / a - 1.0) * 100.0


@dataclasses.dataclass
class _PlanCost:
    """Score-able view of a Plan's winner (duck-types a PlanTrial)."""

    seconds: float
    energy_joules: float | None


def plan_score(plan: Plan, objective: Any = None) -> float:
    """Score a stored plan's winner under any objective (defaults to the
    plan's own) — lets a diff compare both winners on one scale."""
    obj = resolve_objective(objective if objective is not None else plan.objective)
    return obj.score(_PlanCost(plan.best_seconds, plan.best_energy_joules))


def diff_stores(
    store_a: PlanStore | str,
    store_b: PlanStore | str,
    keys: Sequence[str] | None = None,
) -> list[DiffRow]:
    """Diff two plan stores key by key (keys present in both sides).

    Fingerprints are deliberately not matched: the whole point is comparing
    plans searched under different configurations (objective, meter), and
    the caller already chose the two stores.
    """
    store_a = PlanStore(store_a) if isinstance(store_a, str) else store_a
    store_b = PlanStore(store_b) if isinstance(store_b, str) else store_b
    if keys is None:
        keys = sorted(set(store_a.keys()) & set(store_b.keys()))
    rows: list[DiffRow] = []
    for key in keys:
        a = store_a.load(key, match_fingerprint=False)
        b = store_b.load(key, match_fingerprint=False)
        if a is None or b is None:
            continue
        arch, kind = parse_zoo_key(key)
        rows.append(
            DiffRow(
                key=key,
                arch=arch,
                kind=kind,
                pattern_a=dict(a.mapping),
                pattern_b=dict(b.mapping),
                agree=dict(a.mapping) == dict(b.mapping),
                objective_a=a.objective,
                objective_b=b.objective,
                speedup_a=a.speedup,
                speedup_b=b.speedup,
                seconds_a=a.best_seconds,
                seconds_b=b.best_seconds,
                joules_a=a.best_energy_joules,
                joules_b=b.best_energy_joules,
                provenance_a=a.best_energy_provenance,
                provenance_b=b.best_energy_provenance,
                seconds_delta_pct=_pct(b.best_seconds, a.best_seconds),
                joules_delta_pct=_pct(b.best_energy_joules, a.best_energy_joules),
            )
        )
    return rows


def _fmt_mapping(mapping: dict[str, str]) -> str:
    if not mapping:
        return "(baseline)"
    return ",".join(f"{k}={v}" for k, v in sorted(mapping.items()))


def _fmt_joules(joules: float | None, provenance: str | None) -> str:
    if joules is None:
        return "-"
    tag = {"measured": "J*", "estimated": "J~"}.get(provenance or "", "J?")
    return f"{joules:.3g}{tag}"


def _fmt_pct(pct: float | None) -> str:
    return "-" if pct is None else f"{pct:+.1f}%"


def render_table(
    rows: Iterable[DiffRow], label_a: str = "A", label_b: str = "B"
) -> str:
    """Fixed-width trade-off table.  Joules provenance is marked on every
    energy cell: ``J*`` measured (hardware counter), ``J~`` estimated
    (modelled / apportioned)."""
    rows = list(rows)
    header = [
        "arch",
        "kind",
        f"winner[{label_a}]",
        f"winner[{label_b}]",
        f"speedup[{label_a}]",
        f"speedup[{label_b}]",
        f"joules[{label_a}]",
        f"joules[{label_b}]",
        "d_seconds",
        "d_joules",
    ]
    body = [
        [
            r.arch,
            r.kind,
            _fmt_mapping(r.pattern_a),
            _fmt_mapping(r.pattern_b) if not r.agree else "(same)",
            f"{r.speedup_a:.2f}x",
            f"{r.speedup_b:.2f}x",
            _fmt_joules(r.joules_a, r.provenance_a),
            _fmt_joules(r.joules_b, r.provenance_b),
            _fmt_pct(r.seconds_delta_pct),
            _fmt_pct(r.joules_delta_pct),
        ]
        for r in rows
    ]
    widths = [
        max(len(header[i]), *(len(row[i]) for row in body)) if body else len(header[i])
        for i in range(len(header))
    ]
    lines = [
        "  ".join(h.ljust(w) for h, w in zip(header, widths)).rstrip(),
        "  ".join("-" * w for w in widths),
    ]
    for row in body:
        lines.append("  ".join(c.ljust(w) for c, w in zip(row, widths)).rstrip())
    if not body:
        lines.append("(no keys present in both stores)")
    lines.append("")
    lines.append(
        "joules provenance: J* = measured (hardware counter), "
        "J~ = estimated (modelled draw); d_* = B relative to A"
    )
    return "\n".join(lines)


# -- search traces (paper Fig. 4) ---------------------------------------------


@dataclasses.dataclass
class TracePoint:
    trial: int  # 1-based measurement index
    pattern: tuple[str, ...]
    seconds: float
    best_seconds: float  # best-so-far after this trial
    cached: bool = False


def search_trace(source: Any) -> list[TracePoint]:
    """Trials-measured vs best-so-far (the paper's Fig. 4 x/y), from a
    ``PlanReport`` (or its ``trials`` list) or a ``MeasurementCache``.

    Cache records are replayed in measurement order; cached trials (replays)
    are included but never newly measured, so plotting ``cached=False``
    points reproduces the true evaluation curve.
    """
    points: list[TracePoint] = []
    if hasattr(source, "records"):  # MeasurementCache
        # a record's key ends with the space's canonical candidate — a
        # sorted tuple of (axis, choice) pairs; render it as axis=choice
        # labels so the trace identifies what each measurement was
        entries = [
            (
                tuple(
                    f"{axis}={choice}" for axis, choice in rec.key[-1]
                ) if isinstance(rec.key, tuple) and rec.key else (),
                rec.measurement.seconds,
                False,
            )
            for rec in source.records()
        ]
    else:
        trials = getattr(source, "trials", source)
        entries = [
            (tuple(t.pattern), t.seconds, bool(t.cached)) for t in trials
        ]
    best = float("inf")
    for i, (pattern, seconds, cached) in enumerate(entries, start=1):
        best = min(best, seconds)
        points.append(
            TracePoint(
                trial=i,
                pattern=pattern,
                seconds=seconds,
                best_seconds=best,
                cached=cached,
            )
        )
    return points


def render_trace(points: Sequence[TracePoint]) -> str:
    lines = ["trial  seconds      best_so_far  pattern"]
    for p in points:
        tag = " (cached)" if p.cached else ""
        lines.append(
            f"{p.trial:5d}  {p.seconds:11.6f}  {p.best_seconds:11.6f}  "
            f"{','.join(p.pattern) or '(baseline)'}{tag}"
        )
    return "\n".join(lines)


# -- selftest (CI smoke) ------------------------------------------------------


def _selftest_stores(root: str) -> tuple[str, str]:
    """Build a Latency store and a PerfPerWatt store by really searching a
    tiny deterministic space with a candidate-dependent power model, such
    that the two objectives pick different winners."""
    import time

    from repro_torch.core.planner import (
        ExhaustiveSearch,
        MeasurementCache,
        Planner,
        PlanStore,
        SubsetSpace,
    )
    from repro_torch.core.planner.objectives import PowerMeter

    # fast-but-hungry vs slow-but-frugal: the classic trade-off cell
    costs = {
        frozenset(): (0.008, 40.0),
        frozenset({"fft"}): (0.002, 300.0),  # latency winner
        frozenset({"lu"}): (0.004, 60.0),  # perf-per-watt winner
        frozenset({"fft", "lu"}): (0.003, 250.0),
    }

    def build(subset):
        seconds, _watts = costs[frozenset(subset)]

        def fn(_x):
            time.sleep(seconds)
            return _x

        return fn

    class CandidateWatts(PowerMeter):
        """Charges each candidate its modelled board draw."""

        provenance = "measured"  # stands in for a counter in the selftest
        exclusive = False

        def end(self, measurement, space=None, candidate=None):
            subset = space.subset_of(candidate)
            return costs[frozenset(subset)][1] * measurement.seconds

    dirs = (f"{root}/latency", f"{root}/perf_per_watt")
    for objective, plan_dir in zip(("latency", "perf_per_watt"), dirs):
        space = SubsetSpace(build, ["fft", "lu"], tag="selftest")
        planner = Planner(
            space,
            strategy=ExhaustiveSearch(),
            cache=MeasurementCache(meter=CandidateWatts()),
            store=PlanStore(plan_dir),
            objective=objective,
        )
        planner.plan((0,), key="zoo:selftest:app", repeats=1)
    return dirs


def selftest() -> int:
    """End-to-end smoke: search two tiny zoos under different objectives,
    diff the stores, and verify the table is non-empty with provenance
    marked.  Returns a process exit code."""
    import tempfile

    with tempfile.TemporaryDirectory() as root:
        dir_a, dir_b = _selftest_stores(root)
        rows = diff_stores(dir_a, dir_b)
        table = render_table(rows, label_a="latency", label_b="perf_per_watt")
        print(table)
        if not rows:
            print("selftest FAILED: empty diff")
            return 1
        row = rows[0]
        if row.joules_a is None or row.joules_b is None:
            print("selftest FAILED: joules missing from plans")
            return 1
        if row.provenance_a is None or row.provenance_b is None:
            print("selftest FAILED: joules provenance not marked")
            return 1
        if row.agree:
            print("selftest FAILED: objectives should disagree on winner")
            return 1
    print("selftest OK")
    return 0


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Diff two offload plan stores (power/performance "
        "trade-off per (arch, kind) cell)."
    )
    ap.add_argument("store_a", nargs="?", help="first PlanStore directory")
    ap.add_argument("store_b", nargs="?", help="second PlanStore directory")
    ap.add_argument("--label-a", default="A")
    ap.add_argument("--label-b", default="B")
    ap.add_argument("--json", action="store_true", help="emit rows as JSON")
    ap.add_argument(
        "--fail-empty",
        action="store_true",
        help="exit non-zero when the diff has no rows (CI guard: an empty "
        "table usually means the zoos upstream failed to build)",
    )
    ap.add_argument(
        "--selftest",
        action="store_true",
        help="build two tiny stores in-process and diff them (CI smoke)",
    )
    args = ap.parse_args(argv)

    if args.selftest:
        return selftest()
    if not args.store_a or not args.store_b:
        ap.error("two store directories are required (or --selftest)")
    rows = diff_stores(args.store_a, args.store_b)
    if args.json:
        print(json.dumps([r.to_json() for r in rows], indent=1))
    else:
        print(render_table(rows, label_a=args.label_a, label_b=args.label_b))
    if args.fail_empty and not rows:
        print("error: diff is empty (--fail-empty)", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
