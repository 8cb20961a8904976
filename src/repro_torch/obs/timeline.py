"""Terminal span summary over an exported trace (a copy of
``repro/obs/timeline.py``).

``python -m repro_torch.obs.timeline trace.json`` loads a Chrome/Perfetto
``trace_event`` JSON file (or the JSONL stream form) written by
:class:`repro_torch.obs.Tracer` and prints:

* a per-span-kind table — count, total time, p50/p99 durations — the
  quick "where did the time go" answer without opening a UI;
* the critical path of the worst request: the request whose submit ->
  complete makespan was largest, with its lifecycle spans (queue,
  kv-alloc, prefill, decode steps, preemptions) in time order and the
  gaps between them.

``--check`` additionally validates the file (parseable, every event
carries name/ph/ts, timestamps non-negative and durations non-negative)
and exits non-zero on violations — the CI smoke job's trace gate.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from typing import Any, Sequence

__all__ = ["load_events", "span_summary", "worst_request", "main"]


def load_events(path: str) -> list[dict]:
    """Events from a ``{"traceEvents": [...]}`` JSON file or a JSONL
    stream (one event object per line)."""
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        # not one document -> the JSONL stream form, one object per line
        events = [
            json.loads(line) for line in text.splitlines() if line.strip()
        ]
    else:
        events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
    return [e for e in events if isinstance(e, dict)]


def validate(events: Sequence[dict]) -> list[str]:
    """Structural problems that would break a trace viewer."""
    problems: list[str] = []
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph == "M":
            continue  # metadata events carry no timestamp
        if not ev.get("name"):
            problems.append(f"event {i}: missing name")
        if ph not in ("X", "i", "B", "E"):
            problems.append(f"event {i}: unknown phase {ph!r}")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i}: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i}: bad dur {dur!r}")
    spans = [e for e in events if e.get("ph") == "X"]
    for a, b in zip(spans, spans[1:]):
        if b.get("ts", 0) < a.get("ts", 0):
            problems.append("span timestamps are not monotonically sorted")
            break
    return problems


def _pct(sorted_xs: Sequence[float], q: float) -> float:
    if not sorted_xs:
        return 0.0
    idx = min(int(q * (len(sorted_xs) - 1) + 0.5), len(sorted_xs) - 1)
    return sorted_xs[idx]


def span_summary(events: Sequence[dict]) -> list[dict]:
    """Per span-kind aggregate rows, ordered by total time descending."""
    durs: dict[str, list[float]] = defaultdict(list)
    for ev in events:
        if ev.get("ph") == "X":
            durs[ev["name"]].append(float(ev.get("dur", 0.0)))
    rows = []
    for name, xs in durs.items():
        xs.sort()
        rows.append({
            "name": name,
            "count": len(xs),
            "total_ms": sum(xs) / 1e3,
            "p50_ms": _pct(xs, 0.5) / 1e3,
            "p99_ms": _pct(xs, 0.99) / 1e3,
        })
    rows.sort(key=lambda r: -r["total_ms"])
    return rows


def _request_of(ev: dict) -> Any:
    args = ev.get("args") or {}
    return args.get("request")


def worst_request(events: Sequence[dict]) -> tuple[Any, list[dict]] | None:
    """(request id, its spans in time order) for the request with the
    largest makespan; None when the trace carries no request spans."""
    per_req: dict[Any, list[dict]] = defaultdict(list)
    for ev in events:
        if ev.get("ph") in ("X", "i") and _request_of(ev) is not None:
            per_req[_request_of(ev)].append(ev)
    if not per_req:
        return None

    def makespan(evs: list[dict]) -> float:
        t0 = min(e["ts"] for e in evs)
        t1 = max(e["ts"] + e.get("dur", 0.0) for e in evs)
        return t1 - t0

    worst = max(per_req, key=lambda r: makespan(per_req[r]))
    return worst, sorted(per_req[worst], key=lambda e: e["ts"])


def render(events: Sequence[dict], max_path: int = 40) -> str:
    lines: list[str] = []
    rows = span_summary(events)
    if rows:
        lines.append(
            f"{'span':<16} {'count':>7} {'total ms':>10} "
            f"{'p50 ms':>9} {'p99 ms':>9}"
        )
        for r in rows:
            lines.append(
                f"{r['name']:<16} {r['count']:>7} {r['total_ms']:>10.2f} "
                f"{r['p50_ms']:>9.3f} {r['p99_ms']:>9.3f}"
            )
    else:
        lines.append("no complete spans in trace")

    worst = worst_request(events)
    if worst is not None:
        req, path = worst
        t_origin = path[0]["ts"]
        t_end = max(e["ts"] + e.get("dur", 0.0) for e in path)
        lines.append("")
        lines.append(
            f"critical path of worst request (request={req}, "
            f"makespan {(t_end - t_origin) / 1e3:.2f} ms):"
        )
        prev_end = t_origin
        shown = path[:max_path]
        for ev in shown:
            gap = ev["ts"] - prev_end
            dur = ev.get("dur", 0.0)
            mark = f"  +{gap / 1e3:.3f} ms gap" if gap > 1.0 else ""
            lines.append(
                f"  {ev['name']:<16} @{(ev['ts'] - t_origin) / 1e3:>9.3f} ms"
                f"  dur {dur / 1e3:>8.3f} ms{mark}"
            )
            prev_end = max(prev_end, ev["ts"] + dur)
        if len(path) > len(shown):
            lines.append(f"  ... {len(path) - len(shown)} more spans")
    return "\n".join(lines)


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.timeline",
        description=__doc__.split("\n")[0],
    )
    ap.add_argument("trace", help="trace_event JSON (or JSONL) file")
    ap.add_argument("--check", action="store_true",
                    help="validate the trace structure; non-zero exit on "
                         "violations (CI gate)")
    ap.add_argument("--max-path", type=int, default=40,
                    help="max spans printed for the critical path")
    args = ap.parse_args(argv)

    try:
        events = load_events(args.trace)
    except (OSError, json.JSONDecodeError) as e:
        print(f"timeline: cannot load {args.trace}: {e}", file=sys.stderr)
        return 2
    problems = validate(events)
    if problems:
        for p in problems:
            print(f"timeline: INVALID: {p}", file=sys.stderr)
        if args.check:
            return 1
    elif args.check:
        print(f"timeline: {args.trace} OK "
              f"({sum(1 for e in events if e.get('ph') == 'X')} spans, "
              f"{len(events)} events)")
    print(render(events, max_path=args.max_path))
    return 0


if __name__ == "__main__":
    sys.exit(main())
