"""Spreads of a cell's end-to-end metrics over sets of runs, for its bounds.

    python3 bench/spread.py A=out/a1.json,out/a2.json,... B=out/b1.json,...

Each file holds a run's standard output (its last line is the result).
For each metric and set: the median and the spread, the distance between
the first and third quartiles (``statistics.quantiles(values, n=4)``) as
a share of the median; then the wider of the sets' spreads, five times
it (the bound it suggests, never under 1%), and the second set's median
against the first's.
"""

from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench.harness.stats import quartile_spread  # noqa: E402


def last_line(path: str) -> dict:
    lines = Path(path).read_text(encoding="utf-8").strip().splitlines()
    return json.loads(lines[-1])


def main(argv: list[str]) -> int:
    sets = {}
    for arg in argv:
        label, files = arg.split("=", 1)
        sets[label] = [last_line(f) for f in files.split(",") if f]
    names = sorted({m for runs in sets.values() for r in runs for m in r["metrics"]})
    for name in names:
        row = {"metric": name}
        spreads, medians = [], []
        for label, runs in sets.items():
            values = [r["metrics"][name]["value"] for r in runs if name in r["metrics"]]
            med = statistics.median(values)
            spread = quartile_spread(values) if len(values) >= 2 else 0.0
            row[label] = {"n": len(values), "median": med, "spread": spread,
                          "min": min(values), "max": max(values)}
            spreads.append(spread)
            medians.append(med)
        row["widest_spread"] = max(spreads)
        row["bound_5x"] = max(0.01, 5 * max(spreads))
        if len(medians) >= 2:
            row["second_vs_first"] = medians[1] / medians[0] - 1
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
