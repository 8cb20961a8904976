"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: the cell, its configuration, traffic mix,
limits and metrics are found by name (``BENCHMARK.json``, ``bench/``); the
program under test is ``src/repro_torch``.  The last line of standard
output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared beside its limit, also the last lines of
standard error).  Without a CUDA card, or with fewer cards than the cell
asks for, or if the JAX package or JAX itself is loaded once the window
has closed, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names the run must not have loaded, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_age() -> float:
    """Seconds since this process started (its start time in the kernel's
    process table), or since this module began where that is unreadable."""
    try:
        with open("/proc/self/stat", encoding="ascii") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime", encoding="ascii") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        if age >= 0:
            return age
    except (OSError, ValueError, IndexError):
        pass
    return time.perf_counter() - T_START


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # set-up starts at the process's start
    t_start = time.perf_counter() - process_age()

    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    import torch

    from bench.harness import driver, spec

    cell = spec.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"bench: the cell needs {cell.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = driver.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                          root=ROOT, t_start=t_start)
    loaded = forbidden_modules()
    if loaded:
        print(f"bench: the run loaded {loaded}: the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
