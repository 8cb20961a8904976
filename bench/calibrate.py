"""Readings that a cell's correctness limit is set from.

    python3 bench/calibrate.py --workload <cell> --seeds 11 12 13 --seconds 8 [--out file]
        [--fault half_batch]

For each seed, one run of the cell as ``bench/run.py`` makes it (the same
set-up, traffic, window and sample), in one process, reading both the
program's gaps and the control's: the reference computed with fp8 operands
in the program's place, its top token's gap on the same prompts and served
tokens.  The control goes through the run's own verdict in the program's
place: its ``control_correct`` has to come out false.  The limit goes above
the largest program reading and below the smallest control reading
(``bench/limits``); the benchmark's own runs never run the control.  With
``--fault``, a fault of :mod:`bench.harness.faults` is planted under the
program first, and the run's ``correct`` has to come out false.  Prints
one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    ap.add_argument("--fault", default=None, help="a fault to plant under the program")
    args = ap.parse_args(argv)
    for path in (ROOT / "src", ROOT):
        sys.path.insert(0, str(path))
    import torch

    from bench.harness import driver, faults

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    if args.fault:
        faults.FAULTS[args.fault](setattr)
    for seed in args.seeds:
        t0 = time.perf_counter()
        kept = {}
        out = driver.run_cell(args.workload, seed, args.seconds, False, root=ROOT, control=True,
                              keep=kept)
        line = json.dumps({
            "workload": args.workload, "seed": seed, "fault": args.fault,
            "correct": out["correct"],
            "control_correct": kept["control_result"]["correct"],
            "checks": out["checks"],
            "gaps": kept["gap"],
            "metrics": out["metrics"], "seconds": time.perf_counter() - t0,
            "kind": out["device"]["kind"],
        })
        print(line, flush=True)
        if args.out:
            with open(args.out, "a", encoding="utf-8") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
