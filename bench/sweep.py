"""The knee of a rate cell: one sweep over fixed Poisson rates on the card.

    python3 bench/sweep.py --workload <cell> --rates 4 6 8 10 --seconds 20 --seed 7

Each rate is one run of the cell as ``bench/run.py`` makes it, with the
mix's ``rate_per_s`` replaced; the line per rate gives the tails, the queue
wait, the requests due in the window that were admitted only after it
closed (a queue that grew through the window), and the failures.  The knee
is the highest rate with ``ttft_p95_ms`` <= 2000, ``itl_p95_ms`` <= 50 and
no queue growth; the cell's mix runs at about 0.8 of it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    for path in (ROOT / "src", ROOT):
        sys.path.insert(0, str(path))
    import torch

    from bench.harness import driver, readers

    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 2
    for rate in args.rates:
        kept = {}
        # the check reads one request: a sweep's runs set no limit
        out = driver.run_cell(args.workload, args.seed, args.seconds, False, root=ROOT,
                              overrides={"rate_per_s": rate, "check_requests": 1,
                                         "check_min_tokens": 1}, keep=kept)
        run = kept["run"]
        late = sum(1 for r in run.in_window()
                   if r.completion is None or r.completion.admitted_at is None
                   or r.completion.admitted_at > run.t1)
        waits = [r.completion.queue_wait for r in run.in_window() if r.completion is not None]
        print(json.dumps({
            "workload": args.workload, "rate_per_s": rate, "seed": args.seed,
            "ttft_p95_ms": out["metrics"].get("ttft_p95_ms", {}).get("value"),
            "itl_p95_ms": out["metrics"].get("itl_p95_ms", {}).get("value"),
            "queue_wait_max_ms": 1e3 * max(waits, default=0.0),
            "admitted_after_window": late, "attempted": out["attempted"],
            "failed": out["failed"], "correct": out["correct"],
            "decode_step_ms": readers.decode_step_ms(run),
        }), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
