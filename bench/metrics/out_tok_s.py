"""out_tok_s (tokens/s, host clock): output tokens emitted in the window,
from requests finished or still in flight, over the window's seconds."""

from bench.harness import stats


def read(run):
    n = sum(stats.tokens_in(r.times, run.t0, run.t1) for r in run.requests)
    return stats.rate(n, run.t0, run.t1)
