"""itl_p95_ms (ms, host clock): 95th percentile of every gap between
consecutive tokens of a request, over all requests due in the window (a
failed request adds its give-up wait)."""

from bench.harness import readers, stats


def read(run):
    p = stats.percentile(readers.itl_values(run), 95)
    return None if p is None else p * 1e3
