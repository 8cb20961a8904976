"""arrival_lag_p95_ms (ms, host clock; layer: client): 95th percentile over
the requests due in the window of ``submit()``'s time minus the due time:
how late the open-loop client got each request to the engine."""

from bench.harness import stats


def read(run):
    lags = [r.submitted - r.due for r in run.in_window() if r.submitted is not None]
    p = stats.percentile(lags, 95)
    return None if p is None else p * 1e3
