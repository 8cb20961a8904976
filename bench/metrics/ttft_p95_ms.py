"""ttft_p95_ms (ms, host clock): 95th percentile over every request due in
the window, from its scheduled arrival to its first token as the harness
saw it; a failed request counts with its wait when the harness gave up."""

from bench.harness import readers


def read(run):
    return readers.latency_p95_ms(run, lambda r: r.ttft)
