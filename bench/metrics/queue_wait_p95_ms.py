"""queue_wait_p95_ms (ms, program counter; layer: engine and scheduler):
95th percentile of ``Completion.queue_wait`` (submit to admission) over
the requests due in the window."""

from bench.harness import readers


def read(run):
    return readers.latency_p95_ms(
        run, lambda r: r.completion.queue_wait if r.completion is not None else None)
