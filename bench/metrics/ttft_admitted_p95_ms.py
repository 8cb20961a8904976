"""ttft_admitted_p95_ms (ms, program counter; layer: model step): 95th
percentile of ``Completion.ttft_admitted`` (admission to first token) over
the requests due in the window."""

from bench.harness import readers


def read(run):
    return readers.latency_p95_ms(
        run, lambda r: r.completion.ttft_admitted if r.completion is not None else None)
