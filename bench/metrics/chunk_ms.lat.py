"""chunk_ms.lat (ms, program span; layer: model step): the engine's
``prefill.chunk`` segment (one chunk's program call and its sync) over its
calls in the window, in the chunked rate cell."""

from bench.harness import segments


def read(run):
    return segments.chunk_ms(run)
