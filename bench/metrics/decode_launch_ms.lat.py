"""decode_launch_ms.lat (ms, program span; layer: engine and scheduler): the
engine's ``decode.launch`` segment (the decode program's call, input
packing to its return on the host) over its calls in the window, in the
chunked rate cell."""

from bench.harness import segments


def read(run):
    return segments.decode_launch_ms(run)
