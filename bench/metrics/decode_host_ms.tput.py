"""decode_host_ms.tput (ms, program span; layer: engine and scheduler): the
host's own work of a decode step (the engine's ``decode.prep``,
``decode.pages`` and ``decode.commit`` segments) over decode calls in
the window, in the backlog cells."""

from bench.harness import segments


def read(run):
    return segments.decode_host_ms(run)
