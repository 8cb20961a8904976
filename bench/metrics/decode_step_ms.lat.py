"""decode_step_ms.lat (ms, program span; layer: model step): decode
telemetry seconds over decode calls in the window, in the rate cells."""

from bench.harness import readers


def read(run):
    return readers.decode_step_ms(run)
