"""decode_batch_mean (rows/step, program counter; layer: engine and
scheduler): decode tokens over decode calls in the window, from the
engine's decode ``PhaseTelemetry``."""


def read(run):
    t = run.telemetry["decode"]
    return t["tokens"] / t["calls"] if t["calls"] else None
