"""mfu_pct.prefill (%, program span; layer: whole step; the cells whose
prompts are prefilled whole): the model FLOPs of the prompts the window's
prefill calls finished (frozen formula ``work.prefill_flops``) over the
seconds of those calls (the engine's prefill ``PhaseTelemetry``) times
the bf16 peak: the prefill step's share of the card's peak."""

from bench.harness import work


def read(run):
    seconds = run.telemetry["prefill"]["seconds"]
    flops = sum(work.prefill_flops(run.dims, p) for s in run.window_steps() for p in s.prefills)
    if not flops or seconds <= 0:
        return None
    return 100.0 * flops / (seconds * work.PEAK_BF16_FLOPS)
