"""mfu_pct.tput (%, host clock; layer: whole step; the backlog cells): the model FLOPs the window's
tokens need (every prompt finished and every decode token, with the top-k
routed and shared experts only; frozen formulas ``work.prefill_flops`` and
``work.decode_flops``) over the window's seconds times the bf16 peak."""

from bench.harness import work


def read(run):
    steps = run.window_steps()
    flops = sum(work.decode_flops(run.dims, n) for s in steps for n in s.decode_lengths)
    flops += sum(work.prefill_flops(run.dims, p) for s in steps for p in s.prefills)
    if not flops or run.t1 <= run.t0:
        return None
    return 100.0 * flops / ((run.t1 - run.t0) * work.PEAK_BF16_FLOPS)
