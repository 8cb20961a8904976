"""What the metric readers (``bench/metrics/<name>.py``) share.

A reader takes the run's record (:class:`bench.harness.driver.Run`) and
returns a number, or None where the run has nothing for it to read (then
the metric is left out of the result line; a share of a roofline or a
peak is never reported as 0 for want of data).
"""

from __future__ import annotations

from bench.harness import stats, work


def give_up(run) -> float:
    """When the harness stopped waiting: the end of its last step."""
    return max((s.t1 for s in run.steps), default=run.t1)


def latency_p95_ms(run, latency) -> float | None:
    """p95 in ms of ``latency(record)`` over the requests due in the
    window; a failed request, or one without the reading, counts with the
    wait it had when the harness gave up."""
    end = give_up(run)
    values = []
    for r in run.in_window():
        v = None if r.failed else latency(r)
        values.append(end - r.due if v is None else v)
    p = stats.percentile(values, 95)
    return None if p is None else p * 1e3


def itl_values(run) -> list[float]:
    """Every gap between consecutive tokens of the requests due in the
    window, with one give-up wait for each failed request."""
    end = give_up(run)
    out = []
    for r in run.in_window():
        if r.failed:
            out.append(end - r.due)
        out.extend(stats.gaps(r.times))
    return out


def decode_step_ms(run) -> float | None:
    t = run.telemetry["decode"]
    return t["seconds"] / t["calls"] * 1e3 if t["calls"] else None


def idle_pct(run) -> float | None:
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def roofline_pct(run, kernels: str, bound_s: float) -> float | None:
    """100 x the bound seconds of the traced steps' calls over the device
    seconds of the kernels matching ``kernels`` in the traced stretch."""
    if run.trace is None or bound_s <= 0:
        return None
    seconds = run.trace.seconds_of(kernels)
    return 100.0 * bound_s / seconds if seconds > 0 else None


#: kernel names as the trace shortens them (``::paged_attention_split``,
#: ``::tc::flash_kernel``: namespaces kept)
PAGED_KERNELS = r"(^|::)paged_attention_(split|latent|merge)$"
FLASH_KERNELS = r"(^|::)(flash_kernel|flash_attention_kernel)$"


def paged_bound_s(run) -> float:
    dims = run.dims
    return sum(dims.n_layers * work.paged_decode_work(dims, s.decode_lengths).bound_s()
               for s in run.traced_steps() if s.decode_lengths)


def flash_bound_s(run) -> float:
    dims = run.dims
    return sum(dims.n_layers * work.flash_forward_work(dims, p).bound_s()
               for s in run.traced_steps() for p in s.prefills)
