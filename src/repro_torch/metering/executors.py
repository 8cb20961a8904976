"""MeasurementExecutor — how a batch of candidate trials is timed (the
port of ``repro/metering/executors.py``).

An executor consumes ``MeasureJob``s (a built variant plus its timing
parameters) and returns one ``verify.Measurement`` per job, in order.  The
``PowerMeter`` hooks ride along: the executor brackets the timed work
with ``begin``/``end`` and stamps ``energy_joules`` + ``energy_provenance``
on the measurement.

Only ``SerialExecutor`` — one job after another, the reference semantics —
is ported.  The reference's ``DeviceParallelExecutor`` and
``BatchedExecutor`` are not: asking for them by name raises
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence

from repro_torch.core import verify
from repro_torch.core.blocks import GradRefused


@dataclasses.dataclass
class MeasureJob:
    """One candidate's timed work: the built variant and how to time it.

    ``space``/``candidate`` are carried only for the PowerMeter's ``end``
    hook (meters may attribute draw per candidate); executors never
    interpret them.
    """

    fn: Callable[..., Any]
    args: Sequence[Any]
    repeats: int = 3
    min_seconds: float = 0.0
    warmup: int = 1
    space: Any = None
    candidate: Any = None


def run_job(job: MeasureJob, meter: Any = None) -> verify.Measurement:
    """Measure one job with the meter's begin/end bracketing the timed
    window.  A job whose binding cannot differentiate the step it runs (a
    train cell's CUDA kernel with no backward: ``GradRefused``) is a failed
    trial: infinitely slow, so it never wins, and the search goes on."""
    if meter is not None:
        meter.begin()
    try:
        m = verify.measure(
            job.fn, job.args, repeats=job.repeats, warmup=job.warmup,
            min_seconds=job.min_seconds,
        )
    except GradRefused:
        return verify.Measurement(seconds=math.inf, compile_seconds=0.0, repeats=0)
    if meter is not None:
        m.energy_joules = meter.end(m, space=job.space, candidate=job.candidate)
        if m.energy_joules is not None:
            m.energy_provenance = getattr(meter, "provenance", None)
    return m


class SerialExecutor:
    """One job after another on the caller's thread (reference semantics)."""

    name = "serial"

    def run(
        self, jobs: Sequence[MeasureJob], meter: Any = None
    ) -> list[verify.Measurement]:
        return [run_job(job, meter) for job in jobs]


_NOT_PORTED = ("device_parallel", "device-parallel", "batched")


def resolve_executor(executor: Any) -> Any:
    """Accept a SerialExecutor, ``"serial"`` or None (-> SerialExecutor)."""
    if executor is None or executor == "serial":
        return SerialExecutor()
    if isinstance(executor, str):
        if executor in _NOT_PORTED:
            raise NotImplementedError(
                f"the '{executor}' executor is not ported yet; use 'serial'"
            )
        raise KeyError(f"unknown executor '{executor}'; known: ['serial']")
    if not isinstance(executor, SerialExecutor):
        raise NotImplementedError(
            f"{type(executor).__name__}: only the serial executor is ported"
        )
    return executor
