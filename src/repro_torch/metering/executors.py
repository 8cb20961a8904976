"""MeasurementExecutor — how a batch of candidate trials is timed (the
port of ``repro/metering/executors.py``).

The paper's search loop is dominated by measurement: every candidate
pattern is a compile+run, executed serially.  This module makes the *how*
of that timed work pluggable behind ``MeasurementCache`` so every search
strategy (and ``OffloadSession.plan``) picks parallelism up for free:

  SerialExecutor          one job after another — the historical behaviour
                          and the reference semantics the others must match.
  DeviceParallelExecutor  thread-per-CUDA-device: independent candidates
                          (a GA generation, the single-axis trials of
                          SingleThenCombine) measure concurrently, each
                          trial's tensors moved to its device and the call
                          run under ``torch.cuda.device`` so concurrent
                          variants do not contend for one card.
  BatchedExecutor         fuses several short variants into one timed
                          window and apportions the window by per-variant
                          events — amortises timer/dispatch overhead for
                          sub-millisecond kernels.

An executor consumes ``MeasureJob``s (a built variant plus its timing
parameters) and returns one ``verify.Measurement`` per job, in order.  The
``PowerMeter`` hooks ride along: each executor brackets the timed work with
``begin``/``end`` and stamps ``energy_joules`` + ``energy_provenance`` on
the measurement.  Meters whose ``exclusive`` flag is set read device-global
counters, so parallel executors serialise their metered sections —
concurrent trials would otherwise be attributed each other's energy.

Every executor calls the job's ``fn`` itself: a ``BindingSpace`` variant
enters its block binding inside the call, and bindings are thread-local.
A job whose binding cannot differentiate the step it runs (a train cell's
CUDA kernel with no backward: ``GradRefused``) is a failed trial in every
executor: infinitely slow, with no energy, so it never wins and the search
goes on; in a fused group the other jobs are still measured.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Protocol, Sequence, runtime_checkable

from repro_torch.core import verify
from repro_torch.core.blocks import GradRefused
from repro_torch.obs import get_tracer


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


def _trial_args(job: MeasureJob) -> dict:
    """Span attributes for one measured trial (built only when tracing)."""
    out: dict[str, Any] = {"repeats": job.repeats, "warmup": job.warmup}
    if job.candidate is not None:
        out["candidate"] = str(job.candidate)[:120]
    return out


def _refused() -> verify.Measurement:
    """The measurement of a trial whose binding refused its gradient."""
    return verify.Measurement(seconds=math.inf, compile_seconds=0.0, repeats=0)


@runtime_checkable
class MeasurementExecutor(Protocol):
    """Times a batch of jobs; returns one Measurement per job, in order."""

    def run(
        self, jobs: Sequence[MeasureJob], meter: Any = None
    ) -> list[verify.Measurement]: ...


_METER_LOCK_GUARD = threading.Lock()


def meter_lock(meter: Any) -> threading.Lock | None:
    """The per-meter serialisation lock for ``exclusive`` meters.

    An exclusive meter reads a device-global counter, so its begin/end
    windows must never interleave — across worker threads of one executor
    AND across concurrent ``measure_many`` callers sharing the meter
    through one cache.  The lock therefore lives on the meter itself
    (created lazily, once), not on any single ``run()`` invocation.
    Non-exclusive meters (pure functions of the trial's own measurement)
    need no lock.
    """
    if meter is None or not getattr(meter, "exclusive", True):
        return None
    with _METER_LOCK_GUARD:
        lock = getattr(meter, "_metering_lock", None)
        if lock is None:
            lock = threading.Lock()
            meter._metering_lock = lock
    return lock


def run_job(job: MeasureJob, meter: Any = None) -> verify.Measurement:
    """Measure one job with the meter's begin/end bracketing the timed
    window; exclusive meters are serialised via their per-meter lock.

    Each job runs under a "trial" span on the process tracer (a no-op
    unless someone enabled it) — with ``DeviceParallelExecutor`` the spans
    land on each worker thread's own track, so the exported timeline shows
    the measurement overlap directly.  A ``GradRefused`` job closes the
    meter's window, drops its reading and measures infinitely slow."""
    tracer = get_tracer()
    span = (
        tracer.span("trial", **_trial_args(job))
        if tracer.enabled
        else contextlib.nullcontext()
    )
    with span:
        lock = meter_lock(meter)
        with lock if lock is not None else contextlib.nullcontext():
            if meter is not None:
                meter.begin()
            try:
                m = verify.measure(
                    job.fn,
                    job.args,
                    repeats=job.repeats,
                    warmup=job.warmup,
                    min_seconds=job.min_seconds,
                )
            except GradRefused:
                if meter is not None:  # stop the window; a refusal has no energy
                    meter.end(_refused(), space=job.space, candidate=job.candidate)
                return _refused()
            if meter is not None:
                m.energy_joules = meter.end(
                    m, space=job.space, candidate=job.candidate
                )
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


def _pin_to_device(job: MeasureJob, device: Any) -> MeasureJob:
    """Pin one job's work to a torch device: tensor args moved there with
    ``.to(device)`` and, on a CUDA device, the call run under
    ``torch.cuda.device`` so the variant's launches go to that card.
    Non-tensor args pass through untouched; the pinned call reports the
    job's ``warmup_calls``."""
    if device is None:
        return job
    import torch

    device = torch.device(device)
    args = tuple(
        a.to(device) if isinstance(a, torch.Tensor) else a for a in job.args
    )
    fn = job.fn
    scope = (
        (lambda: torch.cuda.device(device))
        if device.type == "cuda"
        else contextlib.nullcontext
    )

    def pinned(*a: Any, **kw: Any) -> Any:
        with scope():
            return fn(*a, **kw)

    pinned.warmup_calls = getattr(fn, "warmup_calls", 0)  # type: ignore[attr-defined]
    return dataclasses.replace(job, fn=pinned, args=args)


class DeviceParallelExecutor:
    """Thread-per-device concurrent measurement.

    Job *i* is pinned to ``devices[i % len(devices)]``; with one worker per
    device, at most one trial runs on a card at a time, so trials do not
    contend for the device they are timing.  The devices default to every
    visible CUDA card, or the CPU without one.  On a single-device host
    this degrades to serial execution with identical semantics.

    ``max_workers`` overrides the worker count (useful for tests, where
    concurrency beyond the device count is harmless on the CPU; on a card,
    two workers would overlap one trial's CUDA-graph capture with another
    thread's work).  With an ``exclusive`` PowerMeter attached, metered
    sections are serialised under the meter's own lock (see
    :func:`meter_lock`) — a device-global counter cannot attribute
    concurrent trials — so only the un-metered portion of the batch
    parallelises.
    """

    name = "device_parallel"

    def __init__(
        self, devices: Sequence[Any] | None = None, max_workers: int | None = None
    ) -> None:
        self.devices = list(devices) if devices is not None else None
        self.max_workers = max_workers

    def _devices(self) -> list[Any]:
        if self.devices is not None:
            return self.devices
        import torch

        if torch.cuda.is_available():
            return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        return [torch.device("cpu")]

    def run(
        self, jobs: Sequence[MeasureJob], meter: Any = None
    ) -> list[verify.Measurement]:
        jobs = list(jobs)
        if not jobs:
            return []
        devices = self._devices() or [None]
        workers = self.max_workers or len(devices)
        workers = max(1, min(workers, len(jobs)))
        if workers == 1:
            return SerialExecutor().run(jobs, meter=meter)
        pinned = [
            _pin_to_device(job, devices[i % len(devices)])
            for i, job in enumerate(jobs)
        ]
        with ThreadPoolExecutor(max_workers=workers) as pool:
            futures = [pool.submit(run_job, job, meter) for job in pinned]
            return [f.result() for f in futures]


class BatchedExecutor:
    """Fuse up to ``max_fuse`` short variants into one timed window.

    Per repeat, the whole group runs back-to-back inside a single window
    (repeated until ``min_seconds`` of wall time is spanned) and each
    variant's share is taken from per-variant timestamps ("events") inside
    the window.  This amortises timer and dispatch overhead that dominates
    sub-millisecond trials measured one at a time.

    Energy is metered once per fused window and apportioned to variants by
    their time share — an attribution model, so apportioned readings carry
    ``energy_provenance="estimated"`` even under a counter-backed meter.
    A meter whose ``end`` hook *requires* the candidate (per-candidate
    draw models) cannot attribute a multi-variant window at all: it gets
    space/candidate only for single-job groups, and a raising ``end``
    degrades the group's energy to None rather than aborting the search.
    A job that raises ``GradRefused`` leaves the group at its first
    refused call and measures infinitely slow, with no energy.
    """

    name = "batched"

    def __init__(self, max_fuse: int = 8) -> None:
        if max_fuse < 1:
            raise ValueError("max_fuse must be >= 1")
        self.max_fuse = max_fuse

    def run(
        self, jobs: Sequence[MeasureJob], meter: Any = None
    ) -> list[verify.Measurement]:
        jobs = list(jobs)
        out: list[verify.Measurement] = []
        for start in range(0, len(jobs), self.max_fuse):
            out.extend(self._run_group(jobs[start : start + self.max_fuse], meter))
        return out

    def _run_group(
        self, group: Sequence[MeasureJob], meter: Any = None
    ) -> list[verify.Measurement]:
        if not group:
            return []
        tracer = get_tracer()
        span = (
            tracer.span("trial-group", fused=len(group))
            if tracer.enabled
            else contextlib.nullcontext()
        )
        with span:
            return self._run_group_timed(group, meter)

    def _run_group_timed(
        self, group: Sequence[MeasureJob], meter: Any = None
    ) -> list[verify.Measurement]:
        perf = time.perf_counter
        refused: set[int] = set()

        def call(i: int, job: MeasureJob) -> None:
            try:
                verify._block(job.fn(*job.args))
            except GradRefused:
                refused.add(i)

        warm: list[float] = []
        for i, job in enumerate(group):
            t0 = perf()
            for _ in range(verify.warmup_count(job.fn, job.warmup)):
                if i not in refused:
                    call(i, job)
            warm.append(perf() - t0)
        repeats = max(max(j.repeats for j in group), 1)
        min_seconds = max(j.min_seconds for j in group)

        lock = meter_lock(meter)
        with lock if lock is not None else contextlib.nullcontext():
            if meter is not None:
                meter.begin()
            window_t0 = perf()
            per_variant: list[list[float]] = [[] for _ in group]
            for _ in range(repeats):
                t0 = perf()
                shares = [0.0] * len(group)
                calls = 0
                while True:
                    for i, job in enumerate(group):
                        if i in refused:
                            continue
                        ti = perf()
                        call(i, job)
                        shares[i] += perf() - ti
                    calls += 1
                    if perf() - t0 >= min_seconds:
                        break
                for i in range(len(group)):
                    per_variant[i].append(shares[i] / calls)
            window_seconds = perf() - window_t0
            window_watts: float | None = None
            if meter is not None:
                window = verify.Measurement(
                    seconds=max(window_seconds, 1e-9),
                    compile_seconds=0.0,
                    repeats=1,
                )
                # a fused window has no single candidate to attribute;
                # per-candidate meters get one only for single-job groups,
                # and a meter that cannot cope degrades to no reading
                kwargs = (
                    dict(space=group[0].space, candidate=group[0].candidate)
                    if len(group) == 1
                    else {}
                )
                try:
                    window_joules = meter.end(window, **kwargs)
                except Exception:  # noqa: BLE001 — degrade, don't abort
                    window_joules = None
                if window_joules is not None:
                    window_watts = window_joules / max(window_seconds, 1e-9)

        out = []
        for i, job in enumerate(group):
            if i in refused:
                out.append(_refused())
                continue
            times = sorted(per_variant[i])
            med = times[len(times) // 2]
            m = verify.Measurement(
                seconds=max(med, 1e-9),
                compile_seconds=max(warm[i] - med, 0.0),
                repeats=repeats,
            )
            if window_watts is not None:
                m.energy_joules = window_watts * m.seconds
                # apportioned by time share, never a direct counter read
                m.energy_provenance = "estimated"
            out.append(m)
        return out


_NAMED_EXECUTORS: dict[str, Callable[[], Any]] = {
    "serial": SerialExecutor,
    "device_parallel": DeviceParallelExecutor,
    "device-parallel": DeviceParallelExecutor,
    "batched": BatchedExecutor,
}


#: every name :func:`resolve_executor` takes (the CLIs' ``--executor`` choices)
EXECUTOR_NAMES: tuple[str, ...] = tuple(_NAMED_EXECUTORS)


def resolve_executor(executor: "MeasurementExecutor | str | None") -> Any:
    """Accept an executor instance, a name, or None (-> SerialExecutor)."""
    if executor is None:
        return SerialExecutor()
    if isinstance(executor, str):
        if executor not in _NAMED_EXECUTORS:
            raise KeyError(
                f"unknown executor '{executor}'; "
                f"known: {sorted(set(_NAMED_EXECUTORS))}"
            )
        return _NAMED_EXECUTORS[executor]()
    if not hasattr(executor, "run"):
        raise TypeError(
            f"executor must provide .run(jobs, meter=None), got "
            f"{type(executor).__name__}"
        )
    return executor
