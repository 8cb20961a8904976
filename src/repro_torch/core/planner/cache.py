"""MeasurementCache — shared, thread-safe memoisation of measured trials
(the port of ``repro/core/planner/cache.py``).

On real hardware every trial is a compile+run (hours per FPGA candidate in
the paper), so no strategy may re-measure a pattern another strategy — or an
earlier generation — already visited.  Entries are keyed by the space
signature plus the canonical (order-independent) pattern, and keep the
compile-time / runtime split from ``verify.measure`` so search-time curves
(paper Fig. 4) stay reconstructable — ``records()`` returns them in
measurement order for ``repro_torch.metering.report.search_trace``.

The *timed work* itself is delegated to a pluggable
``repro_torch.metering.executors.MeasurementExecutor``: the default
``SerialExecutor`` reproduces the historical one-after-another behaviour,
``DeviceParallelExecutor`` measures independent candidates concurrently
(one per CUDA device), and ``BatchedExecutor`` fuses short variants into
one timed window.  ``measure_many`` is the bulk path strategies feed whole
GA generations / combine rounds through; ``measure`` is the single-trial
convenience over it.

Thread safety: record mutation and hit/miss accounting are guarded by one
lock, and an in-flight map prevents two threads from measuring the same key
concurrently (the second waits and replays the first's measurement as a
hit) — required once ``DeviceParallelExecutor`` drives the cache from
worker threads.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Sequence

from repro_torch.core import verify
from repro_torch.core.planner.space import Candidate, SearchSpace


@dataclasses.dataclass
class CacheRecord:
    key: tuple
    measurement: verify.Measurement
    hits: int = 0
    seq: int = 0  # insertion order (search-trace reconstruction)


def args_fingerprint(args: Sequence[Any]) -> tuple:
    """Cheap structural identity of a measured workload's arguments.

    Arrays are keyed by shape+dtype (not contents — re-hashing a 2048^2
    input per lookup would dwarf short measurements), scalars by value.
    Together with the space signature (which carries the builder tag) this
    keeps one application's timings from answering for another's.
    """
    parts = []
    for a in args:
        shape = getattr(a, "shape", None)
        if shape is not None:
            parts.append(("array", tuple(shape), str(getattr(a, "dtype", ""))))
        elif isinstance(a, (bool, int, float, str, bytes, type(None))):
            # type name included: 1, 1.0 and True hash/compare equal in
            # Python but can select different computation paths
            parts.append(("value", type(a).__name__, a))
        else:
            parts.append(("object", type(a).__name__))
    return tuple(parts)


class MeasurementCache:
    def __init__(
        self, meter: Any = None, executor: Any = None, metrics: Any = None
    ) -> None:
        """``meter``: optional ``objectives.PowerMeter`` whose begin/end
        hooks bracket every new measurement; the joules it reports are
        stored on the measurement (and replayed on cache hits) so
        energy-aware objectives can rank trials.  Attach the meter for the
        cache's whole lifetime: entries measured before a meter existed
        replay ``energy_joules=None``, which energy-aware objectives score
        with their time-proportional fallback — mixing metered and
        estimated joules in one ranking (each measurement's
        ``energy_provenance`` marks which it was).

        ``executor``: optional ``repro_torch.metering`` executor (instance or
        name) that runs the timed work; defaults to serial measurement.

        ``metrics``: optional ``repro_torch.obs.MetricsRegistry`` — hit/miss
        accounting writes through to ``planner_cache_{hits,misses}_total``
        (same increment that feeds ``self.hits``/``self.misses``, so the
        exported counters can never drift from the legacy fields).
        """
        self._data: dict[tuple, CacheRecord] = {}
        self.meter = meter
        self._executor = None
        if executor is not None:
            self.executor = executor
        # counters must exist before the hits/misses property setters run
        self._hits_c = self._misses_c = None
        if metrics is not None:
            self._hits_c = metrics.counter(
                "planner_cache_hits_total",
                "measurements replayed from the shared cache",
            )
            self._misses_c = metrics.counter(
                "planner_cache_misses_total",
                "measurements actually taken (compile+run trials)",
            )
        self.hits = 0
        self.misses = 0
        self._seq = 0
        self._lock = threading.Lock()
        self._inflight: dict[tuple, threading.Event] = {}

    # hit/miss accounting: plain-looking counters whose setters forward
    # positive deltas to the registry, so every `self.hits += 1` site —
    # present and future — feeds the exported metric automatically
    @property
    def hits(self) -> int:
        return self._hits

    @hits.setter
    def hits(self, value: int) -> None:
        delta = value - getattr(self, "_hits", 0)
        if delta > 0 and self._hits_c is not None:
            self._hits_c.inc(delta)
        self._hits = value

    @property
    def misses(self) -> int:
        return self._misses

    @misses.setter
    def misses(self, value: int) -> None:
        delta = value - getattr(self, "_misses", 0)
        if delta > 0 and self._misses_c is not None:
            self._misses_c.inc(delta)
        self._misses = value

    @property
    def executor(self) -> Any:
        """The configured executor, or None for the serial default."""
        return self._executor

    @executor.setter
    def executor(self, value: Any) -> None:
        if value is None:
            self._executor = None
            return
        from repro_torch.metering.executors import resolve_executor

        self._executor = resolve_executor(value)

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def key_for(
        self, space: SearchSpace, cand: Candidate, args: Sequence[Any] = ()
    ) -> tuple:
        return (space.signature(), args_fingerprint(args), space.canonical(cand))

    def lookup(
        self, space: SearchSpace, cand: Candidate, args: Sequence[Any] = ()
    ) -> verify.Measurement | None:
        with self._lock:
            rec = self._data.get(self.key_for(space, cand, args))
            return None if rec is None else rec.measurement

    def records(self) -> list[CacheRecord]:
        """All records in measurement (insertion) order — the raw material
        for search-trace reconstruction (paper Fig. 4)."""
        with self._lock:
            return sorted(self._data.values(), key=lambda r: r.seq)

    def measure(
        self,
        space: SearchSpace,
        cand: Candidate,
        args: Sequence[Any],
        repeats: int = 3,
        min_seconds: float = 0.0,
        warmup: int = 1,
    ) -> tuple[verify.Measurement, bool]:
        """Measure a candidate, or return the cached measurement.

        Returns ``(measurement, cached)`` where ``cached`` is True when no
        new measurement was taken.  A hit replays the stored measurement
        regardless of ``repeats``/``min_seconds`` — the first measurement
        of a pattern wins.
        """
        return self.measure_many(
            space,
            [cand],
            args,
            repeats=repeats,
            min_seconds=min_seconds,
            warmup=warmup,
        )[0]

    def measure_many(
        self,
        space: SearchSpace,
        cands: Sequence[Candidate],
        args: Sequence[Any],
        repeats: int = 3,
        min_seconds: float = 0.0,
        warmup: int = 1,
    ) -> list[tuple[verify.Measurement, bool]]:
        """Bulk path: measure every candidate not already cached, handing
        the whole miss set to the executor at once so independent trials
        can run concurrently (or fused).  Returns ``(measurement, cached)``
        per candidate, in input order; duplicate candidates within one call
        are measured once.
        """
        from repro_torch.metering.executors import MeasureJob, SerialExecutor

        executor = self._executor
        if executor is None:
            executor = SerialExecutor()
        cands = list(cands)
        results: list[tuple[verify.Measurement, bool] | None] = [None] * len(
            cands
        )
        keys = [self.key_for(space, cand, args) for cand in cands]

        while True:
            to_measure: dict[tuple, Candidate] = {}
            primary: dict[tuple, int] = {}  # key -> index that measures it
            wait_for: list[threading.Event] = []
            with self._lock:
                for i, (key, cand) in enumerate(zip(keys, cands)):
                    if results[i] is not None:
                        continue
                    rec = self._data.get(key)
                    if rec is not None:
                        rec.hits += 1
                        self.hits += 1
                        results[i] = (rec.measurement, True)
                    elif key in to_measure:
                        # duplicate within this batch: measured once by its
                        # first occurrence, replayed below as a hit
                        pass
                    elif key in self._inflight:
                        # another thread is measuring this key right now;
                        # wait for its record instead of re-measuring
                        wait_for.append(self._inflight[key])
                    else:
                        to_measure[key] = cand
                        primary[key] = i
                        self._inflight[key] = threading.Event()

            if to_measure:
                miss_keys = list(to_measure)
                try:
                    jobs = [
                        MeasureJob(
                            fn=space.build(to_measure[key]),
                            args=args,
                            repeats=repeats,
                            min_seconds=min_seconds,
                            warmup=warmup,
                            space=space,
                            candidate=to_measure[key],
                        )
                        for key in miss_keys
                    ]
                    measured = executor.run(jobs, meter=self.meter)
                    if len(measured) != len(jobs):
                        raise RuntimeError(
                            f"executor {type(executor).__name__} returned "
                            f"{len(measured)} measurements for {len(jobs)} "
                            "jobs; executors must return one Measurement "
                            "per job, in order"
                        )
                except BaseException:
                    # release the in-flight claims so waiting threads can
                    # take over the measurement instead of deadlocking
                    with self._lock:
                        for key in miss_keys:
                            ev = self._inflight.pop(key, None)
                            if ev is not None:
                                ev.set()
                    raise
                with self._lock:
                    for key, m in zip(miss_keys, measured):
                        self._data[key] = CacheRecord(
                            key, m, seq=self._seq
                        )
                        self._seq += 1
                        self.misses += 1
                        results[primary[key]] = (m, False)
                        ev = self._inflight.pop(key, None)
                        if ev is not None:
                            ev.set()

            for ev in wait_for:
                # bounded wait: re-classification below retries (and takes
                # the measurement over) if the other thread failed or is
                # still running
                ev.wait(timeout=60.0)

            with self._lock:
                for i, key in enumerate(keys):
                    if results[i] is not None:
                        continue
                    rec = self._data.get(key)
                    if rec is not None:
                        # in-batch duplicate or another thread's record:
                        # replayed, so it counts as a hit
                        rec.hits += 1
                        self.hits += 1
                        results[i] = (rec.measurement, True)
                done = all(r is not None for r in results)
            if done:
                return [r for r in results if r is not None]

    @property
    def evaluations(self) -> int:
        """Number of actually-measured (non-cached) trials so far."""
        return self.misses
