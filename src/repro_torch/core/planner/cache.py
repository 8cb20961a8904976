"""MeasurementCache — shared, thread-safe memoisation of measured trials
(the port of ``repro/core/planner/cache.py``).

On real hardware every trial is a compile+run (hours per FPGA candidate in
the paper), so no strategy may re-measure a pattern another strategy — or an
earlier generation — already visited.  Entries are keyed by the space
signature plus the canonical (order-independent) pattern, and keep the
compile-time / runtime split from ``verify.measure`` so search-time curves
(paper Fig. 4) stay reconstructable — ``records()`` returns them in
measurement order.

The *timed work* itself is delegated to an executor
(``repro_torch.metering.executors``): the ``SerialExecutor`` measures one
candidate after another.  The reference's device-parallel and batched
executors, and its metrics registry, are not ported yet: asking for them
raises ``NotImplementedError``.  ``measure_many`` is the bulk path
strategies feed whole GA generations / combine rounds through; ``measure``
is the single-trial convenience over it.

Record mutation and hit/miss accounting are guarded by one lock.  The
reference also keeps an in-flight map so concurrent measurers of one key
wait for each other; with only the serial executor ported, no two
measurements of a cache ever run at once, so that map is not carried over.
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

        ``executor``: optional executor (instance or name) that runs the
        timed work; only the serial one is ported, and it is the default.

        ``metrics``: the reference's hit/miss metrics registry, not ported
        (``NotImplementedError`` when given).
        """
        if metrics is not None:
            raise NotImplementedError(
                "MeasurementCache(metrics=...) is not ported yet"
            )
        self._data: dict[tuple, CacheRecord] = {}
        self.meter = meter
        self._executor = None
        if executor is not None:
            self.executor = executor
        self.hits = 0
        self.misses = 0
        self._seq = 0
        self._lock = threading.Lock()

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
        the whole miss set to the executor at once.  Returns
        ``(measurement, cached)`` per candidate, in input order; duplicate
        candidates within one call are measured once (the later ones
        replay as hits).
        """
        from repro_torch.metering.executors import MeasureJob, SerialExecutor

        executor = self._executor or SerialExecutor()
        keys = [self.key_for(space, cand, args) for cand in cands]
        with self._lock:
            misses = {k: c for k, c in zip(keys, cands) if k not in self._data}
        jobs = [
            MeasureJob(
                fn=space.build(cand), args=args, repeats=repeats,
                min_seconds=min_seconds, warmup=warmup, space=space,
                candidate=cand,
            )
            for cand in misses.values()
        ]
        measured = executor.run(jobs, meter=self.meter) if jobs else []
        if len(measured) != len(jobs):
            raise RuntimeError(
                f"executor {type(executor).__name__} returned {len(measured)} "
                f"measurements for {len(jobs)} jobs; executors must return "
                "one Measurement per job, in order"
            )
        results: list[tuple[verify.Measurement, bool]] = []
        with self._lock:
            for key, m in zip(misses, measured):
                self._data[key] = CacheRecord(key, m, seq=self._seq)
                self._seq += 1
                self.misses += 1
            fresh = set(misses)
            for key in keys:
                rec = self._data[key]
                if key in fresh:
                    fresh.discard(key)  # its first occurrence: the measurement
                    results.append((rec.measurement, False))
                else:
                    rec.hits += 1
                    self.hits += 1
                    results.append((rec.measurement, True))
        return results

    @property
    def evaluations(self) -> int:
        """Number of actually-measured (non-cached) trials so far."""
        return self.misses
