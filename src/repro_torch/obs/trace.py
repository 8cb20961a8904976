"""Low-overhead structured tracing: typed spans on a thread-safe ring (a
copy of ``repro/obs/trace.py``).

The paper's loop decides *where* to offload from measurements of the
running system; this module records *what the system did and when*, so a
slow step has an explanation, not just an aggregate.  A :class:`Tracer`
collects :class:`SpanRecord`s — complete spans (``ph="X"``), instant
events (``ph="i"``) — into a bounded ring buffer (old records drop, the
serve loop never blocks on its own telemetry) and exports them as
Chrome/Perfetto ``trace_event`` JSON (open in https://ui.perfetto.dev) or
a plain JSONL stream.

Two usage shapes::

    with tracer.span("decode", step=12, batch=3):
        ...                                  # timed around the body

    tracer.add_span("queue", t0, t1, tid=track, request=7)   # retroactive

Retroactive spans let the engine place a request's whole lifecycle
(queued -> admitted -> prefill -> decode steps -> complete) on a virtual
per-request *track* from timestamps it already keeps, without holding a
span object open across scheduler callbacks.

**Disabled cost is the design constraint**: ``span()`` on a disabled
tracer returns one shared no-op singleton (no record, no buffer touch),
``event()``/``add_span()`` return immediately, and hot-path callers are
expected to guard argument construction behind ``tracer.enabled``.  The
serving benchmark's acceptance gate is that a disabled tracer is
unmeasurable in tok/s.

All timestamps are ``time.perf_counter()`` seconds — the same clock the
engine stamps on requests — made relative to the tracer's ``epoch`` at
export time.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from collections import deque
from typing import Any, Iterable, TextIO

__all__ = [
    "NULL_SPAN",
    "SpanRecord",
    "Tracer",
    "get_tracer",
    "set_tracer",
]


@dataclasses.dataclass
class SpanRecord:
    """One trace record: a complete span (``ph="X"``, ``t0 <= t1``) or an
    instant event (``ph="i"``, ``t0 == t1``)."""

    name: str
    t0: float  # perf_counter seconds
    t1: float
    tid: int  # track: a real thread ident or a virtual per-request track
    args: dict | None = None
    ph: str = "X"

    @property
    def duration(self) -> float:
        return self.t1 - self.t0


class _NullSpan:
    """The shared no-op context manager a disabled tracer hands out."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False


NULL_SPAN = _NullSpan()


class _Span:
    """A live ``with tracer.span(...)`` body; records itself at exit."""

    __slots__ = ("_tracer", "name", "tid", "args", "_t0")

    def __init__(
        self, tracer: "Tracer", name: str, tid: int, args: dict | None
    ) -> None:
        self._tracer = tracer
        self.name = name
        self.tid = tid
        self.args = args

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> bool:
        self._tracer._record(
            SpanRecord(
                self.name, self._t0, time.perf_counter(), self.tid, self.args
            )
        )
        return False


class Tracer:
    """Thread-safe span/event recorder with a bounded ring buffer.

    ``enabled=False`` (the default of the module-level tracer) makes every
    entry point a near-free no-op; flip :attr:`enabled` or install an
    enabled tracer with :func:`set_tracer` to start recording.  ``capacity``
    bounds memory: the ring keeps the newest records and counts the rest in
    :attr:`dropped` (reported by the exporters, never silently).
    """

    def __init__(self, capacity: int = 65536, enabled: bool = True) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.enabled = enabled
        self._buf: deque[SpanRecord] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._track_names: dict[int, str] = {}
        self.dropped = 0
        self.epoch = time.perf_counter()
        self.epoch_unix = time.time()

    # -- recording ---------------------------------------------------------
    def span(self, name: str, tid: int | None = None, **args: Any):
        """Context manager timing its body into one complete span.  On a
        disabled tracer this returns the shared :data:`NULL_SPAN` singleton
        (callers with expensive args should guard on :attr:`enabled`)."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(
            self,
            name,
            tid if tid is not None else threading.get_ident(),
            args or None,
        )

    def event(self, name: str, tid: int | None = None, **args: Any) -> None:
        """Record one instant event."""
        if not self.enabled:
            return
        t = time.perf_counter()
        self._record(
            SpanRecord(
                name,
                t,
                t,
                tid if tid is not None else threading.get_ident(),
                args or None,
                ph="i",
            )
        )

    def add_span(
        self,
        name: str,
        t0: float,
        t1: float,
        tid: int | None = None,
        **args: Any,
    ) -> None:
        """Record a retroactive complete span from caller-held
        ``perf_counter`` timestamps (e.g. a request's queue wait)."""
        if not self.enabled:
            return
        self._record(
            SpanRecord(
                name,
                t0,
                max(t1, t0),
                tid if tid is not None else threading.get_ident(),
                args or None,
            )
        )

    def name_track(self, tid: int, name: str) -> None:
        """Label a track (thread or virtual id) in the exported trace."""
        if not self.enabled:
            return
        with self._lock:
            self._track_names[tid] = name

    def _record(self, rec: SpanRecord) -> None:
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self.dropped += 1
            self._buf.append(rec)

    # -- reading / lifecycle ----------------------------------------------
    def records(self) -> list[SpanRecord]:
        """Snapshot of the ring, oldest first."""
        with self._lock:
            return list(self._buf)

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def clear(self) -> None:
        """Drop everything recorded so far (e.g. after a warmup phase)."""
        with self._lock:
            self._buf.clear()
            self.dropped = 0

    # -- exporters ---------------------------------------------------------
    def _ts_us(self, t: float) -> float:
        return max(t - self.epoch, 0.0) * 1e6

    def to_chrome(self) -> dict:
        """Chrome/Perfetto ``trace_event`` JSON object (one process, one
        track per tid, microsecond timestamps relative to the tracer
        epoch).  Complete spans use ``ph="X"`` with ``dur``; instants use
        ``ph="i"`` with thread scope."""
        with self._lock:
            records = sorted(self._buf, key=lambda r: r.t0)
            track_names = dict(self._track_names)
            dropped = self.dropped
        events: list[dict] = []
        for tid, name in sorted(track_names.items()):
            events.append({
                "ph": "M", "pid": 0, "tid": tid, "name": "thread_name",
                "args": {"name": name},
            })
        for rec in records:
            ev: dict = {
                "name": rec.name,
                "ph": rec.ph,
                "pid": 0,
                "tid": rec.tid,
                "ts": self._ts_us(rec.t0),
            }
            if rec.ph == "X":
                ev["dur"] = max(rec.t1 - rec.t0, 0.0) * 1e6
            else:
                ev["s"] = "t"  # thread-scoped instant
            if rec.args:
                ev["args"] = rec.args
            events.append(ev)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "tracer": "repro_torch.obs",
                "epoch_unix": self.epoch_unix,
                "dropped_records": dropped,
            },
        }

    def write_chrome(self, path: str) -> None:
        """Write :meth:`to_chrome` JSON — loadable in ``chrome://tracing``
        and https://ui.perfetto.dev."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
            f.write("\n")

    def iter_jsonl(self) -> Iterable[str]:
        for rec in sorted(self.records(), key=lambda r: r.t0):
            yield json.dumps({
                "name": rec.name,
                "ph": rec.ph,
                "tid": rec.tid,
                "ts": self._ts_us(rec.t0),
                "dur": max(rec.t1 - rec.t0, 0.0) * 1e6,
                "args": rec.args or {},
            })

    def write_jsonl(self, path_or_file: "str | TextIO") -> None:
        """One JSON record per line — the streaming/grep-friendly form."""
        if hasattr(path_or_file, "write"):
            for line in self.iter_jsonl():
                path_or_file.write(line + "\n")
            return
        with open(path_or_file, "w") as f:
            for line in self.iter_jsonl():
                f.write(line + "\n")


#: Module-level default tracer: disabled until someone opts in.  Library
#: code (engine, executors, session) records against this when not handed
#: an explicit tracer, so enabling observability is one `set_tracer` call.
_default_tracer = Tracer(capacity=1, enabled=False)


def get_tracer() -> Tracer:
    """The process-default tracer (disabled no-op unless installed)."""
    return _default_tracer


def set_tracer(tracer: Tracer | None) -> Tracer:
    """Install ``tracer`` as the process default (None restores the
    disabled no-op default).  Returns the installed tracer."""
    global _default_tracer
    if tracer is None:
        tracer = Tracer(capacity=1, enabled=False)
    _default_tracer = tracer
    return tracer
