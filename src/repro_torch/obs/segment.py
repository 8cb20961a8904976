"""Host segments: named stretches of a program's own host code.

A :class:`Segment` times one stretch with one pair of
``time.perf_counter`` reads and hands them to its owner's callback (the
serve engine adds them to its telemetry and, while its tracer is enabled,
records a span).  While a ``torch.profiler`` capture is recording, the
stretch is also a ``record_function`` range named ``serve.<name>``
(:func:`annotation`): a ``user_annotation`` event on the profiler's own
clock, beside the device's events, so the idle gaps the host's Python
leaves between device work carry the segment's name.  With no capture
recording, the range is never created: the guard is one read of the
profiler's flag, where an unguarded ``record_function`` costs tens of
microseconds a call.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch
from torch.autograd import profiler as _autograd_profiler

from repro_torch.obs.trace import NULL_SPAN

#: prefix of a segment's profiler range
PREFIX = "serve."


def annotation(label: str):
    """A ``record_function`` range named ``label`` while a profiler
    capture is recording, else the shared no-op :data:`NULL_SPAN`."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(label)
    return NULL_SPAN


class Segment:
    """One named stretch of host code, entered as a context manager call
    after call; ``done(name, t0, t1)`` receives each call's two clock
    reads.  One instance serves every call, so a segment never encloses
    itself."""

    __slots__ = ("name", "label", "_done", "_t0", "_range")

    def __init__(self, name: str, done: Callable[[str, float, float], None]) -> None:
        self.name = name
        self.label = PREFIX + name
        self._done = done
        self._t0 = 0.0
        self._range: Any = NULL_SPAN

    def __enter__(self) -> "Segment":
        self._range = annotation(self.label)
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> bool:
        t1 = time.perf_counter()
        self._done(self.name, self._t0, t1)
        self._range.__exit__(*exc)
        self._range = NULL_SPAN
        return False
