"""Step monitoring: throughput EMA + straggler detection (a copy of
``repro/runtime/monitor.py``; the serve engine feeds its decode steps to a
:class:`StepMonitor` whose histogram is ``serve_step_seconds``).

At 1000+ nodes the dominant soft failure is the slow host (flaky NIC,
thermal throttle, noisy neighbour).  The monitor keeps a rolling step-time
window; a step exceeding ``threshold`` x the rolling median is flagged, and
a host flagged ``patience`` times in a row is reported for eviction — the
launcher responds by checkpoint-restart without the straggler (elastic
downsize), which is cheaper than letting one host set the fleet's pace.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from collections import deque
from typing import Callable


@dataclasses.dataclass
class StragglerEvent:
    step: int
    host: int
    seconds: float
    median: float


class StepMonitor:
    """``histogram`` (optional) is a write-through bridge into a
    ``repro_torch.obs.MetricsRegistry`` instrument: every observed step duration
    is also recorded there (``.observe(seconds)``), so the monitor's
    rolling window and the exported latency histogram are fed by the same
    observation — the numbers are never computed twice."""

    def __init__(
        self,
        window: int = 32,
        threshold: float = 2.0,
        patience: int = 3,
        on_straggler: Callable[[StragglerEvent], None] | None = None,
        histogram=None,
    ) -> None:
        self.window: deque[float] = deque(maxlen=window)
        self.threshold = threshold
        self.patience = patience
        self.on_straggler = on_straggler
        self.histogram = histogram
        self.events: list[StragglerEvent] = []
        self._consecutive: dict[int, int] = {}
        self.flagged_hosts: set[int] = set()
        self._t0: float | None = None
        self.steps = 0
        self.total_time = 0.0

    # -- timing ------------------------------------------------------------
    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, step: int, host: int = 0) -> float:
        assert self._t0 is not None
        dt = time.perf_counter() - self._t0
        self.observe(step, dt, host)
        return dt

    def observe(self, step: int, seconds: float, host: int = 0) -> None:
        self.steps += 1
        self.total_time += seconds
        if self.histogram is not None:
            self.histogram.observe(seconds)
        med = statistics.median(self.window) if self.window else seconds
        self.window.append(seconds)
        if len(self.window) >= 8 and seconds > self.threshold * med:
            ev = StragglerEvent(step, host, seconds, med)
            self.events.append(ev)
            self._consecutive[host] = self._consecutive.get(host, 0) + 1
            if self._consecutive[host] >= self.patience:
                self.flagged_hosts.add(host)
            if self.on_straggler:
                self.on_straggler(ev)
        else:
            self._consecutive[host] = 0

    # -- reporting ------------------------------------------------------------
    def throughput(self, tokens_per_step: int) -> float:
        if self.total_time == 0:
            return 0.0
        return self.steps * tokens_per_step / self.total_time

    def median_step(self) -> float:
        return statistics.median(self.window) if self.window else 0.0
