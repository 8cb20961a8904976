"""Reading the profiler's trace of a stretch of the window.

The traced run wraps a stretch of whole engine steps in
``torch.profiler`` with the annotation :data:`WINDOW`, exports the Chrome
trace into the run's scratch directory, and reads it back here: the device
events (kernels, copies, sets) clipped to the annotation, their union (the
busy seconds), each kernel's time by name, and the idle gaps between
device events, the longest each named by the innermost host event that
covers its middle.
"""

from __future__ import annotations

import dataclasses
import json
import re
from collections import defaultdict

import numpy as np

WINDOW = "bench.traced_stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
#: the longest gaps each named by a host event; the rest are summed
LABELLED_GAPS = 200


@dataclasses.dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    #: (short name, seconds) of every device event in the stretch
    events: list[tuple[str, float]]
    #: idle seconds by what the host was doing, longest first
    idle_by_host: list[tuple[str, float]]

    def seconds_of(self, pattern: str) -> float:
        """Device seconds of the events whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(s for name, s in self.events if rx.search(name))

    def top_ops(self, n: int = 10) -> list[list]:
        by = defaultdict(float)
        for name, s in self.events:
            by[name] += s
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def short_name(name: str) -> str:
    """A kernel's function name without its return type, template
    arguments and parameters."""
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip() or name


def _merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def read(path: str) -> DeviceTrace | None:
    """The stretch's device trace, or None when the trace holds no
    annotated stretch or no device event (no card, or no tracing)."""
    with open(path, encoding="utf-8") as f:
        events = json.load(f).get("traceEvents", [])
    windows = [e for e in events if e.get("name") == WINDOW and "dur" in e]
    if not windows:
        return None
    w0 = min(float(e["ts"]) for e in windows)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in windows)
    dev, spans = [], []
    host = []
    for e in events:
        if "dur" not in e or "ts" not in e:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                dev.append((short_name(e.get("name", "?")), (b - a) * 1e-6))
                spans.append((a, b))
        elif cat in HOST_CATS and e.get("name") != WINDOW and b > w0 and a < w1:
            host.append((a, b, e.get("name", "?")))
    if not dev:
        return None
    busy = _merge(spans)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = sorted(((b - a, (a + b) / 2) for a, b in zip(edges[::2], edges[1::2]) if b > a),
                  reverse=True)
    host.sort(key=lambda h: h[1] - h[0])  # innermost (shortest) first
    h0 = np.array([h[0] for h in host]) if host else np.zeros(0)
    h1 = np.array([h[1] for h in host]) if host else np.zeros(0)
    idle = defaultdict(float)
    for i, (length, mid) in enumerate(gaps):
        if i < LABELLED_GAPS:
            hit = np.flatnonzero((h0 <= mid) & (mid <= h1))
            label = host[hit[0]][2] if hit.size else "(no host event)"
        else:
            label = f"(gaps beyond the {LABELLED_GAPS} longest)"
        idle[label] += length * 1e-6
    return DeviceTrace(
        window_s=(w1 - w0) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        events=dev,
        idle_by_host=sorted(idle.items(), key=lambda kv: -kv[1]),
    )
