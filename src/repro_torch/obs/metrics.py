"""MetricsRegistry: counters / gauges / exponential-bucket histograms (a copy
of ``repro/obs/metrics.py``).

One registry per engine (or process) replaces the ad-hoc telemetry dicts
that grew around the serve loop: every number the re-planner, the
power-aware scheduler or a cluster router wants to watch is registered
once, updated in place, and rendered in Prometheus text exposition format
(``registry.render_prometheus()``), optionally served over HTTP by
:class:`MetricsServer` (stdlib ``http.server``, no new dependencies).

Instruments are *families*: ``registry.counter("serve_phase_tokens_total",
"...", labelnames=("phase",))`` returns a family whose ``labels(phase=
"decode")`` children carry the values.  An unlabeled family acts as its
own single child (``family.inc()`` / ``.set()`` / ``.observe()``).

Histograms use cumulative exponential buckets (latency-shaped: equal
resolution per octave) and render the standard ``_bucket``/``_sum``/
``_count`` triplet with an ``le="+Inf"`` terminal bucket.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Any, Sequence

__all__ = [
    "MetricsRegistry",
    "MetricsServer",
    "exponential_buckets",
]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def exponential_buckets(
    start: float = 1e-4, factor: float = 2.0, count: int = 16
) -> tuple[float, ...]:
    """``count`` upper bounds growing geometrically from ``start``.  The
    default (100µs .. ~3.3s at factor 2) spans serve-step latencies."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("need start > 0, factor > 1, count >= 1")
    return tuple(start * factor**i for i in range(count))


def _escape_help(text: str) -> str:
    return text.replace("\\", r"\\").replace("\n", r"\n")


def _escape_label_value(value: str) -> str:
    return (
        value.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")
    )


def _fmt(value: float) -> str:
    """Prometheus sample value formatting: integers without the
    trailing .0, +Inf spelled the Prometheus way."""
    if value == math.inf:
        return "+Inf"
    if value == -math.inf:
        return "-Inf"
    if float(value).is_integer() and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


class _Child:
    """One labeled (or the sole unlabeled) instrument instance."""

    __slots__ = ("kind", "value", "sum", "counts", "_buckets", "_lock")

    def __init__(
        self, kind: str, buckets: tuple[float, ...] | None, lock: threading.Lock
    ) -> None:
        self.kind = kind
        self.value = 0.0
        self.sum = 0.0
        self._buckets = buckets
        self.counts = [0] * (len(buckets) + 1) if buckets is not None else None
        self._lock = lock

    def inc(self, amount: float = 1.0) -> None:
        if self.kind == "counter" and amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        if self.kind != "gauge":
            raise TypeError(f"dec() on a {self.kind}")
        with self._lock:
            self.value -= amount

    def set(self, value: float) -> None:
        if self.kind != "gauge":
            raise TypeError(f"set() on a {self.kind}")
        with self._lock:
            self.value = float(value)

    def observe(self, value: float) -> None:
        if self.kind != "histogram":
            raise TypeError(f"observe() on a {self.kind}")
        value = float(value)
        with self._lock:
            self.sum += value
            self.value += 1  # observation count
            assert self.counts is not None and self._buckets is not None
            for i, bound in enumerate(self._buckets):
                if value <= bound:
                    self.counts[i] += 1
                    break
            else:
                self.counts[-1] += 1  # +Inf overflow bucket

    def _reset(self) -> None:
        with self._lock:
            self.value = 0.0
            self.sum = 0.0
            if self.counts is not None:
                self.counts = [0] * len(self.counts)


class _Family:
    """A named metric plus its labeled children."""

    def __init__(
        self,
        name: str,
        help_text: str,
        kind: str,
        labelnames: tuple[str, ...],
        buckets: tuple[float, ...] | None = None,
    ) -> None:
        self.name = name
        self.help = help_text
        self.kind = kind
        self.labelnames = labelnames
        self.buckets = buckets
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], _Child] = {}
        if not labelnames:
            self._children[()] = _Child(kind, buckets, self._lock)

    def labels(self, **labels: Any) -> _Child:
        if tuple(sorted(labels)) != tuple(sorted(self.labelnames)):
            raise KeyError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(labels)}"
            )
        key = tuple(str(labels[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = _Child(self.kind, self.buckets, self._lock)
                self._children[key] = child
        return child

    def _sole(self) -> _Child:
        if self.labelnames:
            raise KeyError(
                f"{self.name} is labeled by {self.labelnames}; "
                "use .labels(...)"
            )
        return self._children[()]

    # unlabeled convenience: the family acts as its own child
    def inc(self, amount: float = 1.0) -> None:
        self._sole().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._sole().dec(amount)

    def set(self, value: float) -> None:
        self._sole().set(value)

    def observe(self, value: float) -> None:
        self._sole().observe(value)

    @property
    def value(self) -> float:
        return self._sole().value

    def children(self) -> "dict[tuple[str, ...], _Child]":
        with self._lock:
            return dict(self._children)


class MetricsRegistry:
    """Thread-safe registry of metric families.

    ``counter``/``gauge``/``histogram`` register idempotently: asking for
    an existing name returns the existing family (and raises if the kind
    or labels disagree — two subsystems silently sharing one name under
    different schemas is the bug this catches).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    def _register(
        self,
        name: str,
        help_text: str,
        kind: str,
        labelnames: Sequence[str],
        buckets: tuple[float, ...] | None = None,
    ) -> _Family:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        labelnames = tuple(labelnames)
        for label in labelnames:
            if not _LABEL_RE.match(label):
                raise ValueError(f"invalid label name {label!r}")
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.labelnames}, not "
                        f"{kind}{labelnames}"
                    )
                return fam
            fam = _Family(name, help_text, kind, labelnames, buckets)
            self._families[name] = fam
            return fam

    def counter(
        self, name: str, help_text: str = "", labelnames: Sequence[str] = ()
    ) -> _Family:
        return self._register(name, help_text, "counter", labelnames)

    def gauge(
        self, name: str, help_text: str = "", labelnames: Sequence[str] = ()
    ) -> _Family:
        return self._register(name, help_text, "gauge", labelnames)

    def histogram(
        self,
        name: str,
        help_text: str = "",
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] | None = None,
    ) -> _Family:
        bounds = tuple(
            sorted(buckets) if buckets is not None else exponential_buckets()
        )
        return self._register(name, help_text, "histogram", labelnames, bounds)

    def get(self, name: str) -> _Family | None:
        with self._lock:
            return self._families.get(name)

    def families(self) -> list[_Family]:
        with self._lock:
            return list(self._families.values())

    def reset(self) -> None:
        """Zero every child in place (benchmark warmup discard).  Child
        handles held by instruments stay valid."""
        for fam in self.families():
            for child in fam.children().values():
                child._reset()

    # -- exposition --------------------------------------------------------
    def render_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: list[str] = []
        for fam in sorted(self.families(), key=lambda f: f.name):
            if fam.help:
                lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for key, child in sorted(fam.children().items()):
                base_labels = list(zip(fam.labelnames, key))
                if fam.kind == "histogram":
                    assert fam.buckets is not None and child.counts is not None
                    cumulative = 0
                    for bound, n in zip(fam.buckets, child.counts):
                        cumulative += n
                        lines.append(
                            _sample(
                                f"{fam.name}_bucket",
                                base_labels + [("le", _fmt(bound))],
                                cumulative,
                            )
                        )
                    cumulative += child.counts[-1]
                    lines.append(
                        _sample(
                            f"{fam.name}_bucket",
                            base_labels + [("le", "+Inf")],
                            cumulative,
                        )
                    )
                    lines.append(
                        _sample(f"{fam.name}_sum", base_labels, child.sum)
                    )
                    lines.append(
                        _sample(f"{fam.name}_count", base_labels, child.value)
                    )
                else:
                    lines.append(_sample(fam.name, base_labels, child.value))
        return "\n".join(lines) + ("\n" if lines else "")


def _sample(
    name: str, labels: "list[tuple[str, str]]", value: float
) -> str:
    if labels:
        body = ",".join(
            f'{k}="{_escape_label_value(str(v))}"' for k, v in labels
        )
        return f"{name}{{{body}}} {_fmt(value)}"
    return f"{name} {_fmt(value)}"


class MetricsServer:
    """Minimal ``/metrics`` HTTP endpoint over one registry.

    Stdlib-only (``http.server``), threaded, daemonized — safe to leave
    running for the lifetime of a serve process.  ``port=0`` binds an
    ephemeral port (read it back from :attr:`port`)."""

    def __init__(
        self,
        registry: MetricsRegistry,
        port: int = 0,
        host: str = "127.0.0.1",
    ) -> None:
        import http.server

        render = registry.render_prometheus

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 — http.server API
                if self.path.split("?")[0] != "/metrics":
                    self.send_error(404, "try /metrics")
                    return
                body = render().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args: Any) -> None:  # quiet by default
                pass

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="repro-torch-obs-metrics",
            daemon=True,
        )
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}/metrics"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
