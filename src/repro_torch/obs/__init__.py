"""``repro_torch.obs`` — tracing, metrics and profiling (the port of
``repro.obs``; ``trace``, ``metrics`` and ``timeline`` are copies of the
reference's modules, which import no JAX).

  trace     :class:`Tracer` — typed spans/events on a thread-safe ring
            buffer; Chrome/Perfetto ``trace_event`` JSON and JSONL
            exporters.  The serve engine records against the
            process-default tracer (:func:`get_tracer`), disabled — and
            near-free — until enabled.
  metrics   :class:`MetricsRegistry` — counter/gauge/exponential-bucket
            histogram families with a Prometheus text renderer and an
            optional stdlib HTTP ``/metrics`` endpoint
            (:class:`MetricsServer`; ``ServeEngine.serve_metrics(port)``).
  profile   :func:`profile_window` — opt-in ``torch.profiler`` capture
            around N serve steps, a Chrome trace in a log directory.
  timeline  ``python -m repro_torch.obs.timeline trace.json`` — terminal
            span summary (p50/p99 per span kind) plus the critical path of
            the worst request.
"""

from repro_torch.obs.metrics import (  # noqa: F401
    MetricsRegistry,
    MetricsServer,
    exponential_buckets,
)
from repro_torch.obs.profile import profile_window, profiler_available  # noqa: F401
from repro_torch.obs.trace import (  # noqa: F401
    NULL_SPAN,
    SpanRecord,
    Tracer,
    get_tracer,
    set_tracer,
)
