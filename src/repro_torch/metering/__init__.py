"""``repro_torch.metering`` — the measurement-and-telemetry runtime (the port
of ``repro/metering``).

The planner decides *what* to measure; this package owns *how* it is
measured and what the measurement costs in energy:

  executors   ``SerialExecutor`` / ``DeviceParallelExecutor`` /
              ``BatchedExecutor`` behind the ``MeasurementExecutor``
              protocol — plugged into ``MeasurementCache(executor=...)``
              (or ``OffloadSession(..., executor=...)``) so every search
              strategy's bulk ``measure_many`` rounds run concurrently on
              multi-card hosts, or fused for sub-millisecond variants.
  meters      counter-backed ``PowerMeter``s (``NvmlMeter`` through
              NVIDIA's NVML library, ``RaplMeter``, ``PsutilCpuMeter``)
              behind :func:`autodetect`, which degrades gracefully to
              ``TimeProportionalPower``.  Every reading is stamped
              ``measured`` vs ``estimated`` so mixed rankings stay
              auditable.
  report      ``python -m repro_torch.metering.report`` diffs two plan
              stores into the paper's power/performance trade-off table,
              and ``search_trace`` reconstructs the Fig. 4
              trials-vs-best curve from a report or a measurement cache.
"""

from repro_torch.core.planner.objectives import (  # noqa: F401
    DEFAULT_DEVICE_WATTS,
    PowerMeter,
    TimeProportionalPower,
)
from repro_torch.metering.executors import (  # noqa: F401
    EXECUTOR_NAMES,
    BatchedExecutor,
    DeviceParallelExecutor,
    MeasureJob,
    MeasurementExecutor,
    SerialExecutor,
    resolve_executor,
    run_job,
)
from repro_torch.metering.meters import (  # noqa: F401
    METER_NAMES,
    METER_PROBE_ORDER,
    Nvml,
    NvmlError,
    NvmlMeter,
    PsutilCpuMeter,
    RaplMeter,
    WindowTelemetry,
    autodetect,
    meter_window,
    resolve_meter,
)

_REPORT_NAMES = (
    "DiffRow",
    "TracePoint",
    "diff_stores",
    "render_table",
    "render_trace",
    "search_trace",
    "plan_score",
)


def __getattr__(name):
    # report is imported lazily: an eager import here would make the
    # documented `python -m repro_torch.metering.report` CLI double-import
    # the module under runpy (RuntimeWarning + two module objects).
    if name in _REPORT_NAMES:
        from repro_torch.metering import report

        return getattr(report, name)
    raise AttributeError(f"module 'repro_torch.metering' has no attribute '{name}'")
