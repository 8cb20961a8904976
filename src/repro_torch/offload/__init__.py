"""``repro_torch.offload`` — the public facade for automatic offloading
(the port of ``repro/offload``).

One lifecycle object (``OffloadSession``: analyze -> discover -> plan ->
verify -> commit), one result type (``OffloadResult``), pluggable
objectives (``Latency``, ``PerfPerWatt``, ``WeightedCost`` over an optional
``PowerMeter``), persistent plans (``PlanStore``), and the zoo-wide
``plan_zoo`` sweep.

Quickstart::

    from repro_torch.offload import OffloadSession

    result = OffloadSession(my_app, args=(x,)).run()   # blocks on the card
    y = result.fn(x)                      # accelerated application

    # the same on the CPU, with the blocks' plain versions
    result = OffloadSession(my_app, args=(x,), device="cpu").run()

    # production startup: bind a committed plan, zero measurement
    with OffloadSession.attach("results/plans", "zoo:llama3.2-1b:decode"):
        ...
"""

from repro_torch.core.planner import (  # noqa: F401
    DEFAULT_DEVICE_WATTS,
    Latency,
    MeasurementCache,
    Objective,
    PerfPerWatt,
    Plan,
    PlanStore,
    PowerMeter,
    TimeProportionalPower,
    WeightedCost,
    resolve_objective,
)
from repro_torch.metering import (  # noqa: F401
    BatchedExecutor,
    DeviceParallelExecutor,
    SerialExecutor,
    autodetect,
    resolve_executor,
    resolve_meter,
)
from repro_torch.offload.session import (  # noqa: F401
    OffloadResult,
    OffloadSession,
    StageError,
    declared_pattern,
    stored_binding,
)


def __getattr__(name):
    # zoo is imported lazily: an eager import here would make the
    # documented `python -m repro_torch.offload.zoo` CLI double-import the
    # module under runpy (RuntimeWarning + two module objects).
    if name in ("plan_zoo", "zoo_key", "default_plan_key", "launch_plan_keys"):
        from repro_torch.offload import zoo

        return getattr(zoo, name)
    raise AttributeError(f"module 'repro_torch.offload' has no attribute '{name}'")
