"""``repro_torch.offload`` — the public facade for automatic offloading
(the port of ``repro/offload``).

One lifecycle object (``OffloadSession``: analyze -> discover -> plan ->
verify -> commit), one result type (``OffloadResult``), pluggable
objectives (``Latency``, ``PerfPerWatt``, ``WeightedCost`` over an optional
``PowerMeter``) and persistent plans (``PlanStore``).

Quickstart::

    from repro_torch.offload import OffloadSession

    result = OffloadSession(my_app, args=(x,)).run()   # blocks on the card
    y = result.fn(x)                      # accelerated application

    # the same on the CPU, with the blocks' plain versions
    result = OffloadSession(my_app, args=(x,), device="cpu").run()
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
from repro_torch.metering import SerialExecutor, resolve_executor  # noqa: F401
from repro_torch.offload.session import (  # noqa: F401
    OffloadResult,
    OffloadSession,
    StageError,
)
