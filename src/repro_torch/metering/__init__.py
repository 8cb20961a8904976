"""Measurement executors (the port of ``repro/metering``: only the serial
executor so far; the device-parallel and batched executors and the power
meters are not ported yet)."""

from repro_torch.metering.executors import (  # noqa: F401
    MeasureJob,
    SerialExecutor,
    resolve_executor,
    run_job,
)
