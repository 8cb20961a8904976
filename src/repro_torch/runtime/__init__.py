"""``repro_torch.runtime`` — the port of ``repro.runtime``: the step
monitor (:class:`~repro_torch.runtime.monitor.StepMonitor`)."""

from repro_torch.runtime.monitor import StepMonitor, StragglerEvent  # noqa: F401
