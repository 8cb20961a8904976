"""Pluggable search objectives — what "best pattern" means.  A copy of
``repro/core/planner/objectives.py``: pure Python.

The paper ranks candidate offload patterns by wall-seconds; the follow-up
power-saving work (arXiv:2110.11520) ranks by performance-per-watt.  Both
are instances of one protocol: an ``Objective`` maps a measured trial to a
scalar score where **lower is better**, and every ``SearchStrategy`` picks
winners via ``objective.score(trial)`` instead of hard-coding
``trial.seconds``.

Energy comes from a ``PowerMeter`` plugged into the ``MeasurementCache``:
a real deployment wires hardware counters into ``begin``/``end``, while
``TimeProportionalPower`` is the always-available fallback that charges a
constant device draw for the trial's runtime.  Trials measured without any
meter have ``energy_joules=None``; energy-aware objectives then fall back
to a time-proportional estimate at scoring time so they stay total orders
over any trial list.
"""

from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

#: Nominal board power charged by the time-proportional fallback: the
#: H100 SXM's power limit, as ``nvidia-smi --query-gpu=name,power.limit``
#: gives it (``NVIDIA H100 80GB HBM3, 700.00 W``).  The absolute value only
#: shifts energy scores by a constant factor — relative ranking, which is
#: all the search needs, is unaffected.
DEFAULT_DEVICE_WATTS = 700.0


# -- power metering -----------------------------------------------------------


class PowerMeter:
    """Energy measurement for one timed trial.

    ``begin()`` is called immediately before the candidate's timed window
    and ``end(measurement, space, candidate)`` immediately after; ``end``
    returns the estimated joules of **one** call (or None when the meter
    cannot produce a reading, e.g. counters unavailable).  Hardware meters
    sample RAPL / board telemetry between the two hooks; the base class is
    a null meter.

    ``provenance`` labels the readings this meter produces — ``"measured"``
    for hardware counters, ``"estimated"`` for modelled draw — and is
    stamped onto every ``Measurement`` so mixed rankings stay auditable.
    ``exclusive`` marks meters whose begin/end window reads a device-global
    counter: concurrent trials would be attributed each other's energy, so
    parallel executors serialise the metered sections of such meters.
    """

    provenance: str | None = None
    exclusive: bool = True

    def begin(self) -> None:  # pragma: no cover - trivial
        pass

    def end(
        self, measurement: Any, space: Any = None, candidate: Any = None
    ) -> float | None:
        return None


class TimeProportionalPower(PowerMeter):
    """Fallback meter: constant draw, so energy = runtime x watts.

    This is exact for a device whose power envelope does not depend on the
    pattern (then PerfPerWatt degenerates to latency) and is the documented
    stand-in until a counter-backed meter is registered.  Counter-backed
    meters (NVML / RAPL / psutil) live in ``repro_torch.metering.meters``
    behind ``metering.autodetect()``.
    """

    provenance = "estimated"
    # pure function of the trial's own measurement — safe under concurrency
    exclusive = False

    def __init__(self, watts: float = DEFAULT_DEVICE_WATTS) -> None:
        if watts <= 0:
            raise ValueError("watts must be positive")
        self.watts = watts

    def end(
        self, measurement: Any, space: Any = None, candidate: Any = None
    ) -> float | None:
        return measurement.seconds * self.watts


# -- objectives ---------------------------------------------------------------


@runtime_checkable
class Objective(Protocol):
    """Scores a ``PlanTrial``; lower is better.  ``name`` labels reports
    and persisted plans."""

    name: str

    def score(self, trial: Any) -> float: ...


class Latency:
    """The paper's objective: median wall-seconds per call."""

    name = "latency"

    def score(self, trial: Any) -> float:
        return trial.seconds


class PerfPerWatt:
    """Energy per unit of work (joules per call) — minimising it maximises
    performance-per-watt for a fixed workload (arXiv:2110.11520).

    Trials carrying a metered ``energy_joules`` use it directly; unmetered
    trials are charged ``seconds * fallback_watts`` (the time-proportional
    fallback), so mixed trial lists still rank consistently.
    """

    name = "perf_per_watt"

    def __init__(self, fallback_watts: float = DEFAULT_DEVICE_WATTS) -> None:
        self.fallback_watts = fallback_watts

    def score(self, trial: Any) -> float:
        energy = getattr(trial, "energy_joules", None)
        if energy is None:
            return trial.seconds * self.fallback_watts
        return energy


class WeightedCost:
    """Affine blend of latency and energy: ``wt*seconds + we*joules``.

    Covers deployment policies between the two extremes — e.g. "prefer the
    faster pattern unless it costs disproportionate power".
    """

    def __init__(
        self,
        time_weight: float = 1.0,
        energy_weight: float = 0.0,
        fallback_watts: float = DEFAULT_DEVICE_WATTS,
    ) -> None:
        self.time_weight = time_weight
        self.energy_weight = energy_weight
        self.fallback_watts = fallback_watts
        self.name = f"weighted(t={time_weight:g},e={energy_weight:g})"

    def score(self, trial: Any) -> float:
        energy = getattr(trial, "energy_joules", None)
        if energy is None:
            energy = trial.seconds * self.fallback_watts
        return self.time_weight * trial.seconds + self.energy_weight * energy


def resolve_objective(objective: "Objective | str | None") -> Objective:
    """Accept an Objective instance, a name, or None (-> Latency)."""
    if objective is None:
        return Latency()
    if isinstance(objective, str):
        named = {
            "latency": Latency,
            "seconds": Latency,
            "perf_per_watt": PerfPerWatt,
            "energy": PerfPerWatt,
        }
        if objective not in named:
            raise KeyError(
                f"unknown objective '{objective}'; known: {sorted(named)}"
            )
        return named[objective]()
    return objective
