"""Counter-backed PowerMeter implementations + autodetection (the port of
``repro/metering/meters.py``).

The follow-up power-saving work (arXiv:2110.11520) ranks offload winners on
*measured* power draw, not wall time alone.  ``repro_torch.core.planner``
ships only ``TimeProportionalPower`` (energy = runtime x nominal watts,
provenance ``"estimated"``); this module adds meters that read real
telemetry:

  NvmlMeter       NVIDIA board draw (``nvmlDeviceGetPowerUsage``), read
                  through NVIDIA's ``libnvidia-ml.so.1`` with ``ctypes``
                  (no ``pynvml``), sampled on a background thread and
                  integrated over the trial window.
  RaplMeter       Intel RAPL package energy counters
                  (``/sys/class/powercap/intel-rapl:*/energy_uj``).
  PsutilCpuMeter  CPU utilisation x TDP model via psutil — a last-resort
                  *estimate* for hosts with no energy counter at all.

``autodetect()`` probes them in the order ``nvml -> rapl -> psutil`` and
degrades gracefully to ``TimeProportionalPower``, so
``MeasurementCache(meter=autodetect())`` is always safe to write.  The
reference's ``TpuMeter`` reads libtpu's monitoring SDK, which no host of the
port has: it is not ported, and ``resolve_meter("tpu")`` raises as the
reference does on a host without libtpu.  Every meter declares its
``provenance`` (``"measured"`` vs ``"estimated"``) — stamped on each
``Measurement`` so a ranking that mixes metered and modelled joules stays
auditable — and its ``exclusive`` flag (device-global counters force
parallel executors to serialise metered sections).

All meters report energy *per call*: they integrate average draw over the
begin/end window and charge ``avg_watts x measurement.seconds``, matching
the ``TimeProportionalPower`` contract.

NVML's board draw is itself an average over about one second on Hopper
cards, so a window much shorter than that reads the trailing average, not
the window's own draw: per-call joules of short windows mean something only
summed over many windows.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import glob
import threading
import time
from typing import Any

from repro_torch.core.planner.objectives import (
    DEFAULT_DEVICE_WATTS,
    PowerMeter,
    TimeProportionalPower,
)


class _SampledPowerMeter(PowerMeter):
    """Shared machinery for meters that *sample* an instantaneous-watts
    counter: ``begin`` starts a daemon thread polling ``_read_now()``
    every ``1/sample_hz`` seconds; ``end`` stops it, integrates the
    samples trapezoidally into average watts over the window, and charges
    ``avg_watts x seconds`` per call."""

    provenance = "measured"
    exclusive = True  # one device counter answers for every concurrent trial

    def __init__(self, sample_hz: float = 50.0) -> None:
        self.sample_hz = max(sample_hz, 1.0)
        self._samples: list[tuple[float, float]] = []
        self._stop: threading.Event | None = None
        self._thread: threading.Thread | None = None

    def _read_now(self) -> float:
        """Instantaneous draw in watts (may raise transiently)."""
        raise NotImplementedError

    def _sample_loop(self, stop: threading.Event) -> None:
        period = 1.0 / self.sample_hz
        while not stop.is_set():
            try:
                watts = self._read_now()
            except Exception:  # noqa: BLE001 — transient NVML error
                watts = None
            if watts is not None:
                self._samples.append((time.perf_counter(), watts))
            stop.wait(period)

    def begin(self) -> None:
        # a transient NVML error here must degrade this trial's reading
        # to None, not abort a search that may be hours in
        self._samples = []
        with contextlib.suppress(Exception):
            self._samples.append((time.perf_counter(), self._read_now()))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._sample_loop, args=(self._stop,), daemon=True
        )
        self._thread.start()

    def end(
        self, measurement: Any, space: Any = None, candidate: Any = None
    ) -> float | None:
        if self._stop is None or self._thread is None:
            return None
        self._stop.set()
        self._thread.join(timeout=2.0)
        with contextlib.suppress(Exception):
            self._samples.append((time.perf_counter(), self._read_now()))
        samples = self._samples
        self._stop = self._thread = None
        if len(samples) < 2:
            return None
        joules = 0.0
        for (t0, w0), (t1, w1) in zip(samples, samples[1:]):
            joules += (w0 + w1) / 2.0 * (t1 - t0)
        window = samples[-1][0] - samples[0][0]
        if window <= 0:
            return None
        avg_watts = joules / window
        return avg_watts * measurement.seconds


# -- NVML through ctypes ---------------------------------------------------------


class NvmlError(RuntimeError):
    """A non-zero ``nvmlReturn_t``, with NVML's own description."""

    def __init__(self, function: str, code: int, message: str) -> None:
        super().__init__(f"{function} failed: NVML error {code} ({message})")
        self.function = function
        self.code = code


_H = ctypes.c_void_p  # nvmlDevice_t: an opaque pointer
_U = ctypes.c_uint

#: NVML entry point -> argtypes (each returns an ``nvmlReturn_t``)
NVML_FUNCTIONS: dict[str, list] = {
    "nvmlInit_v2": [],
    "nvmlDeviceGetCount_v2": [ctypes.POINTER(_U)],
    "nvmlDeviceGetHandleByIndex_v2": [_U, ctypes.POINTER(_H)],
    "nvmlDeviceGetPowerUsage": [_H, ctypes.POINTER(_U)],
    "nvmlDeviceGetName": [_H, ctypes.c_char_p, _U],
    "nvmlDeviceGetHandleByPciBusId_v2": [ctypes.c_char_p, ctypes.POINTER(_H)],
    "nvmlDeviceGetEnforcedPowerLimit": [_H, ctypes.POINTER(_U)],
    "nvmlDeviceGetTotalEnergyConsumption": [_H, ctypes.POINTER(ctypes.c_ulonglong)],
}

_NAME_BUFFER = 96  # NVML_DEVICE_NAME_V2_BUFFER_SIZE


class Nvml:
    """NVIDIA's NVML library, loaded with ``ctypes`` and initialised.

    ``lib`` defaults to ``libnvidia-ml.so.1`` (``OSError`` where it is not
    installed); a test may pass a stand-in object with the same
    functions.  Every call that returns a non-zero ``nvmlReturn_t`` raises
    :class:`NvmlError`.
    """

    def __init__(self, lib: Any = None) -> None:
        if lib is None:
            lib = ctypes.CDLL("libnvidia-ml.so.1")
            for name, argtypes in NVML_FUNCTIONS.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.nvmlErrorString.argtypes = [ctypes.c_int]
            lib.nvmlErrorString.restype = ctypes.c_char_p
        self.lib = lib
        self._check("nvmlInit_v2")

    def _check(self, name: str, *args: Any) -> None:
        code = getattr(self.lib, name)(*args)
        if code != 0:
            message = self.lib.nvmlErrorString(code)
            if isinstance(message, bytes):
                message = message.decode(errors="replace")
            raise NvmlError(name, int(code), str(message))

    def count(self) -> int:
        n = _U()
        self._check("nvmlDeviceGetCount_v2", ctypes.byref(n))
        return int(n.value)

    def handle(self, index: int) -> Any:
        """NVML's handle of device ``index`` (NVML's index, which need not
        be torch's ``cuda:index`` under ``CUDA_VISIBLE_DEVICES``)."""
        h = _H()
        self._check("nvmlDeviceGetHandleByIndex_v2", _U(index), ctypes.byref(h))
        return h

    def power_watts(self, handle: Any) -> float:
        """Board draw (``nvmlDeviceGetPowerUsage``: milliwatts, averaged by
        NVML over about one second on Hopper)."""
        mw = _U()
        self._check("nvmlDeviceGetPowerUsage", handle, ctypes.byref(mw))
        return mw.value / 1000.0

    def name(self, handle: Any) -> str:
        buf = ctypes.create_string_buffer(_NAME_BUFFER)
        self._check("nvmlDeviceGetName", handle, buf, _U(_NAME_BUFFER))
        return buf.value.decode(errors="replace")

    def handle_by_pci_bus_id(self, bus_id: str) -> Any:
        """NVML's handle of the device at PCI address ``bus_id``
        (``domain:bus:device.function``, hex)."""
        h = _H()
        self._check("nvmlDeviceGetHandleByPciBusId_v2", bus_id.encode(), ctypes.byref(h))
        return h

    def power_limit_watts(self, handle: Any) -> float:
        mw = _U()
        self._check("nvmlDeviceGetEnforcedPowerLimit", handle, ctypes.byref(mw))
        return mw.value / 1000.0

    def total_energy_joules(self, handle: Any) -> float:
        """The board's cumulative energy counter (millijoules in NVML).  No meter reads it: it is there to check a meter's
        integration over a long window."""
        mj = ctypes.c_ulonglong()
        self._check("nvmlDeviceGetTotalEnergyConsumption", handle, ctypes.byref(mj))
        return mj.value / 1000.0


class NvmlMeter(_SampledPowerMeter):
    """Sampled NVIDIA board draw (``nvmlDeviceGetPowerUsage``, milliwatts)
    integrated over the trial window.  ``index`` is NVML's device index;
    ``nvml`` an :class:`Nvml` to read through (default: ``libnvidia-ml.so.1``)."""

    def __init__(
        self, index: int = 0, sample_hz: float = 50.0, nvml: Nvml | None = None
    ) -> None:
        self.nvml = nvml if nvml is not None else Nvml()
        self.index = index
        self.handle = self.nvml.handle(index)
        super().__init__(sample_hz)

    @classmethod
    def available(cls) -> bool:
        try:
            return Nvml().count() > 0
        except Exception:  # noqa: BLE001 — no NVML library / no device
            return False

    def _read_now(self) -> float:
        return self.nvml.power_watts(self.handle)


# -- CPU meters --------------------------------------------------------------------


@dataclasses.dataclass
class _RaplDomain:
    path: str  # .../energy_uj
    max_uj: int  # counter wrap point


class RaplMeter(PowerMeter):
    """Intel RAPL package-energy counters under ``/sys/class/powercap``.

    Reads every top-level ``intel-rapl:<n>`` package domain's ``energy_uj``
    at ``begin`` and ``end``, sums the (wrap-corrected) deltas into window
    joules, and charges average watts x per-call seconds.
    """

    provenance = "measured"
    exclusive = True  # package counter, shared by every core

    GLOB = "/sys/class/powercap/intel-rapl:[0-9]*"

    def __init__(self, domains: list[_RaplDomain] | None = None) -> None:
        self._domains = domains if domains is not None else self._discover()
        if not self._domains:
            raise RuntimeError("no readable RAPL package domains")
        self._t0 = 0.0
        self._readings0: list[int] = []

    @classmethod
    def _discover(cls) -> list[_RaplDomain]:
        domains = []
        for d in sorted(glob.glob(cls.GLOB)):
            # top-level packages only: subdomains (core/uncore/dram) are
            # nested as intel-rapl:N:M and would double-count the package
            if d.count(":") != 1:
                continue
            try:
                with open(f"{d}/energy_uj") as f:
                    int(f.read())
                try:
                    with open(f"{d}/max_energy_range_uj") as f:
                        max_uj = int(f.read())
                except OSError:
                    max_uj = 2**62
                domains.append(_RaplDomain(f"{d}/energy_uj", max_uj))
            except (OSError, ValueError):  # unreadable (permissions) / junk
                continue
        return domains

    @classmethod
    def available(cls) -> bool:
        try:
            return bool(cls._discover())
        except Exception:  # noqa: BLE001 — defensive: probing must not raise
            return False

    def _read(self) -> list[int]:
        out = []
        for dom in self._domains:
            with open(dom.path) as f:
                out.append(int(f.read()))
        return out

    def begin(self) -> None:
        self._t0 = time.perf_counter()
        self._readings0 = self._read()

    def end(
        self, measurement: Any, space: Any = None, candidate: Any = None
    ) -> float | None:
        if not self._readings0:
            return None
        window = time.perf_counter() - self._t0
        try:
            readings1 = self._read()
        except OSError:
            return None
        uj = 0
        for dom, r0, r1 in zip(self._domains, self._readings0, readings1):
            delta = r1 - r0
            if delta < 0:  # counter wrapped during the window
                delta += dom.max_uj
            uj += delta
        self._readings0 = []
        if window <= 0:
            return None
        avg_watts = uj / 1e6 / window
        return avg_watts * measurement.seconds


class PsutilCpuMeter(PowerMeter):
    """CPU-utilisation x TDP model (psutil) — an *estimate*, not a counter.

    Utilisation is taken from *this process's* CPU time over the
    begin/end window (``Process.cpu_times``), normalised by core count —
    trials run in-process, so this attributes exactly the trial's own
    compute, and it keeps working in containers whose host-wide
    ``/proc/stat`` is masked (where ``cpu_percent`` reads 0).  Charges
    ``idle_watts + tdp_watts x util`` x per-call seconds.  The idle floor
    keeps sub-tick windows (process CPU time advances in ~10 ms ticks)
    from reading 0 J — a machine never draws nothing.  Last resort before
    the time-proportional fallback: it at least responds to how hard the
    trial drove the CPU.
    """

    provenance = "estimated"
    exclusive = True  # one process-wide window at a time

    def __init__(
        self,
        tdp_watts: float = DEFAULT_DEVICE_WATTS,
        idle_watts: float = 10.0,
    ) -> None:
        import psutil

        if tdp_watts <= 0:
            raise ValueError("tdp_watts must be positive")
        self._process = psutil.Process()
        self._ncpu = psutil.cpu_count() or 1
        self.tdp_watts = tdp_watts
        self.idle_watts = idle_watts
        self._t0 = 0.0
        self._busy0: float | None = None

    @classmethod
    def available(cls) -> bool:
        try:
            import psutil

            psutil.Process().cpu_times()
            return True
        except Exception:  # noqa: BLE001 — no psutil / no proc access
            return False

    def _busy(self) -> float:
        t = self._process.cpu_times()
        return t.user + t.system

    def begin(self) -> None:
        self._t0 = time.perf_counter()
        self._busy0 = self._busy()

    def end(
        self, measurement: Any, space: Any = None, candidate: Any = None
    ) -> float | None:
        if self._busy0 is None:
            return None
        window = time.perf_counter() - self._t0
        busy = self._busy() - self._busy0
        self._busy0 = None
        if window <= 0:
            return None
        util = min(busy / (window * self._ncpu), 1.0)
        watts = self.idle_watts + self.tdp_watts * util
        return watts * measurement.seconds


#: Autodetection order: the card's board draw first, the CPU package
#: counter next, the CPU model last.
METER_PROBE_ORDER: tuple[tuple[str, type], ...] = (
    ("nvml", NvmlMeter),
    ("rapl", RaplMeter),
    ("psutil", PsutilCpuMeter),
)

#: meters the reference names that no host of the port has (libtpu's)
_ABSENT_METERS = ("tpu",)

#: every name :func:`resolve_meter` takes (the CLIs' ``--meter`` choices)
METER_NAMES: tuple[str, ...] = (
    ("none", "auto", "time") + tuple(n for n, _ in METER_PROBE_ORDER) + _ABSENT_METERS
)


def autodetect(fallback_watts: float = DEFAULT_DEVICE_WATTS) -> PowerMeter:
    """Best available power meter for this host.

    Probes ``nvml -> rapl -> psutil`` and degrades gracefully to
    ``TimeProportionalPower(fallback_watts)`` — the returned meter is
    always usable, so callers never need an availability check of their
    own.
    """
    for _name, cls in METER_PROBE_ORDER:
        try:
            if cls.available():
                return cls()
        except Exception:  # noqa: BLE001 — a broken probe must not abort
            continue
    return TimeProportionalPower(watts=fallback_watts)


@dataclasses.dataclass
class WindowTelemetry:
    """What :func:`meter_window` observed: whole-window energy."""

    seconds: float = 0.0
    joules: float | None = None
    watts: float | None = None
    provenance: str | None = None

    def summary(self) -> str:
        if self.joules is None:
            return f"{self.seconds:.2f}s (no power reading)"
        tag = self.provenance or "unknown"
        return (
            f"{self.seconds:.2f}s, {self.joules:.1f} J "
            f"({self.watts:.1f} W avg, {tag})"
        )


@contextlib.contextmanager
def meter_window(meter: PowerMeter | None):
    """Meter an arbitrary code window (production run telemetry).

    Yields a ``WindowTelemetry`` filled in at exit — the launch CLIs use
    this to report the joules of a whole serve/train run, with the same
    provenance marking the planner stamps on search trials.  A None meter
    yields an empty telemetry (timing only).  The window closes when the
    block exits: CUDA work the block only enqueued is not inside it, so
    the block ends in a synchronising call.
    """
    from repro_torch.core.verify import Measurement

    tele = WindowTelemetry()
    t0 = time.perf_counter()
    if meter is not None:
        meter.begin()
    try:
        yield tele
    finally:
        tele.seconds = time.perf_counter() - t0
        if meter is not None:
            window = Measurement(
                seconds=max(tele.seconds, 1e-9), compile_seconds=0.0, repeats=1
            )
            tele.joules = meter.end(window)
            if tele.joules is not None:
                tele.watts = tele.joules / max(tele.seconds, 1e-9)
                tele.provenance = getattr(meter, "provenance", None)


def resolve_meter(meter: "PowerMeter | str | None") -> PowerMeter | None:
    """Accept a meter instance, a name, or None.

    Names: ``"auto"`` (autodetect), ``"none"`` (no metering),
    ``"time"``/``"time-proportional"``, ``"nvml"``, ``"rapl"``,
    ``"psutil"`` (and ``"tpu"``, which no host of the port has).  Asking
    for a specific unavailable meter raises rather than silently
    substituting — explicit requests should fail loudly.
    """
    if meter is None:
        return None
    if not isinstance(meter, str):
        return meter
    name = meter.lower()
    if name == "none":
        return None
    if name == "auto":
        return autodetect()
    if name in ("time", "time-proportional", "time_proportional"):
        return TimeProportionalPower()
    for probe_name, cls in METER_PROBE_ORDER:
        if name == probe_name:
            if not cls.available():
                raise RuntimeError(
                    f"power meter '{name}' is not available on this host"
                )
            return cls()
    if name in _ABSENT_METERS:
        raise RuntimeError(f"power meter '{name}' is not available on this host")
    raise KeyError(f"unknown power meter '{meter}'; known: {list(METER_NAMES)}")
