"""The port's metering runtime (``repro_torch.metering``) against the
reference's (``repro.metering``) on the CPU.

Every parity test feeds the same inputs to both packages and asserts the
same outputs.  Timing runs on a fake clock (``time.perf_counter`` patched):
it advances only when a job runs, so measured seconds are exact and equal
in both packages; meters are fakes that return fixed joules or count
windows.  No test sleeps in order to time something.  Covered: the three
executors (the batched one's apportioned seconds and ``estimated`` joules,
its degrade when ``end`` raises, a fused group with a refused job), the
exclusive meters' lock across threads, the cache's in-flight waits and
exact hit/miss accounting and its ``metrics=`` counters, the meters (RAPL
with a counter wrap, the sampled meters' integration, NVML through a
stand-in library, psutil's estimate), ``resolve_meter`` /
``resolve_executor`` / ``autodetect``, ``meter_window``, provenance on a
committed plan, the serve engine's phase joules against the reference
engine's, and the CLIs' ``--meter`` / ``--executor``.
"""

import dataclasses
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

import repro.metering as jmet
import repro_torch.metering as tmet
from repro.configs import get_config as jget
from repro.core import planner as jplanner
from repro.core.planner import cache as jcache_mod
from repro.metering import meters as jmeters
from repro.models import lm as jlm
from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.offload import OffloadSession as JOffloadSession
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import planner as tplanner
from repro_torch.core.blocks import GradRefused
from repro_torch.core.planner import cache as tcache_mod
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.metering import meters as tmeters
from repro_torch.obs import MetricsRegistry as TMetricsRegistry
from repro_torch.offload import OffloadSession as TOffloadSession
from repro_torch.offload import zoo
from repro_torch.serve import Request, ServeEngine

#: each package's metering, planner, cache module, registry and session
PKG = {
    "ref": types.SimpleNamespace(met=jmet, meters=jmeters, planner=jplanner,
                                 cache_mod=jcache_mod, registry=JMetricsRegistry,
                                 session=JOffloadSession),
    "port": types.SimpleNamespace(met=tmet, meters=tmeters, planner=tplanner,
                                  cache_mod=tcache_mod, registry=TMetricsRegistry,
                                  session=TOffloadSession),
}


class FakeClock:
    """``time.perf_counter`` that moves only when a job runs."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        """Back to the start: float differences of the clock depend on its
        value, so each package's run starts from the same reading."""
        self.t = 100.0

    def __call__(self) -> float:
        return self.t

    def advance(self, seconds: float) -> None:
        self.t += seconds


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    monkeypatch.setattr(time, "perf_counter", c)
    return c


def ticking(clock, seconds):
    """A job that takes ``seconds`` of the fake clock a call."""

    def fn(x):
        clock.advance(seconds)
        return x

    return fn


def _refusing(x):
    raise GradRefused("no backward for this binding")


class WindowMeter:
    """Fixed joules a window; counts its windows."""

    provenance = "measured"

    def __init__(self, joules=7.0, exclusive=True):
        self.joules = joules
        self.exclusive = exclusive
        self.windows = 0

    def begin(self):
        self.windows += 1

    def end(self, measurement, space=None, candidate=None):
        return self.joules


def _fields(ms):
    return [(m.seconds, m.compile_seconds, m.repeats, m.energy_joules, m.energy_provenance)
            for m in ms]


COSTS = {frozenset(): 0.040, frozenset({"a"}): 0.020, frozenset({"b"}): 0.030,
         frozenset({"a", "b"}): 0.008}


def clock_space(planner, clock, costs=COSTS, tag="metering"):
    def build(subset):
        return ticking(clock, costs[frozenset(subset)])

    return planner.SubsetSpace(build, ["a", "b"], tag=tag)


# -- executors ---------------------------------------------------------------------


def test_batched_apportions_time_share_and_estimates_energy(clock):
    """Per-variant shares of one fused window, median over repeats; the
    window's joules apportioned by time share, stamped ``estimated``."""
    out = {}
    for name, pkg in PKG.items():
        clock.reset()
        jobs = [pkg.met.MeasureJob(fn=ticking(clock, s), args=(0,), repeats=3)
                for s in (0.030, 0.005)]
        meter = WindowMeter(joules=7.0)
        out[name] = _fields(pkg.met.BatchedExecutor(max_fuse=4).run(jobs, meter=meter))
        assert meter.windows == 1
    assert out["port"] == out["ref"]
    (s0, c0, r0, j0, p0), (s1, _, _, j1, p1) = out["port"]
    assert (s0, s1, r0) == (pytest.approx(0.030), pytest.approx(0.005), 3)
    assert c0 == pytest.approx(0.0)  # the warm-up call took the median's time
    window = 3 * 0.035
    assert j0 == pytest.approx(7.0 / window * 0.030) and j1 == pytest.approx(7.0 / window * 0.005)
    assert p0 == p1 == "estimated"


def test_batched_degrades_when_end_raises(clock):
    """A meter whose ``end`` needs the candidate cannot attribute a fused
    window: the group's energy is None; a single-job group keeps it."""

    class CandidateWatts:
        provenance = "measured"
        exclusive = False

        def begin(self):
            pass

        def end(self, measurement, space=None, candidate=None):
            return (10.0 + sum(candidate)) * measurement.seconds

    out = {}
    for name, pkg in PKG.items():
        clock.reset()
        space = clock_space(pkg.planner, clock, {k: 0.002 for k in COSTS}, tag="cand")
        fused = pkg.planner.MeasurementCache(meter=CandidateWatts(),
                                             executor=pkg.met.BatchedExecutor(max_fuse=4))
        got = fused.measure_many(space, list(space.enumerate()), (0,), repeats=1, warmup=0)
        assert all(m.energy_joules is None for m, _ in got)
        solo = pkg.planner.MeasurementCache(meter=CandidateWatts(),
                                            executor=pkg.met.BatchedExecutor(max_fuse=1))
        (m, _), = solo.measure_many(space, [(1, 0)], (0,), repeats=1, warmup=0)
        assert m.energy_joules == pytest.approx(11.0 * m.seconds)
        out[name] = _fields([m for m, _ in got] + [m])
    assert out["port"] == out["ref"]


def test_batched_group_with_a_refused_job(clock):
    """A fused group in which one job raises ``GradRefused``: that job is
    infinitely slow with no energy, and the others measure as the
    reference's group without it does."""
    want = _fields(jmet.BatchedExecutor().run(
        [jmet.MeasureJob(fn=ticking(clock, s), args=(0,), repeats=3) for s in (0.030, 0.005)],
        meter=WindowMeter()))
    jobs = [tmet.MeasureJob(fn=ticking(clock, 0.030), args=(0,), repeats=3),
            tmet.MeasureJob(fn=_refusing, args=(0,), repeats=3),
            tmet.MeasureJob(fn=ticking(clock, 0.005), args=(0,), repeats=3)]
    clock.reset()
    got = tmet.BatchedExecutor().run(jobs, meter=WindowMeter())
    assert _fields([got[0], got[2]]) == want
    assert got[1].seconds == float("inf") and got[1].energy_joules is None
    # warm-up 0: the refusal comes inside the timed window
    got = tmet.BatchedExecutor().run([dataclasses.replace(j, warmup=0) for j in jobs])
    assert got[1].seconds == float("inf") and got[0].seconds == pytest.approx(0.030)
    # every executor: a refused trial never wins, and the meter's window closes
    meter = WindowMeter()
    for executor in (tmet.SerialExecutor(), tmet.DeviceParallelExecutor()):
        m, = executor.run([jobs[1]], meter=meter)
        assert m.seconds == float("inf") and m.energy_joules is None
    assert meter.windows == 2


@pytest.mark.parametrize("executor", ["serial", "device_parallel", "batched"])
def test_executors_same_search_in_both_packages(clock, executor):
    """The paper's single-then-combine search under each executor: the
    same trials, seconds, joules and winner in both packages (one CPU
    device: the device-parallel executor runs serially)."""
    out = {}
    for name, pkg in PKG.items():
        clock.reset()
        space = clock_space(pkg.planner, clock, tag=f"exec-{executor}")
        cache = pkg.planner.MeasurementCache(
            meter=pkg.planner.TimeProportionalPower(watts=100.0), executor=executor)
        rep = pkg.planner.SingleThenCombine().search(space, (0,), cache=cache, repeats=1)
        out[name] = ([(t.candidate, t.seconds, t.energy_joules, t.energy_provenance)
                      for t in rep.trials], rep.best.candidate)
    assert out["port"] == out["ref"]
    assert out["port"][1] == (1, 1)


def test_device_parallel_at_one_device_equals_serial(clock):
    jobs = [tmet.MeasureJob(fn=ticking(clock, s), args=(torch.ones(2),), repeats=2)
            for s in (0.01, 0.02, 0.03)]
    executor = tmet.DeviceParallelExecutor()
    assert executor._devices() == ([torch.device("cuda", i)
                                    for i in range(torch.cuda.device_count())]
                                   if torch.cuda.is_available() else [torch.device("cpu")])
    dp = _fields(tmet.DeviceParallelExecutor(devices=["cpu"]).run(jobs, meter=WindowMeter()))
    clock.reset()
    assert dp == _fields(tmet.SerialExecutor().run(jobs, meter=WindowMeter()))
    jjobs = [jmet.MeasureJob(fn=ticking(clock, s), args=(0,), repeats=2)
             for s in (0.01, 0.02, 0.03)]
    clock.reset()
    ref = jmet.DeviceParallelExecutor(devices=[None]).run(jjobs, meter=WindowMeter())
    assert dp == _fields(ref)


def test_device_parallel_workers_pin_their_jobs():
    """Above one worker (CPU only: on a card two workers would overlap a
    capture with another thread's work) each job's tensors move to its
    device, results come back in order, and the pinned call keeps the
    job's ``warmup_calls``."""
    seen = []

    def fn(x):
        seen.append(x.device)
        return x + 1

    fn.warmup_calls = 2
    pinned = tmet.executors._pin_to_device(tmet.MeasureJob(fn=fn, args=(torch.ones(1), 3)), "cpu")
    assert pinned.fn.warmup_calls == 2 and pinned.args[1] == 3
    jobs = [tmet.MeasureJob(fn=fn, args=(torch.full((1,), float(i)),), repeats=1, warmup=0)
            for i in range(6)]
    ms = tmet.DeviceParallelExecutor(devices=["cpu", "cpu"], max_workers=3).run(jobs)
    assert len(ms) == 6 and all(m.seconds > 0 for m in ms)
    assert set(seen) == {torch.device("cpu")}


def test_resolve_executor_names_and_errors():
    for pkg in PKG.values():
        met = pkg.met
        assert isinstance(met.resolve_executor(None), met.SerialExecutor)
        assert isinstance(met.resolve_executor("serial"), met.SerialExecutor)
        assert isinstance(met.resolve_executor("device-parallel"), met.DeviceParallelExecutor)
        assert isinstance(met.resolve_executor("device_parallel"), met.DeviceParallelExecutor)
        assert isinstance(met.resolve_executor("batched"), met.BatchedExecutor)
        with pytest.raises(KeyError):
            met.resolve_executor("warp-drive")
        with pytest.raises(TypeError):
            met.resolve_executor(object())
        with pytest.raises(ValueError):
            met.BatchedExecutor(max_fuse=0)
    assert set(tmet.EXECUTOR_NAMES) == set(jmet.executors._NAMED_EXECUTORS)


def test_trial_spans_on_the_process_tracer():
    """Each job runs under a "trial" span, a fused group under a
    "trial-group" span, with the reference's names and arguments."""
    import repro.obs as jobs_obs
    import repro_torch.obs as tobs

    out = {}
    for name, pkg, obs in (("ref", PKG["ref"], jobs_obs), ("port", PKG["port"], tobs)):
        tracer = obs.set_tracer(obs.Tracer())
        try:
            jobs = [pkg.met.MeasureJob(fn=lambda x: x, args=(0,), repeats=1, candidate=(1, 0)),
                    pkg.met.MeasureJob(fn=lambda x: x, args=(0,), repeats=2)]
            pkg.met.SerialExecutor().run(jobs)
            pkg.met.BatchedExecutor().run(jobs)
        finally:
            obs.set_tracer(None)
        out[name] = [(r.name, r.args) for r in tracer.records()]
    assert out["port"] == out["ref"] == [
        ("trial", {"repeats": 1, "warmup": 1, "candidate": "(1, 0)"}),
        ("trial", {"repeats": 2, "warmup": 1}), ("trial-group", {"fused": 2})]


def test_cache_rejects_a_short_executor_return_and_releases_its_claim():
    class ShortExecutor:
        def run(self, jobs, meter=None):
            return []

    for pkg in PKG.values():
        space = pkg.planner.SubsetSpace(lambda subset: (lambda x: x), ["a"], tag="short")
        cache = pkg.planner.MeasurementCache(executor=ShortExecutor())
        with pytest.raises(RuntimeError, match="one Measurement per job"):
            cache.measure(space, (0,), (0,), repeats=1, warmup=0)
        cache.executor = None  # the failed claim was released: another measures
        m, cached = cache.measure(space, (0,), (0,), repeats=1, warmup=0)
        assert not cached and m.seconds > 0


# -- the cache under threads -------------------------------------------------------


def test_exclusive_meter_windows_never_interleave_across_threads():
    """The lock lives on the meter: concurrent ``measure_many`` callers
    sharing one cache (and a device-parallel executor's workers) never
    interleave an exclusive meter's windows."""

    class StrictMeter:
        provenance = "measured"
        exclusive = True

        def __init__(self):
            self.open = False
            self.violations = 0
            self.windows = 0

        def begin(self):
            self.violations += self.open
            self.open = True
            self.windows += 1

        def end(self, measurement, space=None, candidate=None):
            self.violations += not self.open
            self.open = False
            return 1.0

    for pkg in PKG.values():
        for executor in (None, pkg.met.DeviceParallelExecutor(devices=[None, None],
                                                              max_workers=4)):
            meter = StrictMeter()
            space = pkg.planner.SubsetSpace(lambda subset: (lambda x: x), ["a", "b"],
                                            tag="strict")
            cache = pkg.planner.MeasurementCache(meter=meter, executor=executor)
            cands = list(space.enumerate())
            threads = [threading.Thread(target=cache.measure_many,
                                        args=(space, cands, (s,)), kwargs=dict(repeats=2))
                       for s in range(6)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            assert meter.violations == 0 and meter.windows == 6 * len(cands)


def test_cache_concurrent_measure_exact_accounting():
    """Eight threads measuring overlapping candidates: each measured once,
    hits + misses add up, and ``metrics=`` counters equal the fields."""
    for pkg in PKG.values():
        calls = []
        space = pkg.planner.SubsetSpace(lambda subset: (lambda x: calls.append(x) or x),
                                        ["a", "b"], tag="race")
        registry = pkg.registry()
        cache = pkg.planner.MeasurementCache(metrics=registry)
        cands = list(space.enumerate())
        errors = []

        def hammer(seed):
            try:
                for i in range(12):
                    m, _ = cache.measure(space, cands[(seed + i) % len(cands)], (0,),
                                         repeats=1, warmup=0)
                    assert m.seconds > 0
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        threads = [threading.Thread(target=hammer, args=(s,)) for s in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors and not any(t.is_alive() for t in threads)
        assert len(cache) == cache.misses == len(cands) == len(calls)
        assert cache.hits + cache.misses == 8 * 12
        assert registry.get("planner_cache_hits_total").value == cache.hits
        assert registry.get("planner_cache_misses_total").value == cache.misses


def test_cache_waits_for_an_inflight_measurement(monkeypatch):
    """A second thread asking for a key another thread is measuring waits
    for that record (the in-flight event) and replays it as a hit."""
    for pkg in PKG.values():
        waiting = threading.Event()

        class SpyEvent(threading.Event):
            def wait(self, timeout=None):
                waiting.set()
                return super().wait(timeout)

        monkeypatch.setattr(pkg.cache_mod, "threading",
                            types.SimpleNamespace(Event=SpyEvent, Lock=threading.Lock))
        started, release, calls = threading.Event(), threading.Event(), []

        def slow(x):
            calls.append(x)
            started.set()
            assert release.wait(timeout=60)
            return x

        space = pkg.planner.SubsetSpace(lambda subset: slow, ["a"], tag="inflight")
        cache = pkg.planner.MeasurementCache()
        results = {}

        def measure(name):
            results[name] = cache.measure(space, (1,), (0,), repeats=1, warmup=0)

        first = threading.Thread(target=measure, args=("first",))
        first.start()
        assert started.wait(timeout=60)
        second = threading.Thread(target=measure, args=("second",))
        second.start()
        assert waiting.wait(timeout=60)  # the second thread waits on the in-flight key
        release.set()
        for t in (first, second):
            t.join(timeout=60)
            assert not t.is_alive()
        assert len(calls) == 1 and cache.misses == 1 and cache.hits == 1
        assert results["first"][1] is False and results["second"][1] is True
        assert results["second"][0] is results["first"][0]
        monkeypatch.undo()


# -- meters ------------------------------------------------------------------------


def test_rapl_meter_wrap_same_joules(tmp_path, clock, monkeypatch):
    """Top-level ``intel-rapl:N`` domains only; a counter that wrapped in
    the window is corrected by ``max_energy_range_uj``."""
    pkg0 = tmp_path / "intel-rapl:0"
    sub = tmp_path / "intel-rapl:0:0"  # a subdomain: never summed
    for d, uj in ((pkg0, 1_900_000), (sub, 5)):
        d.mkdir()
        (d / "energy_uj").write_text(str(uj))
        (d / "max_energy_range_uj").write_text("2000000")
    out = {}
    for name, pkg in PKG.items():
        monkeypatch.setattr(pkg.meters.RaplMeter, "GLOB", f"{tmp_path}/intel-rapl:[0-9]*")
        assert pkg.meters.RaplMeter.available()
        meter = pkg.meters.RaplMeter()
        clock.reset()
        (pkg0 / "energy_uj").write_text("1900000")
        meter.begin()
        clock.advance(2.0)
        (pkg0 / "energy_uj").write_text("300000")  # wrapped: 400000 uJ in the window
        out[name] = meter.end(tmet.executors.verify.Measurement(0.5, 0.0, 1))
    assert out["port"] == out["ref"] == pytest.approx(0.4 / 2.0 * 0.5)


class _Constant:
    """Mixin: a sampled meter reading a constant draw."""

    watts = 120.0

    def _read_now(self):
        return self.watts


def test_sampled_meter_integration_same_in_both():
    """Trapezoidal integration of fixed samples into average watts, charged
    per call; and a begin/end window over a constant draw."""
    out = {}
    for name, pkg in PKG.items():
        Sampled = type("Sampled", (pkg.meters._SampledPowerMeter,), {})
        meter = Sampled()
        meter._samples = [(0.0, 100.0), (1.0, 200.0), (3.0, 100.0)]
        meter._stop, meter._thread = threading.Event(), threading.Thread(target=lambda: None)
        meter._thread.start()
        m = pkg.met.executors.verify.Measurement(seconds=0.5, compile_seconds=0.0, repeats=1)
        joules = meter.end(m)  # _read_now raises: no closing sample
        assert meter.end(m) is None  # no window open
        constant = type("Constant", (_Constant, pkg.meters._SampledPowerMeter), {})(sample_hz=1000)
        constant.begin()
        assert constant.end(m) == pytest.approx(120.0 * 0.5)  # any sample times
        out[name] = (joules, meter.provenance, meter.exclusive)
    assert out["port"] == out["ref"] == (pytest.approx(450.0 / 3.0 * 0.5), "measured", True)


class FakeNvmlLib:
    """Stand-in for ``libnvidia-ml.so.1``: each function fills its
    ``byref`` arguments and returns an ``nvmlReturn_t``."""

    def __init__(self, mw=123_456, fail=None):
        self.mw, self.fail, self.inits = mw, fail, 0

    def _ret(self, name):
        return 999 if name == self.fail else 0

    def nvmlInit_v2(self):
        self.inits += 1
        return self._ret("nvmlInit_v2")

    def nvmlDeviceGetCount_v2(self, n):
        n._obj.value = 1
        return 0

    def nvmlDeviceGetHandleByIndex_v2(self, index, h):
        h._obj.value = 0x1000 + index.value
        return 0

    def nvmlDeviceGetPowerUsage(self, h, mw):
        mw._obj.value = self.mw
        return self._ret("nvmlDeviceGetPowerUsage")

    def nvmlDeviceGetName(self, h, buf, size):
        buf.value = b"NVIDIA H100 80GB HBM3"
        return 0

    def nvmlDeviceGetHandleByPciBusId_v2(self, bus_id, h):
        h._obj.value = 0x1000 if bus_id == b"00000000:9b:00.0" else 0x2000
        return 0

    def nvmlDeviceGetEnforcedPowerLimit(self, h, mw):
        mw._obj.value = 700_000
        return 0

    def nvmlDeviceGetTotalEnergyConsumption(self, h, mj):
        mj._obj.value = 5_000_123
        return 0

    def nvmlErrorString(self, code):
        return b"Unknown Error"


def test_nvml_meter_through_a_stand_in_library(clock):
    """The NVML binding's calls and the meter's readings; a non-zero
    ``nvmlReturn_t`` raises with NVML's own message; without
    ``libnvidia-ml.so.1`` (as here) NVML is unavailable in both packages and an
    explicit ``"nvml"`` raises."""
    nvml = tmet.Nvml(lib=FakeNvmlLib())
    assert nvml.count() == 1 and nvml.name(nvml.handle(0)) == "NVIDIA H100 80GB HBM3"
    h = nvml.handle(0)
    assert h.value == 0x1000
    assert nvml.handle_by_pci_bus_id("00000000:9b:00.0").value == h.value
    assert nvml.power_limit_watts(h) == 700.0 and nvml.power_watts(h) == 123.456
    assert nvml.total_energy_joules(h) == 5000.123
    meter = tmet.NvmlMeter(nvml=nvml)
    assert meter.provenance == "measured" and meter.exclusive
    with tmet.meter_window(meter) as tele:
        clock.advance(2.0)
    assert tele.joules == pytest.approx(123.456 * 2.0) and tele.provenance == "measured"
    bad = tmet.Nvml(lib=FakeNvmlLib(fail="nvmlDeviceGetPowerUsage"))
    with pytest.raises(tmet.NvmlError, match=r"nvmlDeviceGetPowerUsage failed: NVML error 999 "
                                             r"\(Unknown Error\)"):
        bad.power_watts(bad.handle(0))
    with pytest.raises(tmet.NvmlError):
        tmet.Nvml(lib=FakeNvmlLib(fail="nvmlInit_v2"))
    assert not tmet.NvmlMeter.available() and not jmet.NvmlMeter.available()
    with pytest.raises(OSError):
        tmet.Nvml()
    assert [f for f in tmeters.NVML_FUNCTIONS if not hasattr(FakeNvmlLib, f)] == []


def test_psutil_meter_estimate_same_in_both(clock):
    out = {}
    for name, pkg in PKG.items():
        meter = pkg.meters.PsutilCpuMeter(tdp_watts=100.0, idle_watts=10.0)
        clock.reset()
        busy = iter([1.0, 1.5])
        meter._busy, meter._ncpu = (lambda: next(busy)), 2
        meter.begin()
        clock.advance(1.0)
        m = pkg.met.executors.verify.Measurement(seconds=0.5, compile_seconds=0.0, repeats=1)
        out[name] = (meter.end(m), meter.provenance)
    assert out["port"] == out["ref"] == (pytest.approx((10.0 + 100.0 * 0.25) * 0.5), "estimated")
    assert tmeters.PsutilCpuMeter.available()


def test_resolve_meter_names_and_errors():
    for pkg in PKG.values():
        met = pkg.met
        assert met.resolve_meter(None) is None and met.resolve_meter("none") is None
        assert isinstance(met.resolve_meter("time"), met.TimeProportionalPower)
        assert isinstance(met.resolve_meter("time-proportional"), met.TimeProportionalPower)
        tp = met.TimeProportionalPower()
        assert met.resolve_meter(tp) is tp
        assert isinstance(met.resolve_meter("psutil"), pkg.meters.PsutilCpuMeter)
        with pytest.raises(KeyError):
            met.resolve_meter("geiger")
        for absent in ("tpu", "nvml", "rapl"):  # none of them here
            with pytest.raises(RuntimeError, match=f"power meter '{absent}' is not available"):
                met.resolve_meter(absent)
    assert set(tmet.METER_NAMES) == {"none", "auto", "time", "nvml", "rapl", "psutil", "tpu"}


def test_autodetect_falls_through_to_the_same_meter(monkeypatch):
    assert type(tmet.autodetect()).__name__ == type(jmet.autodetect()).__name__
    calls = []
    for name, cls in tmeters.METER_PROBE_ORDER:
        monkeypatch.setattr(cls, "available", lambda name=name: calls.append(name) or False)
    for cls in (jmeters.NvmlMeter, jmeters.TpuMeter, jmeters.RaplMeter, jmeters.PsutilCpuMeter):
        monkeypatch.setattr(cls, "available", lambda: False)
    meters = tmet.autodetect(fallback_watts=90.0), jmet.autodetect(fallback_watts=90.0)
    assert calls == ["nvml", "rapl", "psutil"]  # the card's draw first
    assert [type(m).__name__ for m in meters] == ["TimeProportionalPower"] * 2
    assert meters[0].watts == meters[1].watts == 90.0
    monkeypatch.setattr(tmeters.RaplMeter, "available", lambda: True)
    monkeypatch.setattr(tmeters.RaplMeter, "__init__", lambda self: None)
    assert isinstance(tmet.autodetect(), tmeters.RaplMeter)


def test_meter_window_telemetry_same_in_both(clock):
    out = {}
    for name, pkg in PKG.items():
        clock.reset()
        with pkg.met.meter_window(pkg.met.TimeProportionalPower(watts=50.0)) as tele:
            clock.advance(0.02)
        with pkg.met.meter_window(None) as bare:
            clock.advance(0.001)
        out[name] = (dataclasses.astuple(tele), dataclasses.astuple(bare), tele.summary(),
                     bare.summary())
    assert out["port"] == out["ref"]
    (seconds, joules, watts, provenance), bare = out["port"][:2]
    assert seconds == pytest.approx(0.02) and joules == pytest.approx(1.0)
    assert watts == pytest.approx(50.0) and provenance == "estimated"
    assert bare[1] is None and bare[0] == pytest.approx(0.001)


def test_provenance_threads_measurement_to_plan(tmp_path, clock):
    out = {}
    for name, pkg in PKG.items():
        clock.reset()
        session = pkg.session(
            clock_space(pkg.planner, clock, tag="provenance"), args=(0,),
            strategy=pkg.planner.ExhaustiveSearch(),
            meter=pkg.planner.TimeProportionalPower(watts=100.0),
            store=str(tmp_path / name), key="zoo:prov:train", repeats=1,
        )
        result = session.run(verify=False, build=False)
        assert all(t.energy_provenance == "estimated" for t in result.trials)
        stored = pkg.planner.PlanStore(str(tmp_path / name)).load("zoo:prov:train")
        assert stored.best_energy_joules == pytest.approx(stored.best_seconds * 100.0)
        out[name] = (stored.mapping, stored.best_seconds, stored.best_energy_joules,
                     stored.best_energy_provenance)
    assert out["port"] == out["ref"]


def test_session_meter_and_executor_guards(clock):
    """A shared cache keeps its meter and executor: a different one raises
    (the reference's guards); ``plan(executor=)`` sets the session's own."""
    for pkg in PKG.values():
        space = clock_space(pkg.planner, clock, tag="guards")
        meter = pkg.planner.TimeProportionalPower()
        shared = pkg.planner.MeasurementCache(meter=meter, executor="serial")
        pkg.session(space, cache=shared, meter=meter, executor="serial")  # the same: fine
        with pytest.raises(ValueError, match="different PowerMeter"):
            pkg.session(space, cache=shared, meter=pkg.planner.TimeProportionalPower())
        with pytest.raises(ValueError, match="different executor"):
            pkg.session(space, cache=shared, executor="batched")
        session = pkg.session(space, args=(0,), repeats=1)
        session.analyze()
        session.discover()
        session.plan(executor="batched")
        assert isinstance(session.cache.executor, pkg.met.BatchedExecutor)
        own = pkg.session(space, cache=shared, args=(0,), repeats=1)
        own.analyze()
        own.discover()
        with pytest.raises(ValueError, match="different executor"):
            own.plan(executor="batched")


# -- the serve engine --------------------------------------------------------------


F32 = dataclasses.replace(get_config("llama3.2-1b").reduced(), compute_dtype="float32")
J32 = dataclasses.replace(jget("llama3.2-1b").reduced(), compute_dtype="float32", remat="none")


def test_engine_phase_joules_against_the_reference_engine():
    """The same fake meter under both engines: equal per-phase calls,
    tokens and joules (a fixed reading a window), the joules counter fed,
    and the tokens equal the unmetered run's."""
    jparams = jlm.init_params(J32, seed=0)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), F32)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, F32.vocab_size, n).tolist() for n in (5, 9, 4, 7)]
    gens = (6, 3, 8, 2)

    def serve(engine, request_cls):
        ids = [engine.submit(request_cls(p, max_new_tokens=g)) for p, g in zip(prompts, gens)]
        engine.run_until_idle(max_steps=500)
        return [engine.completions[i].tokens for i in ids]

    kw = dict(n_slots=2, max_len=64, seed=0, page_size=4)
    meters = {"ref": WindowMeter(joules=1.5), "port": WindowMeter(joules=1.5)}
    jeng = JServeEngine(J32, params=jparams, meter=meters["ref"], **kw)
    teng = ServeEngine(F32, params=tparams, device="cpu", meter=meters["port"], **kw)
    want, got = serve(jeng, JRequest), serve(teng, Request)
    bare = serve(ServeEngine(F32, params=tparams, device="cpu", **kw), Request)
    assert got == want == bare
    for phase in ("prefill", "decode"):
        jt, tt = jeng.telemetry[phase], teng.telemetry[phase]
        assert (tt.calls, tt.tokens, tt.joules, tt.provenance) == (
            jt.calls, jt.tokens, jt.joules, jt.provenance)
        assert tt.joules == pytest.approx(1.5 * tt.calls) and tt.provenance == "measured"
        assert tt.joules_per_token == jt.joules_per_token
        fed = teng.registry.get("serve_phase_joules_total").labels(phase=phase).value
        assert fed == tt.joules
    assert meters["port"].windows == meters["ref"].windows == (
        teng.telemetry["prefill"].calls + teng.telemetry["decode"].calls)


# -- the CLIs ----------------------------------------------------------------------


def test_serve_cli_meter_prints_joules_per_token(capsys):
    assert serve_cli.main(["--device", "cpu", "--reduced", "--requests", "2", "--prompt-len",
                           "8", "--len-jitter", "2", "--gen", "3", "--gen-jitter", "0",
                           "--slots", "2", "--max-len", "32", "--meter", "time"]) == 0
    lines = capsys.readouterr().out.splitlines()
    for phase in ("prefill", "decode"):
        (line,) = [s for s in lines if s.startswith(f"{phase}: ")]
        assert " J [" in line and "J/tok, estimated]" in line


def test_train_cli_meter_prints_the_loop_power(tmp_path, capsys):
    assert train_cli.main(["--arch", "llama3.2-1b", "--reduced", "--batch", "2", "--seq", "8",
                           "--device", "cpu", "--steps", "2", "--layers", "1",
                           "--ckpt-dir", str(tmp_path), "--meter", "time"]) == 0
    last = capsys.readouterr().out.splitlines()[-1]
    assert last.startswith("power: train loop ") and last.endswith("W avg, estimated)")


def test_zoo_cli_meter_and_batched_executor(tmp_path, capsys):
    zoo.main(["--plan-dir", str(tmp_path), "--arch", "llama3.2-1b", "--kind", "decode",
              "--layers", "1", "--batch", "1", "--seq", "8", "--device", "cpu",
              "--meter", "time", "--executor", "batched"])
    assert "planned 1/1 cells" in capsys.readouterr().out
    plan = tplanner.PlanStore(str(tmp_path)).load("zoo:llama3.2-1b:decode")
    assert plan.best_energy_provenance == "estimated" and plan.best_energy_joules > 0
