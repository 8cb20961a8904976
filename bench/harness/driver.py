"""One run of one cell: set-up, the measured window, the metrics, the check.

The program under test is ``repro_torch``'s ``ServeEngine``, driven
through ``submit`` and ``step`` as a server's loop drives it.  The harness
keeps its own record of what it sent and saw:

* every request: when it was due, when ``submit`` took it, each token's
  id and the host time ``step`` returned it, and the engine's
  ``Completion`` (queue wait, TTFT from admission);
* every step: its host start and end, the resident length of each row
  its decode step attended over and the length of each prompt a prefill
  finished (from the ``Token`` events: a decode token of generation index
  ``i`` of a prompt of ``P`` tokens was computed at resident length
  ``P + i - 1``);
* the engine's phase telemetry and KV-health means at the window's ends;
* with ``--trace 1``, the profiler's trace of a stretch of whole steps.

Traffic: a backlog cell fills every slot before the window and submits a
new request whenever one finishes; a rate cell warms its programs with a
few requests, starts its open-loop arrivals ``ramp_s`` before the window,
and after the window keeps the arrivals going until every request due in
the window has finished (or ``drain_s`` passes: those still open fail).
"""

from __future__ import annotations

import dataclasses
import gc
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Any

import torch

from bench.harness import check, devtrace, loadgen, spec, weights, work

#: seconds of the window's end that a traced run profiles (at most 0.3 of it)
TRACE_S = 3.0
#: decode steps a backlog runs after its fill, before the window
WARM_STEPS = 3


@dataclasses.dataclass
class RequestRecord:
    prompt: list[int]
    out_len: int
    due: float
    submitted: float | None = None
    tokens: list[int] = dataclasses.field(default_factory=list)
    times: list[float] = dataclasses.field(default_factory=list)
    completion: Any = None
    failed: str | None = None

    @property
    def ttft(self) -> float | None:
        return self.times[0] - self.due if self.times else None


@dataclasses.dataclass
class StepRecord:
    t0: float
    t1: float
    #: resident length of each row the decode step attended over
    decode_lengths: list[int]
    #: length of each prompt whose prefill sampled a first token
    prefills: list[int]
    traced: bool = False


@dataclasses.dataclass
class Run:
    """Everything a metric reader may read."""

    cell: str
    dims: work.Dims
    traffic: dict
    setup_s: float
    t0: float  # window start (host clock)
    t1: float  # window end
    requests: list[RequestRecord]  # every request the harness made
    steps: list[StepRecord]
    telemetry: dict  # phase -> {calls, seconds, tokens} over the window
    kv_stranded_pct: float | None
    trace: devtrace.DeviceTrace | None = None

    def in_window(self) -> list[RequestRecord]:
        """Requests due in the window (for a backlog, submitted in it)."""
        return [r for r in self.requests if self.t0 <= r.due < self.t1]

    def window_steps(self) -> list[StepRecord]:
        return [s for s in self.steps if s.t0 >= self.t0 and s.t1 <= self.t1 + 1e-9]

    def traced_steps(self) -> list[StepRecord]:
        return [s for s in self.steps if s.traced]


def _telemetry(engine) -> dict:
    return {p: (t.calls, t.seconds, t.tokens) for p, t in engine.telemetry.items()}


def _delta(a: dict, b: dict) -> dict:
    return {p: {"calls": b[p][0] - a[p][0], "seconds": b[p][1] - a[p][1],
                "tokens": b[p][2] - a[p][2]} for p in a}


def _kv_mean(m0: tuple, m1: tuple) -> float | None:
    """The window's mean of the engine's per-step stranded-% samples, from
    its running means at the window's ends (one sample a step while a
    request is resident, which a loaded engine always has)."""
    (mean0, n0), (mean1, n1) = m0, m1
    return None if n1 <= n0 else (mean1 * n1 - mean0 * n0) / (n1 - n0)


def port_config(cell: spec.Cell, reduced: bool):
    """The program's ``ArchConfig`` for the cell, checked against the
    configuration's file: the arch, cut to the file's depth."""
    from repro_torch.configs import get_config

    port = cell.config["port"]
    c = cell.config  # the published keys, at the top level
    cfg = get_config(port["arch"]).cut(c["num_hidden_layers"])
    expect = {
        "d_model": c["hidden_size"], "n_heads": c["num_attention_heads"],
        "n_kv_heads": c["num_key_value_heads"], "vocab_size": c["vocab_size"],
        "d_ff": c["intermediate_size"], "norm_eps": port["norm_eps"],
        "rope_theta": port["rope_theta"], "tie_embeddings": port["tie_embeddings"],
        "compute_dtype": port["compute_dtype"],
    }
    if cfg.moe is not None:
        expect.update({"moe.n_experts": c["n_routed_experts"],
                       "moe.top_k": c["num_experts_per_tok"],
                       "moe.d_expert": c["moe_intermediate_size"],
                       "moe.n_shared": c["n_shared_experts"],
                       "moe.capacity_factor": port["capacity_factor"],
                       "first_k_dense": c["first_k_dense_replace"]})
    if cfg.mla is not None:
        expect.update({"mla.kv_lora_rank": c["kv_lora_rank"],
                       "mla.qk_nope_head_dim": c["qk_nope_head_dim"],
                       "mla.qk_rope_head_dim": c["qk_rope_head_dim"],
                       "mla.v_head_dim": c["v_head_dim"]})
    for key, want in expect.items():
        obj = cfg
        for part in key.split("."):
            obj = getattr(obj, part)
        if obj != want:
            raise ValueError(f"{cell.config_name}: the port's {key} is {obj}, the file says "
                             f"{want}")
    return cfg.reduced() if reduced else cfg


def dims_of_arch(cfg, page_size: int) -> work.Dims:
    """The sizes of a (reduced) ``ArchConfig``, for the CPU tests."""
    moe, mla = cfg.moe, cfg.mla
    return work.Dims(
        d_model=cfg.d_model, n_layers=cfg.n_layers, pattern=cfg.pattern(),
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head, d_ff=cfg.d_ff,
        vocab=cfg.vocab_size, page_size=page_size,
        kv_lora_rank=mla.kv_lora_rank if mla else 0, qk_nope=mla.qk_nope_head_dim if mla else 0,
        qk_rope=mla.qk_rope_head_dim if mla else 0, v_head=mla.v_head_dim if mla else 0,
        n_experts=moe.n_experts if moe else 0, top_k=moe.top_k if moe else 0,
        d_expert=moe.d_expert if moe else 0, n_shared=moe.n_shared if moe else 0,
    )


class HostClock:
    """The host's clock: what every benchmark run measures by."""

    def __call__(self) -> float:
        return time.perf_counter()

    def stepped(self) -> None:
        pass

    def idle_until(self, t: float) -> None:
        time.sleep(max(0.0, min(t - self(), 0.001)))


class VirtualClock(HostClock):
    """A clock that moves ``step_s`` a step and jumps over idle time: the
    CPU tests' runs then make the same steps however loaded the machine
    is.  Never used for a measurement."""

    def __init__(self, step_s: float = 0.05) -> None:
        self.t, self.step_s = 0.0, step_s

    def __call__(self) -> float:
        return self.t

    def stepped(self) -> None:
        self.t += self.step_s

    def idle_until(self, t: float) -> None:
        self.t = max(self.t, t)


class Driver:
    """Submits, steps and records; one per run."""

    def __init__(self, engine, clock: HostClock | None = None) -> None:
        self.engine = engine
        self.clock = clock or HostClock()
        self.by_id: dict[int, RequestRecord] = {}
        self.requests: list[RequestRecord] = []
        self.steps: list[StepRecord] = []
        self.traced = False

    def submit(self, draw: loadgen.Draw, due: float) -> RequestRecord:
        from repro_torch.serve import Request

        rec = RequestRecord(draw.prompt, draw.out_len, due)
        self.requests.append(rec)
        try:
            rid = self.engine.submit(Request(draw.prompt, max_new_tokens=draw.out_len))
        except ValueError as e:  # refused: counts as failed
            rec.failed = f"refused: {e}"
            return rec
        rec.submitted = self.clock()
        self.by_id[rid] = rec
        return rec

    def step(self) -> list:
        from repro_torch.serve import Completion

        t0 = self.clock()
        events = self.engine.step()
        self.clock.stepped()
        t1 = self.clock()
        lengths, prefills, done = [], [], []
        for ev in events:
            rec = self.by_id[ev.request_id]
            if isinstance(ev, Completion):
                rec.completion = ev
                done.append(rec)
                continue
            rec.tokens.append(ev.token_id)
            rec.times.append(t1)
            if ev.phase == "decode":
                lengths.append(len(rec.prompt) + ev.index - 1)
            else:
                prefills.append(len(rec.prompt) + ev.index)
        self.steps.append(StepRecord(t0, t1, lengths, prefills, self.traced))
        return done

    @property
    def busy(self) -> bool:
        return self.engine.scheduler.has_work


def _trace_plan(seconds: float) -> tuple[float, float]:
    """(start offset, length) of the traced stretch: the window's last
    :data:`TRACE_S` seconds (at most 0.3 of it)."""
    length = min(TRACE_S, 0.3 * seconds)
    return seconds - length, length


class _Tracer:
    """The profiler over a stretch of whole steps (``--trace 1``).

    The profiler is started and stopped once during set-up (:meth:`warm`:
    its first start initialises the device tracer, which takes seconds).
    The stretch is the window's last seconds, marked by the annotation
    :data:`devtrace.WINDOW`; the profiler stops (:meth:`finish`, which
    flushes the device tracer and may take seconds) only once nothing is
    measured any more: after a backlog's window, after a rate cell's drain.
    """

    def __init__(self, enabled: bool, start: float, length: float, out_dir: Path) -> None:
        self.enabled, self.start, self.length = enabled, start, length
        self.stop_at = float("inf")
        self.out_dir = out_dir
        self.prof = None
        self.annotation = None
        self.costs: dict[str, float] = {}

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def warm(self) -> None:
        if self.enabled:
            with self._profile():
                torch.zeros(1).add_(1)

    def tick(self, driver: Driver, now: float) -> None:
        if not self.enabled:
            return
        if self.prof is None and now >= self.start:
            from torch.profiler import record_function

            t = time.perf_counter()
            self.prof = self._profile()
            self.prof.__enter__()
            self.annotation = record_function(devtrace.WINDOW)
            self.annotation.__enter__()
            self.costs["profiler_start_s"] = time.perf_counter() - t
            driver.traced = True
            self.stop_at = driver.clock() + self.length
        elif self.annotation is not None and now >= self.stop_at:
            self.end_stretch(driver)

    def end_stretch(self, driver: Driver) -> None:
        if self.annotation is not None:
            self.annotation.__exit__(None, None, None)
            self.annotation = None
            driver.traced = False

    def finish(self, driver: Driver) -> None:
        self.end_stretch(driver)
        if self.prof is not None:
            t = time.perf_counter()
            self.prof.__exit__(None, None, None)
            self.costs["profiler_stop_s"] = time.perf_counter() - t

    def read(self) -> devtrace.DeviceTrace | None:
        if self.prof is None:
            return None
        path = self.out_dir / "trace.json"
        self.prof.export_chrome_trace(str(path))
        self.prof = None
        try:
            return devtrace.read(str(path))
        finally:
            path.unlink(missing_ok=True)


def _window_backlog(driver: Driver, stream: loadgen.Stream, seconds: float, tracer: _Tracer):
    clock = driver.clock
    t0 = clock()
    end = t0 + seconds
    tracer.start += t0
    m0 = _snapshot(driver.engine)
    while True:
        now = clock()
        if now >= end:
            break
        tracer.tick(driver, now)
        for _ in driver.step():
            driver.submit(stream.next(), clock())
    t1 = clock()
    m1 = _snapshot(driver.engine)
    tracer.finish(driver)
    return t0, t1, m0, m1


def _snapshot(engine) -> tuple:
    m = engine.metrics()
    return _telemetry(engine), (m["mean_stranded_pct"], engine.stats.steps)


def _window_rate(driver: Driver, stream: loadgen.Stream, seconds: float, ramp: float,
                 drain: float, tracer: _Tracer):
    """Open-loop arrivals from ``ramp`` seconds before the window until every
    request due in the window has finished (at most ``drain`` seconds past
    its end)."""
    clock = driver.clock
    start = clock()
    t0, t1 = start + ramp, start + ramp + seconds
    tracer.start += t0
    nxt = stream.next()
    due = start + nxt.gap
    m0 = m1 = None
    while True:
        now = clock()
        while due <= now:
            driver.submit(nxt, due)
            nxt = stream.next()
            due += nxt.gap
        if m0 is None and now >= t0:
            m0 = _snapshot(driver.engine)
        if m1 is None and now >= t1:
            m1 = _snapshot(driver.engine)
            tracer.end_stretch(driver)
        if m1 is not None:
            open_ = [r for r in driver.requests
                     if t0 <= r.due < t1 and r.failed is None and r.completion is None]
            if not open_ or now >= t1 + drain:
                for r in open_:
                    r.failed = "unfinished when the harness stopped waiting"
                tracer.finish(driver)
                break
        tracer.tick(driver, now)
        if driver.busy:
            driver.step()
        else:
            clock.idle_until(due)
    return t0, t1, m0, m1


def _fill_backlog(driver: Driver, mix: dict, vocab: int, seed: int, stream: loadgen.Stream,
                  n_slots: int) -> None:
    """Every slot busy, the decode step captured, before the window."""
    for draw in loadgen.first_cohort(mix, vocab, seed, n_slots):
        driver.submit(draw, driver.clock())
    for _ in range(WARM_STEPS):
        for _ in driver.step():
            driver.submit(stream.next(), driver.clock())


def _warm_rate(driver: Driver, mix: dict, vocab: int, seed: int) -> None:
    """A few requests of the mix, run to completion: each program key
    captured before the arrivals start."""
    warm = loadgen.Stream(mix, vocab, seed, loadgen.STREAM_WARM)
    for _ in range(int(mix["warm_requests"])):
        driver.submit(warm.next(), driver.clock())
    while driver.busy:
        driver.step()


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, root: Path = spec.ROOT,
             device: str = "cuda", t_start: float | None = None, reduced: bool = False,
             control: bool = False, overrides: dict | None = None,
             keep: dict | None = None, clock: HostClock | None = None) -> dict:
    """One run of cell ``name``; returns the result (see :func:`result`).
    ``reduced``: the port's reduced config and the mix's ``reduced``
    sizes (the CPU tests); ``control``: also read the control's gap
    (with ``keep``, the result the control gets, ``keep["control_result"]``);
    ``overrides``: mix parameters to replace (the knee sweep's rate);
    ``keep``: a dict that receives the run's record and the gap readings;
    ``clock``: the CPU tests' :class:`VirtualClock` (default the host's)."""
    from repro_torch.models import lm
    from repro_torch.serve import ServeEngine

    t_start = time.perf_counter() if t_start is None else t_start
    cell = spec.load_cell(name, root)
    mix = dict(cell.traffic)
    if reduced:
        mix.update(mix.get("reduced", {}))
    mix.update(overrides or {})
    eng = mix["engine"]
    cfg = port_config(cell, reduced)
    dims = (dims_of_arch(cfg, eng["page_size"]) if reduced
            else work.dims_of(cell.config, eng["page_size"]))
    sem = cell.config["port"]
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = weights.draw(lm.compute_metas(cfg), seed, dev)
    engine = ServeEngine(cfg, params=params, device=dev, seed=seed % 2**31, **eng)
    driver = Driver(engine, clock)
    backlog = mix["arrivals"] == "backlog"
    ramp = 0.0 if backlog else float(mix["ramp_s"])
    stream = loadgen.Stream(mix, cfg.vocab_size, seed, horizon=ramp + seconds)
    scratch = Path(tempfile.mkdtemp(prefix="bench-"))  # under TMPDIR
    tracer = _Tracer(trace, *_trace_plan(seconds), scratch)
    tracer.warm()
    if backlog:
        _fill_backlog(driver, mix, cfg.vocab_size, seed, stream, eng["n_slots"])
        setup_s = time.perf_counter() - t_start
        t0, t1, m0, m1 = _window_backlog(driver, stream, seconds, tracer)
    else:
        _warm_rate(driver, mix, cfg.vocab_size, seed)
        setup_s = time.perf_counter() - t_start + ramp
        t0, t1, m0, m1 = _window_rate(driver, stream, seconds, ramp, float(mix["drain_s"]),
                                      tracer)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    try:
        trace_data = tracer.read()
        if tracer.costs:
            print("bench: " + ", ".join(f"{k} {v:.3f}" for k, v in tracer.costs.items()),
                  file=sys.stderr)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    run = Run(
        cell=name, dims=dims, traffic=mix, setup_s=setup_s, t0=t0, t1=t1,
        requests=driver.requests, steps=driver.steps, telemetry=_delta(m0[0], m1[0]),
        kv_stranded_pct=_kv_mean(m0[1], m1[1]), trace=trace_data,
    )
    if keep is not None:
        keep["run"] = run
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    finished = [check.Sampled(r.prompt, r.tokens) for r in driver.requests
                if r.completion is not None and (r.times[-1] >= t0 if backlog else r.due >= t0)]
    del engine, driver.engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    sample = check.pick(finished, int(mix["check_requests"]), seed,
                        int(mix.get("check_min_tokens", 1)))
    gap = check.gap_readings(params, dims, sem, sample, dev, eng.get("prefill_chunk"),
                             control=control)
    if keep is not None:
        keep["gap"] = gap
    limits = cell.limits.get("reduced", {}) if reduced else cell.limits
    compared = {name: float(limits[name]) for name in check.NUMBERS if name in limits}
    if control and keep is not None:
        # the control put through the same verdict, its readings in the
        # program's place
        swapped = {"tokens": gap["tokens"], "program": gap["control"],
                   "program_mean": gap["control_mean"]}
        keep["control_result"] = result(cell, run, trace, swapped, compared, peak, dev, sample)
    return result(cell, run, trace, gap, compared, peak, dev, sample)


def result(cell: spec.Cell, run: Run, trace: bool, gap: dict, limits: dict, peak: int,
           dev: torch.device, sample: list) -> dict:
    """The result line: ``correct``, ``attempted``, ``failed``, the cell's
    metrics (end-to-end for ``--trace 0``, per-layer for ``--trace 1``),
    the device, with a trace the breakdown, and last the numbers compared
    beside their limits (``limits``: the cell's, by name)."""
    backlog = run.traffic["arrivals"] == "backlog"
    if backlog:
        attempted = [r for r in run.requests if r.due < run.t1 and (
            r.completion is None or r.times[-1] >= run.t0)]
    else:
        attempted = run.in_window()
    failed = [r for r in attempted if r.failed]
    metrics = {}
    for entry, reader in (cell.per_layer if trace else cell.end_to_end):
        value = reader.read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    min_tokens = int(run.traffic.get("check_min_tokens", 1))
    checks = {name: {"value": gap[check.NUMBERS[name]], "limit": limit}
              for name, limit in limits.items()}
    checks["tokens_compared"] = {"value": gap["tokens"], "limit": min_tokens}
    correct = (bool(sample) and bool(limits) and gap["tokens"] >= min_tokens
               and all(c["value"] <= c["limit"] for name, c in checks.items()
                       if name in limits))
    if gap.get("control") is not None:
        for name, limit in limits.items():
            key = check.NUMBERS[name].replace("program", "control")
            checks[f"control_{name}"] = {"value": gap[key], "limit": limit}
    device = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    out = {"correct": correct, "attempted": len(attempted), "failed": len(failed),
           "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        out["breakdown"] = {
            "device_ops": run.trace.top_ops(10),
            "idle_gaps": [[k, v] for k, v in run.trace.idle_by_host[:10]],
        }
    out["checks"] = checks
    return out

