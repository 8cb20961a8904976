"""The port's observability on the CPU: ``repro_torch.obs`` (tracer,
metrics registry, timeline, metrics server, profile window), the step
monitor, and the serve engine's spans, events and ``serve_*`` metrics.

The tracer, registry and timeline tests are the port's copies of
``tests/test_obs.py``'s.  The engine's tests run the reference's engine
tests on the port, and hold the port's span names and counts and its
registry's ``serve_*`` counters equal to ``repro.serve.ServeEngine``'s on the
same trace (llama3.2-1b reduced, f32, chunked prefill on the paged cache
with preemption).  The serve CLI writes a Chrome trace that
``repro_torch.obs.timeline --check`` accepts and a Prometheus file.
"""

import collections
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import lm as jlm
from repro.obs import Tracer as JTracer
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.obs import (
    NULL_SPAN,
    MetricsRegistry,
    MetricsServer,
    Tracer,
    exponential_buckets,
    get_tracer,
    profile_window,
    profiler_available,
    set_tracer,
    timeline,
)
from repro_torch.metering import TimeProportionalPower
from repro_torch.runtime.monitor import StepMonitor
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.engine import PHASES, SEGMENTS

ROOT = Path(__file__).resolve().parents[1]


# -- tracer -------------------------------------------------------------------


def test_span_context_records_duration():
    tr = Tracer()
    with tr.span("work", step=3):
        time.sleep(0.002)
    (rec,) = tr.records()
    assert rec.name == "work"
    assert rec.ph == "X"
    assert rec.args == {"step": 3}
    assert rec.duration >= 0.002


def test_retroactive_span_and_instant_event():
    tr = Tracer()
    t0 = time.perf_counter()
    tr.add_span("queue", t0, t0 + 0.5, tid=7, request=1)
    tr.event("preempt", tid=7, request=1)
    spans = tr.records()
    assert [r.ph for r in spans] == ["X", "i"]
    assert spans[0].tid == 7 and spans[0].duration == pytest.approx(0.5)
    # a clock-skewed t1 < t0 clamps to zero duration instead of exporting
    # a negative dur (which trace viewers reject)
    tr.add_span("skewed", t0 + 1.0, t0 + 0.5)
    assert tr.records()[-1].duration == 0.0


def test_ring_buffer_drops_oldest_and_counts():
    tr = Tracer(capacity=4)
    for i in range(10):
        tr.event(f"e{i}")
    assert len(tr) == 4
    assert [r.name for r in tr.records()] == ["e6", "e7", "e8", "e9"]
    assert tr.dropped == 6
    assert tr.to_chrome()["otherData"]["dropped_records"] == 6
    tr.clear()
    assert len(tr) == 0 and tr.dropped == 0


def test_disabled_tracer_is_free():
    tr = Tracer(enabled=False)
    # the no-op span is one shared singleton — no allocation per call
    assert tr.span("a") is NULL_SPAN
    assert tr.span("b", tid=9, big="arg") is NULL_SPAN
    with tr.span("c"):
        pass
    tr.event("x")
    tr.add_span("y", 0.0, 1.0)
    assert len(tr) == 0


def test_default_process_tracer_disabled_and_swappable():
    assert get_tracer().enabled is False
    installed = set_tracer(Tracer())
    try:
        assert get_tracer() is installed
        with get_tracer().span("visible"):
            pass
        assert [r.name for r in installed.records()] == ["visible"]
    finally:
        set_tracer(None)
    assert get_tracer().enabled is False


def test_threaded_recording_keeps_every_span_ordered():
    """Concurrent recorders (the DeviceParallelExecutor shape): no record
    is lost, and each thread's own spans stay in its program order."""
    tr = Tracer()
    n_threads, per_thread = 8, 50
    barrier = threading.Barrier(n_threads)  # all threads alive at once,
    # so the OS can't recycle thread idents across workers

    def work(k):
        barrier.wait()
        for i in range(per_thread):
            with tr.span("job", worker=k, seq=i):
                pass

    threads = [
        threading.Thread(target=work, args=(k,)) for k in range(n_threads)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    recs = tr.records()
    assert len(recs) == n_threads * per_thread
    by_worker = {}
    for r in sorted(recs, key=lambda r: r.t0):
        by_worker.setdefault(r.args["worker"], []).append(r.args["seq"])
    assert set(by_worker) == set(range(n_threads))
    for seqs in by_worker.values():
        assert seqs == sorted(seqs)
    # distinct threads land on distinct tracks
    assert len({r.tid for r in recs}) == n_threads


def test_chrome_export_is_viewer_valid(tmp_path):
    tr = Tracer()
    tr.name_track(0x5E54_0001, "req 1")
    t0 = time.perf_counter()
    tr.add_span("queue", t0, t0 + 0.01, tid=0x5E54_0001, request=1)
    with tr.span("decode", batch=2):
        pass
    tr.event("complete", tid=0x5E54_0001, request=1)
    doc = tr.to_chrome()
    assert doc["displayTimeUnit"] == "ms"
    events = doc["traceEvents"]
    # metadata names the virtual request track
    meta = [e for e in events if e["ph"] == "M"]
    assert meta and meta[0]["args"]["name"] == "req 1"
    # the exported structure passes the timeline validator and is real JSON
    path = tmp_path / "trace.json"
    tr.write_chrome(str(path))
    loaded = timeline.load_events(str(path))
    assert timeline.validate(loaded) == []
    spans = [e for e in loaded if e["ph"] == "X"]
    assert all(e["ts"] >= 0 and e["dur"] >= 0 for e in spans)
    # spans sorted by start time, timestamps in µs relative to the epoch
    assert [e["ts"] for e in spans] == sorted(e["ts"] for e in spans)


def test_timeline_cli_check(tmp_path, capsys):
    tr = Tracer()
    tr.name_track(5, "req 5")
    t0 = time.perf_counter()
    tr.add_span("queue", t0, t0 + 0.01, tid=5, request=5)
    tr.add_span("prefill", t0 + 0.01, t0 + 0.03, tid=5, request=5)
    good = tmp_path / "good.json"
    tr.write_chrome(str(good))
    assert timeline.main([str(good), "--check"]) == 0
    out = capsys.readouterr().out
    assert "queue" in out and "critical path" in out

    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(
        {"traceEvents": [{"ph": "X", "ts": -5, "dur": "oops"}]}
    ))
    assert timeline.main([str(bad), "--check"]) == 1


# -- metrics registry ---------------------------------------------------------


def test_counter_gauge_basics_and_kind_safety():
    reg = MetricsRegistry()
    c = reg.counter("requests_total", "requests")
    c.inc()
    c.inc(4)
    assert c.value == 5
    with pytest.raises(ValueError):
        c.inc(-1)  # counters only go up
    g = reg.gauge("depth", "queue depth")
    g.set(7)
    g.dec(2)
    assert g.value == 5
    with pytest.raises(TypeError):
        c.set(3)  # set() is a gauge operation
    # idempotent re-register returns the same family; schema drift raises
    assert reg.counter("requests_total") is c
    with pytest.raises(ValueError):
        reg.gauge("requests_total")
    with pytest.raises(ValueError):
        reg.counter("requests_total", labelnames=("phase",))
    with pytest.raises(ValueError):
        reg.counter("bad name!")


def test_labeled_family_children_render():
    reg = MetricsRegistry()
    fam = reg.counter("phase_tokens_total", "tokens", labelnames=("phase",))
    fam.labels(phase="prefill").inc(10)
    fam.labels(phase="decode").inc(32)
    assert fam.labels(phase="decode") is fam.labels(phase="decode")
    with pytest.raises(KeyError):
        fam.labels(stage="decode")
    with pytest.raises(KeyError):
        fam.inc()  # labeled family has no sole child
    text = reg.render_prometheus()
    assert '# TYPE phase_tokens_total counter' in text
    assert 'phase_tokens_total{phase="decode"} 32' in text
    assert 'phase_tokens_total{phase="prefill"} 10' in text


def test_prometheus_escaping():
    reg = MetricsRegistry()
    reg.counter(
        "odd_total", 'help with \\ and\nnewline', labelnames=("k",)
    ).labels(k='va"l\\ue\n').inc()
    text = reg.render_prometheus()
    assert '# HELP odd_total help with \\\\ and\\nnewline' in text
    assert 'odd_total{k="va\\"l\\\\ue\\n"} 1' in text


def test_histogram_buckets_cumulative_and_sums():
    reg = MetricsRegistry()
    h = reg.histogram("lat_seconds", "latency", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.05, 0.5, 5.0):
        h.observe(v)
    text = reg.render_prometheus()
    assert 'lat_seconds_bucket{le="0.01"} 1' in text
    assert 'lat_seconds_bucket{le="0.1"} 3' in text
    assert 'lat_seconds_bucket{le="1"} 4' in text
    assert 'lat_seconds_bucket{le="+Inf"} 5' in text
    assert 'lat_seconds_count 5' in text
    sum_line = [
        line for line in text.splitlines()
        if line.startswith("lat_seconds_sum")
    ][0]
    assert float(sum_line.split()[-1]) == pytest.approx(5.605)
    with pytest.raises(ValueError):
        exponential_buckets(start=0.0)
    assert len(exponential_buckets(1e-3, 2.0, 4)) == 4


def test_registry_reset_keeps_child_handles_valid():
    reg = MetricsRegistry()
    c = reg.counter("n_total", "n", labelnames=("k",)).labels(k="a")
    h = reg.histogram("h_seconds", "h", buckets=(1.0,))
    c.inc(3)
    h.observe(0.5)
    reg.reset()
    assert c.value == 0
    assert 'h_seconds_count 0' in reg.render_prometheus()
    c.inc()  # the pre-reset handle still feeds the family
    assert 'n_total{k="a"} 1' in reg.render_prometheus()


def test_metrics_server_serves_prometheus_text():
    reg = MetricsRegistry()
    reg.counter("up_total", "liveness").inc()
    srv = MetricsServer(reg, port=0)
    try:
        with urllib.request.urlopen(srv.url, timeout=5) as resp:
            body = resp.read().decode()
            ctype = resp.headers["Content-Type"]
        assert "up_total 1" in body
        assert "text/plain" in ctype
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(
                srv.url.replace("/metrics", "/other"), timeout=5
            )
    finally:
        srv.close()


# -- profile window and step monitor -------------------------------------------


def test_profile_window_writes_a_chrome_trace(tmp_path):
    assert profiler_available()
    tr = Tracer()
    with profile_window(str(tmp_path), tracer=tr, name="window") as captured:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert captured is True
    doc = json.loads((tmp_path / "trace.json").read_text())
    assert doc["traceEvents"]
    (rec,) = tr.records()
    assert rec.name == "window" and rec.args == {"logdir": str(tmp_path), "captured": True}


def test_profile_window_degrades_and_still_runs_the_body(tmp_path, monkeypatch):
    import torch.profiler

    def unavailable(*args, **kwargs):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", unavailable)
    ran = []
    with pytest.warns(UserWarning, match="unavailable"):
        with profile_window(str(tmp_path)) as captured:
            ran.append(True)
    assert captured is False and ran == [True]
    assert not (tmp_path / "trace.json").exists()


def test_step_monitor_feeds_its_histogram_and_flags_stragglers():
    reg = MetricsRegistry()
    hist = reg.histogram("serve_step_seconds", "step")
    flagged = []
    mon = StepMonitor(window=8, threshold=2.0, patience=2, on_straggler=flagged.append,
                      histogram=hist)
    for step in range(8):
        mon.observe(step, 0.01)
    mon.observe(8, 0.05)
    mon.observe(9, 0.05)
    assert hist.value == mon.steps == 10
    assert [e.step for e in flagged] == [8, 9] and mon.flagged_hosts == {0}
    assert mon.median_step() == pytest.approx(0.01)
    assert mon.throughput(4) == pytest.approx(40 / mon.total_time)


# -- serve-engine integration -------------------------------------------------

CFG = get_config("llama3.2-1b").reduced()


@pytest.fixture(scope="module")
def traced_engine():
    """One small engine, 3 requests served under an enabled tracer."""
    engine = ServeEngine(CFG, n_slots=2, max_len=64, seed=0, device="cpu", tracer=Tracer())
    for i in range(3):
        engine.submit(Request([1 + i, 2, 3, 4, 5], max_new_tokens=4))
    completions = engine.run_until_idle(max_steps=500)
    return engine, completions


def test_engine_request_lifecycle_spans(traced_engine, tmp_path):
    engine, completions = traced_engine
    assert len(completions) == 3
    per_request = {}
    for rec in engine.tracer.records():
        req = (rec.args or {}).get("request")
        if req is not None:
            per_request.setdefault(req, set()).add(rec.name)
    assert set(per_request) == {0, 1, 2}
    for kinds in per_request.values():
        assert {"submit", "queue", "kv-alloc", "prefill", "first-token", "decode",
                "kv-free", "complete"} <= kinds
    path = tmp_path / "engine_trace.json"
    engine.tracer.write_chrome(str(path))
    assert timeline.validate(timeline.load_events(str(path))) == []


def test_engine_metrics_parity_with_telemetry(traced_engine):
    """The registry counters and the PhaseTelemetry aggregates are two
    views of the same observations — they must agree exactly."""
    engine, completions = traced_engine
    reg = engine.registry
    for phase, tele in engine.telemetry.items():
        assert reg.get("serve_phase_calls_total").labels(phase=phase).value == tele.calls
        assert reg.get("serve_phase_seconds_total").labels(phase=phase).value == (
            pytest.approx(tele.seconds))
        assert reg.get("serve_phase_tokens_total").labels(phase=phase).value == tele.tokens
        assert tele.joules is None and tele.provenance is None  # no meter
        assert reg.get("serve_phase_joules_total").labels(phase=phase).value == 0
    assert reg.get("serve_requests_submitted_total").value == 3
    assert reg.get("serve_requests_completed_total").value == 3
    assert reg.get("serve_tokens_generated_total").value == sum(
        len(c.tokens) for c in completions)
    assert reg.get("serve_step_seconds").value == engine.monitor.steps
    assert engine.monitor.steps == engine.stats.decode_steps
    text = reg.render_prometheus()
    assert 'serve_phase_calls_total{phase="decode"}' in text
    assert 'serve_step_seconds_bucket{le="+Inf"}' in text


def test_engine_ttft_admitted_and_queue_wait(traced_engine):
    _, completions = traced_engine
    for c in completions:
        assert c.admitted_at is not None
        assert c.queue_wait >= 0.0
        assert 0.0 <= c.ttft_admitted <= c.ttft
        assert c.ttft == pytest.approx(c.queue_wait + c.ttft_admitted)


def test_engine_reset_stats_clears_obs_state():
    engine = ServeEngine(CFG, n_slots=2, max_len=64, seed=0, device="cpu", tracer=Tracer(),
                         page_size=8, prefill_chunk=4)
    engine.submit(Request([1, 2, 3, 4, 5, 6, 7], max_new_tokens=2))
    engine.run_until_idle(max_steps=100)
    assert len(engine.tracer) > 0 and engine.stats.prefill_chunks == 2
    engine.submit(Request([1, 2], max_new_tokens=4))
    engine.step()
    with pytest.raises(RuntimeError, match="busy"):
        engine.reset_stats()
    engine.run_until_idle(max_steps=100)
    engine.reset_stats()
    assert len(engine.tracer) == 0
    assert engine.registry.get("serve_requests_completed_total").value == 0
    stats = engine.stats
    assert (stats.steps, stats.requests_submitted, stats.requests_completed,
            stats.prefill_chunks, stats.decode_steps, stats.slot_reuses) == (0,) * 6
    assert engine.metrics()["prefill_chunks"] == 0 and engine.monitor.steps == 0
    # post-reset traffic still feeds the same child handles
    engine.submit(Request([1, 2, 3], max_new_tokens=2))
    engine.run_until_idle(max_steps=100)
    assert engine.registry.get("serve_requests_completed_total").value == 1
    assert engine.telemetry["decode"].calls == (
        engine.registry.get("serve_phase_calls_total").labels(phase="decode").value)


def test_engine_disabled_tracer_records_nothing():
    """The default engine keeps the disabled process tracer: the run makes
    zero records and never turns it on."""
    engine = ServeEngine(CFG, n_slots=2, max_len=64, seed=0, device="cpu", page_size=8,
                         prefill_chunk=4)
    assert engine.tracer.enabled is False
    engine.submit(Request([1, 2, 3, 4, 5, 6], max_new_tokens=2))
    completions = engine.run_until_idle(max_steps=100)
    assert len(completions) == 1
    assert len(engine.tracer) == 0
    assert engine.registry.get("serve_requests_completed_total").value == 1


def test_engine_meter_still_unported():
    """``meter=`` is ported: a meter feeds ``serve_phase_joules_total``
    with exactly the joules ``telemetry[phase]`` sums."""
    engine = ServeEngine(CFG, n_slots=2, max_len=64, seed=0, device="cpu",
                         meter=TimeProportionalPower(watts=100.0))
    engine.submit(Request([1, 2, 3, 4, 5, 6], max_new_tokens=2))
    engine.run_until_idle(max_steps=100)
    for phase in ("prefill", "decode"):
        tele = engine.telemetry[phase]
        assert tele.joules == pytest.approx(100.0 * tele.seconds)
        assert tele.provenance == "estimated"
        assert engine.registry.get("serve_phase_joules_total").labels(
            phase=phase).value == pytest.approx(tele.joules)


def test_engine_serve_metrics_and_profile_steps(tmp_path):
    engine = ServeEngine(CFG, n_slots=2, max_len=64, seed=0, device="cpu", tracer=Tracer())
    for i in range(2):
        engine.submit(Request([1 + i, 2, 3], max_new_tokens=6))
    assert engine.profile_steps(3, str(tmp_path)) is True
    assert engine.stats.steps == 3
    assert (tmp_path / "trace.json").exists()
    assert [r.name for r in engine.tracer.records() if r.name == "serve-steps"] == ["serve-steps"]
    engine.run_until_idle(max_steps=100)
    srv = engine.serve_metrics(port=0)
    try:
        with urllib.request.urlopen(srv.url, timeout=5) as resp:
            body = resp.read().decode()
        assert "serve_requests_completed_total 2" in body
    finally:
        srv.close()


# -- host segments of a step ----------------------------------------------------------

SEGMENT_KW = dict(n_slots=3, max_len=64, seed=0, device="cpu", page_size=8, n_pages=6,
                  prefill_chunk=8)  # chunks, page growth, preemption
SEGMENT_TRAFFIC = ((30, 6), (5, 12), (21, 4), (9, 8), (17, 5))


def _serve_segments(engine) -> None:
    for i, (n, gen) in enumerate(SEGMENT_TRAFFIC):
        engine.submit(Request([(7 * i + j) % CFG.vocab_size for j in range(n)],
                              max_new_tokens=gen))
    engine.run_until_idle(max_steps=500)


@pytest.fixture(scope="module")
def segmented_engine():
    """A paged, chunked engine under an enabled tracer, run until idle."""
    engine = ServeEngine(CFG, tracer=Tracer(), **SEGMENT_KW)
    _serve_segments(engine)
    return engine


def test_segment_calls_match_what_they_count(segmented_engine):
    engine = segmented_engine
    tele, stats = engine.telemetry, engine.stats
    assert set(tele) == set(PHASES + SEGMENTS)
    assert stats.preemptions > 0 and stats.prefill_chunks > 0
    assert tele["step"].calls == stats.steps
    for name in ("decode.prep", "decode.launch", "decode.commit"):
        assert tele[name].calls == tele["decode"].calls == stats.decode_steps, name
    # uploads only: a step whose table did not change skips the segment
    assert 0 < tele["decode.pages"].calls <= tele["decode"].calls
    assert tele["prefill.chunk"].calls == stats.prefill_chunks
    # a chunk counts its new tokens, as the prefill phase does
    chunked = sum(n for n, _ in SEGMENT_TRAFFIC if n > SEGMENT_KW["prefill_chunk"])
    assert tele["prefill.chunk"].tokens >= chunked
    assert tele["prefill.chunk"].tokens <= tele["prefill"].tokens
    reg = engine.registry
    for name in SEGMENTS:
        assert reg.get("serve_phase_calls_total").labels(phase=name).value == tele[name].calls
        assert reg.get("serve_phase_tokens_total").labels(phase=name).value == (
            tele[name].tokens)
        assert reg.get("serve_phase_seconds_total").labels(phase=name).value == (
            pytest.approx(tele[name].seconds))


def test_segment_seconds_nest(segmented_engine):
    tele = segmented_engine.telemetry
    assert all(t.seconds >= 0 for t in tele.values())
    # both lie inside the decode window, one after the other
    assert tele["decode.pages"].seconds + tele["decode.launch"].seconds <= tele["decode"].seconds
    for name in SEGMENTS[1:]:
        assert tele[name].seconds <= tele["step"].seconds, name
    # the step monitor reads the decode window's own seconds
    assert segmented_engine.monitor.total_time == pytest.approx(tele["decode"].seconds)


def test_segment_spans_on_the_engine_track(segmented_engine):
    engine = segmented_engine
    track = threading.get_ident()  # the thread that ran the steps
    counts = collections.Counter(r.name for r in engine.tracer.records()
                                 if r.tid == track and r.ph == "X")
    for name in SEGMENTS:
        assert counts[name] == engine.telemetry[name].calls > 0, name
    steps = [r for r in engine.tracer.records() if r.name == "step"]
    for rec in engine.tracer.records():
        if rec.name in SEGMENTS[1:]:
            assert any(s.t0 <= rec.t0 and rec.t1 <= s.t1 for s in steps), rec


def test_reset_stats_keeps_the_segment_keys():
    engine = ServeEngine(CFG, tracer=Tracer(), **SEGMENT_KW)
    keys = list(engine.telemetry)
    assert keys == list(PHASES + SEGMENTS)
    _serve_segments(engine)
    engine.reset_stats()
    assert list(engine.telemetry) == keys
    assert all(t.calls == 0 and t.seconds == 0 for t in engine.telemetry.values())
    assert engine.registry.get("serve_phase_calls_total").labels(phase="step").value == 0
    engine.submit(Request([1, 2, 3], max_new_tokens=2))
    engine.run_until_idle(max_steps=100)
    assert engine.telemetry["step"].calls == engine.stats.steps > 0
    assert engine.registry.get("serve_phase_calls_total").labels(phase="step").value == (
        engine.stats.steps)


def test_segment_annotations_under_the_profiler(tmp_path):
    """Under a ``torch.profiler`` capture, every segment call is a
    ``serve.<segment>`` user annotation, each inside a ``serve.step``."""
    from torch.profiler import ProfilerActivity, profile

    engine = ServeEngine(CFG, **SEGMENT_KW)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve_segments(engine)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation" and e.get("name", "").startswith("serve.")]
    counts = collections.Counter(e["name"] for e in events)
    assert counts == {f"serve.{name}": engine.telemetry[name].calls for name in SEGMENTS}
    steps = [(e["ts"], e["ts"] + e["dur"]) for e in events if e["name"] == "serve.step"]
    for e in events:
        if e["name"] != "serve.step":
            assert any(a <= e["ts"] and e["ts"] + e["dur"] <= b for a, b in steps), e


def test_no_profiler_range_without_a_capture(monkeypatch):
    """With no capture recording, no segment creates a profiler range."""
    import torch.profiler

    made = []

    def counting(label, *args, **kwargs):
        made.append(label)
        return NULL_SPAN

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    engine = ServeEngine(CFG, **SEGMENT_KW)
    _serve_segments(engine)
    assert engine.telemetry["step"].calls > 0 and engine.telemetry["prefill.chunk"].calls > 0
    assert made == []


# -- span and counter parity with the reference engine -----------------------------------

J32 = dataclasses.replace(jget("llama3.2-1b").reduced(), compute_dtype="float32", remat="none")
F32 = dataclasses.replace(CFG, compute_dtype="float32")
#: every counter the engine and its scheduler write (serve_phase_seconds
#: is wall time, and the gauges are the last step's sample)
COUNTERS = ("serve_requests_submitted_total", "serve_requests_completed_total",
            "serve_tokens_generated_total", "serve_admissions_total",
            "serve_preemptions_total")


def _span_counts(tracer) -> collections.Counter:
    return collections.Counter((r.name, r.ph) for r in tracer.records())


@pytest.mark.parametrize("kw", [
    dict(page_size=8, n_pages=6, prefill_chunk=8),  # chunks, kv-grow, preemption
    dict(prefill_chunk=8),  # contiguous
    dict(page_size=4),  # unchunked
], ids=["chunked_paged_preemption", "chunked_contiguous", "paged"])
def test_span_names_counts_and_counters_match_reference(kw, rng):
    jparams = jlm.init_params(J32, seed=0)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), F32)
    lens, gens = (30, 5, 21, 9, 17), (6, 12, 4, 8, 5)
    prompts = [rng.integers(0, CFG.vocab_size, n).tolist() for n in lens]
    jeng = JServeEngine(J32, params=jparams, n_slots=3, max_len=64, seed=0, tracer=JTracer(),
                        **kw)
    teng = ServeEngine(F32, params=tparams, n_slots=3, max_len=64, seed=0, device="cpu",
                       tracer=Tracer(), **kw)
    for engine, request_cls in ((jeng, JRequest), (teng, Request)):
        for p, g in zip(prompts, gens):
            engine.submit(request_cls(p, max_new_tokens=g))
        engine.run_until_idle(max_steps=500)
    want = _span_counts(jeng.tracer)
    got = _span_counts(teng.tracer)
    # each program registry adds a compile span per new signature of its
    # own programs (a jit signature is not a step program's inputs)
    want.pop(("compile", "X"), None)
    assert got.pop(("compile", "X")) == sum(
        r["signatures"] for r in teng.programs.stats().values())
    # the port's host segments: one span a call, on the engine's track
    for name in SEGMENTS:
        assert got.pop((name, "X"), 0) == teng.telemetry[name].calls, name
    assert got == want
    if "prefill_chunk" in kw:
        assert got[("prefill-chunk", "X")] == teng.stats.prefill_chunks > 0
    if "n_pages" in kw:
        assert got[("preempt", "i")] == teng.stats.preemptions > 0
        assert got[("kv-grow", "i")] > 0
    # the same span args, but times
    def args(tracer, name):
        return [r.args for r in tracer.records() if r.name == name]

    for name in ("prefill-chunk", "queue", "kv-alloc", "submit", "preempt", "kv-free",
                 "complete", "first-token", "kv-grow"):
        assert args(teng.tracer, name) == args(jeng.tracer, name), name
    for name in COUNTERS:
        assert teng.registry.get(name).value == jeng.registry.get(name).value, name
    for phase in ("prefill", "decode"):
        for name in ("serve_phase_calls_total", "serve_phase_tokens_total"):
            assert (teng.registry.get(name).labels(phase=phase).value
                    == jeng.registry.get(name).labels(phase=phase).value), (name, phase)
    assert teng.registry.get("serve_step_seconds").value == (
        jeng.registry.get("serve_step_seconds").value)


# -- the CLI ----------------------------------------------------------------------------


def test_serve_cli_chunked_trace_and_metrics_outputs(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.txt"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--reduced",
         "--page-size", "8", "--prefill-chunk", "8", "--requests", "4", "--prompt-len", "20",
         "--len-jitter", "3", "--gen", "4", "--slots", "2", "--max-len", "64",
         "--trace-out", str(trace), "--metrics-out", str(metrics)],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path,
    )
    assert out.returncode == 0, out.stderr
    line = next(ln for ln in out.stdout.splitlines() if ln.startswith("kv pool:"))
    assert int(line.split(", ")[-1].split()[0]) >= 4 and line.endswith("prefill chunks")
    check = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.timeline", str(trace), "--check"],
        capture_output=True, text=True, timeout=120, env=env, cwd=tmp_path,
    )
    assert check.returncode == 0, check.stdout + check.stderr
    assert "OK (" in check.stdout and "prefill-chunk" in check.stdout
    text = metrics.read_text()
    families = {ln.split()[2] for ln in text.splitlines() if ln.startswith("# TYPE")}
    assert {"serve_phase_calls_total", "serve_step_seconds", "serve_admissions_total",
            "serve_requests_completed_total", "serve_kv_utilization_pct"} <= families
    assert 'serve_phase_calls_total{phase="prefill"}' in text
