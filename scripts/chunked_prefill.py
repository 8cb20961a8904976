#!/usr/bin/env python3
"""Chunked prefill against eager exact-length prefill on one H100.

    python3 scripts/chunked_prefill.py [CHUNK]

Serves chip_smoke.py's phase-4 trace (llama3.2-1b at full size, paged,
page_size 16, 8 slots, 16 requests of U[64, 512] prompt tokens and 32 new
tokens) with ``ServeEngine`` in one process, in turns unchunked, chunked,
chunked, unchunked (``prefill_chunk=CHUNK``, default 128), each on a fresh
engine, so the chunked and unchunked runs share one card and one warm
kernel library.  Then one more chunked run with the tracer on, whose spans
split the decode steps into those of engine steps that also ran a prefill
chunk and those that did not, and give each chunk program's wall ms; last,
``torch.profiler`` over replays of that engine's ``extend`` program (a
128-token chunk from position 384): device ms per chunk by kernel.

Prints one JSON line per run: wall seconds, tok/s, prefill and decode
seconds, the median decode step, TTFT and latency p50 / p99, prefill
calls, chunks and the final chunks' re-extended positions
(``overlap_tokens``), and the step programs' ``graphs``.
"""

import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def serve(torch, chunk, tracer=None) -> tuple:
    import numpy as np

    import chip_smoke as c
    from repro_torch.serve import Request, ServeEngine

    cfg = c._serve_config("llama3.2-1b")
    c._free_dead_engines(torch)
    engine = ServeEngine(cfg, seed=0, device="cuda", n_slots=8, max_len=1024, page_size=16,
                         prefill_chunk=chunk, tracer=tracer)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(64, 513))).tolist()
               for _ in range(16)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in prompts:
        engine.submit(Request(p, max_new_tokens=32))
    done = engine.run_until_idle(max_steps=10_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pct = lambda xs, q: float(np.percentile(xs, q))  # noqa: E731
    ttft = [d.ttft * 1e3 for d in done]
    lat = [d.latency * 1e3 for d in done]
    row = {
        "prefill_chunk": chunk, "traced": tracer is not None, "wall_seconds": wall,
        "tok_per_s": 32 * len(done) / wall,
        "prefill_seconds": engine.telemetry["prefill"].seconds,
        "decode_seconds": engine.telemetry["decode"].seconds,
        "decode_median_ms": engine.median_decode_step() * 1e3,
        "ttft_p50_ms": pct(ttft, 50), "ttft_p99_ms": pct(ttft, 99),
        "latency_p50_ms": pct(lat, 50), "latency_p99_ms": pct(lat, 99),
        "prefill_calls": engine.stats.prefill_calls, "prefill_chunks": engine.stats.prefill_chunks,
        "decode_steps": engine.stats.decode_steps, "overlap_tokens": engine.overlap_tokens,
        "graphs": {k: {f: v for f, v in g.items() if f != "graphs"}
                   for k, g in engine.graph_stats().items()},
    }
    return row, engine


def split_by_chunks(engine) -> dict:
    """Decode ms of engine steps with and without a prefill chunk, and the
    chunk programs' ms (the first call of each is eager, the second its
    capture)."""
    chunk_steps, decode, chunks = set(), {}, {"extend": [], "extend_sample": []}
    for rec in engine.tracer.records():
        args = rec.args or {}
        if rec.name == "prefill-chunk":
            chunk_steps.add(args["step"])
            chunks["extend_sample" if args["final"] else "extend"].append(rec.duration * 1e3)
        elif rec.name == "decode" and "batch" in args:  # the engine track's span
            decode[args["step"]] = rec.duration * 1e3
    with_chunk = [ms for step, ms in decode.items() if step in chunk_steps]
    without = [ms for step, ms in decode.items() if step not in chunk_steps]
    med = lambda xs: statistics.median(xs) if xs else None  # noqa: E731
    return {
        "decode_steps_with_chunk": len(with_chunk), "decode_ms_with_chunk_median": med(with_chunk),
        "decode_steps_without_chunk": len(without), "decode_ms_without_median": med(without),
        "extend_ms": chunks["extend"], "extend_sample_ms": chunks["extend_sample"],
        "extend_replay_ms_median": med(chunks["extend"][2:]),
        "extend_sample_replay_ms_median": med(chunks["extend_sample"][2:]),
    }


def profile_chunk(torch, engine, n: int = 5) -> dict:
    """Device ms of ``n`` replays of the ``extend`` program, by kernel."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as c

    program = engine.programs["extend"]
    i32 = lambda v: np.asarray([v], np.int32)  # noqa: E731
    tokens = np.random.default_rng(3).integers(0, engine.cfg.vocab_size, (1, engine.prefill_chunk))
    inputs = [i32(0), i32(384), np.arange(engine.kv.max_pages, dtype=np.int32)[None],
              tokens.astype(np.int32)]
    replays = program.captures.replays
    program(inputs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        program(inputs)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            program(inputs)
        torch.cuda.synchronize()
    if program.captures.replays - replays != 2 * n + 1:
        raise AssertionError("profile_chunk: the extend calls were not all replays")
    device, events = c._device_events(prof)
    top = sorted(device.items(), key=lambda kv: -kv[1])[:12]
    return {"chunk_wall_ms": wall, "chunk_device_ms": sum(device.values()) / n,
            "chunk_device_events": events / n,
            "chunk_top_device_ms": {k[:90]: v / n for k, v in top}}


def main() -> int:
    import torch

    import chip_smoke as c
    from repro_torch.obs import Tracer

    if not torch.cuda.is_available():
        print("chunked_prefill: needs the CUDA card", file=sys.stderr)
        return 2
    chunk = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    torch.backends.cuda.matmul.allow_tf32 = False
    print(c.nvidia_smi(), flush=True)
    with torch.no_grad():
        for turn in (None, chunk, chunk, None):
            row, _ = serve(torch, turn)
            print(json.dumps(row), flush=True)
        row, engine = serve(torch, chunk, Tracer())
        row.update(split_by_chunks(engine))
        row.update(profile_chunk(torch, engine))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
