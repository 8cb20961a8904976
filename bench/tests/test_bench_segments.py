"""The readers of the engine's host segments: a number in every traced
cell that lists them (CPU, reduced sizes), and nothing to read where the
program has no segments or the window no call."""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from bench.harness import driver, segments, spec

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 91
NAMES = ("decode_host_ms.tput", "decode_host_ms.lat", "decode_launch_ms.tput",
         "decode_launch_ms.lat", "chunk_ms.lat")
READERS = (segments.decode_host_ms, segments.decode_launch_ms, segments.chunk_ms)


def _listing() -> dict[str, list[str]]:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return {m["name"]: m["workloads"] for m in bench["per_layer"] if m["name"] in NAMES}


@pytest.mark.parametrize("name", sorted({c for cells in _listing().values() for c in cells}))
def test_traced_cell_reports_its_segment_metrics(name):
    out = driver.run_cell(name, SEED, 1.0, True, device="cpu", reduced=True,
                          clock=driver.VirtualClock())
    assert out["correct"], out["checks"]
    listed = {m for m, cells in _listing().items() if name in cells}
    cell = spec.load_cell(name)
    assert listed <= {m["name"] for m, _ in cell.per_layer}
    for metric in listed:
        value = out["metrics"][metric]["value"]
        assert value == value and value >= 0, metric


def _run(telemetry: dict) -> SimpleNamespace:
    return SimpleNamespace(telemetry={
        k: {"calls": c, "seconds": s, "tokens": 0} for k, (c, s) in telemetry.items()})


def test_readers_divide_by_their_calls():
    run = _run({"decode": (4, 0.1), "decode.prep": (4, 0.002), "decode.pages": (3, 0.003),
                "decode.launch": (4, 0.004), "decode.commit": (4, 0.001),
                "prefill.chunk": (2, 0.03)})
    assert segments.decode_host_ms(run) == pytest.approx(1.5)  # 6 ms over 4 decode calls
    assert segments.decode_launch_ms(run) == pytest.approx(1.0)
    assert segments.chunk_ms(run) == pytest.approx(15.0)


def test_readers_find_nothing_without_segments_or_calls():
    # a program without the segments: its telemetry has the phases alone
    bare = _run({"prefill": (3, 0.2), "decode": (4, 0.1)})
    assert [r(bare) for r in READERS] == [None, None, None]
    idle = _run({name: (0, 0.0) for name in ("prefill", "decode", "decode.prep", "decode.pages",
                                              "decode.launch", "decode.commit",
                                              "prefill.chunk")})
    assert [r(idle) for r in READERS] == [None, None, None]
