"""Every cell end to end on the CPU, at the port's reduced config and the
mix's ``reduced`` sizes: set-up, window, metrics and the reference check,
as ``bench/run.py`` runs it on the card (the harness's look for a card
skipped)."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from bench.harness import driver, spec

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2**31 + 77  # larger than 32 signed bits hold


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_the_cpu(name, trace):
    out = driver.run_cell(name, SEED + trace, 1.0, bool(trace), device="cpu", reduced=True,
                          clock=driver.VirtualClock())
    cell = spec.load_cell(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert out["device"]["platform"] == "cpu"
    if trace:
        # no card, no device trace: the device readers find nothing to read
        assert not {m["name"] for m, _ in cell.per_layer if m["source"] == "device_trace"} & set(
            out["metrics"])
    else:
        assert set(out["metrics"]) == {m["name"] for m, _ in cell.end_to_end}
    for m in out["metrics"].values():
        assert m["value"] == m["value"] and m["value"] >= 0  # a number, not NaN


def test_every_cell_names_files_that_exist():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.end_to_end and cell.per_layer
        e2e = {m["name"] for m, _ in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        for m, _ in cell.per_layer:  # every per-layer metric moves one this cell reports
            assert m["moves"] in e2e
