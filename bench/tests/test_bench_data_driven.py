"""A cell defined only by new files is found and run: a copy of the data
folders in a temporary root, with a new configuration, traffic mix,
limits file, per-layer metric and cell added as files, and no file
changed."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from bench.harness import driver

ROOT = Path(__file__).resolve().parents[2]


def test_a_cell_from_new_files_only(tmp_path):
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(ROOT / "bench" / sub, tmp_path / "bench" / sub)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    # a new configuration: granite's file under another name, cut to 2 layers
    cfg = json.loads((ROOT / "bench/configs/granite-3-8b.json").read_text())
    cfg["num_hidden_layers"] = 2
    cfg["reduced"] = ["num_hidden_layers"]
    (tmp_path / "bench/configs/granite-3-8b-l2.json").write_text(json.dumps(cfg))
    # a new mix: a backlog of short chats
    mix = json.loads((ROOT / "bench/traffic/chat.json").read_text())
    mix["prompt_len"], mix["output_len"] = [64, 128], [16, 32]
    (tmp_path / "bench/traffic/short-chat.json").write_text(json.dumps(mix))
    (tmp_path / "bench/limits/granite-3-8b-l2.short-chat.json").write_text(
        json.dumps({"widest_logit_gap": 1.0, "reduced": {"widest_logit_gap": 0.01}}))
    # a new per-layer metric: prefill calls in the window
    (tmp_path / "bench/metrics/prefill_calls.py").write_text(
        "def read(run):\n    return run.telemetry['prefill']['calls']\n")
    bench["configs"].append({"name": "granite-3-8b-l2", "source": "https://example.org/x",
                             "file": "bench/configs/granite-3-8b-l2.json",
                             "reduced": ["num_hidden_layers"], "why": "two layers"})
    bench["workloads"].append({"name": "granite-3-8b-l2.short-chat", "config": "granite-3-8b-l2",
                               "traffic": "short-chat", "chips": 1, "why": "short chats"})
    bench["end_to_end"][0]["workloads"].append("granite-3-8b-l2.short-chat")
    bench["per_layer"].append({"name": "prefill_calls", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "engine and scheduler",
                               "moves": "out_tok_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in (ROOT / "bench").rglob("*.json")}

    out = driver.run_cell("granite-3-8b-l2.short-chat", 5, 1.0, False, root=tmp_path,
                          device="cpu", reduced=True, clock=driver.VirtualClock())
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"out_tok_s", "setup_s"}
    traced = driver.run_cell("granite-3-8b-l2.short-chat", 6, 1.0, True, root=tmp_path,
                             device="cpu", reduced=True, clock=driver.VirtualClock())
    # the new metric, with no workloads key, is reported by every cell that
    # reports out_tok_s
    assert traced["metrics"]["prefill_calls"]["value"] >= 0
    assert {p: p.read_bytes() for p in (ROOT / "bench").rglob("*.json")} == before
