"""The control, on the card at each cell's own size: the reference with
fp8 operands put in the program's place reads over the cell's limit, while
the program reads under it, on the same prompts and served tokens.  The
limits were set from these readings over a dozen seeds and more
(``bench/calibrate.py``, PERF.md); here three seeds a cell.  Run on the
card with ``python -m pytest -m chip bench``."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from bench.harness import driver

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(chip, name):
    for seed in (901, 902, 903):
        kept = {}
        out = driver.run_cell(name, seed, 6.0, False, root=ROOT, control=True, keep=kept)
        checks = out["checks"]
        # the control fails one of the cell's numbers; the program none
        assert any(c["value"] > c["limit"] for k, c in checks.items() if k.startswith("control_"))
        assert not kept["control_result"]["correct"], checks
        assert out["correct"], checks
