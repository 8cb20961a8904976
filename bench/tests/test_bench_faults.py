"""A run with the timed path broken underneath comes out not correct, for
each fault a served model's cell can have (:mod:`bench.harness.faults`).
The harness's look for a card is skipped: the run is on the CPU at the
reduced sizes, against the reduced limit."""

from __future__ import annotations

import pytest

from bench.harness import driver, faults

CELL = "granite-3-8b.long-decode"
MLA_CELL = "deepseek-v2-236b-daaa.chat"


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", [CELL, MLA_CELL])
def test_a_broken_path_is_not_correct(monkeypatch, name, fault):
    faults.FAULTS[fault](monkeypatch.setattr)
    # every finished request checked, so that rows of both halves are
    out = driver.run_cell(name, 11, 1.0, False, device="cpu", reduced=True,
                          clock=driver.VirtualClock(),
                          overrides={"check_requests": 64})
    assert not out["correct"], out["checks"]
    gap = out["checks"]["widest_logit_gap"]  # the reduced limits compare the widest gap
    assert gap["value"] > gap["limit"]


def test_the_sound_path_is_correct_on_several_seeds():
    for seed in (21, 22, 23):
        out = driver.run_cell(CELL, seed, 1.0, False, device="cpu", reduced=True,
                          clock=driver.VirtualClock())
        assert out["correct"], out["checks"]



@pytest.mark.parametrize("name", [CELL, MLA_CELL])
def test_the_control_goes_through_the_runs_verdict(name):
    # the control's readings in the program's place, judged as a run is
    # (bench/calibrate.py's control_correct; its limits are the card's, so
    # the verdict itself is read there)
    kept = {}
    out = driver.run_cell(name, 12, 1.0, False, device="cpu", reduced=True,
                          clock=driver.VirtualClock(), control=True, keep=kept)
    assert out["correct"], out["checks"]
    control = kept["control_result"]
    gap = control["checks"]["widest_logit_gap"]
    assert gap["value"] == kept["gap"]["control"] != kept["gap"]["program"]
    assert control["correct"] == (gap["value"] <= gap["limit"])
