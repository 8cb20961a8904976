"""The port's training CLI (``repro_torch.launch.train``) on the CPU, and
the zoo planner's ``train`` cell: the CLI's printed lines (as the
reference's), its checkpoints (a second run resumes), its refusals (the
card by default, unknown executors and meters), a stored
``zoo:<arch>:train`` plan bound at startup, and the module run as a
process."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch import train
from repro_torch.offload import zoo

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--arch", "llama3.2-1b", "--reduced", "--batch", "2", "--seq", "16", "--device", "cpu",
        "--log-every", "2"]


def test_cli_trains_on_the_cpu_and_resumes_from_its_checkpoint(tmp_path, capsys):
    ckpt = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "4"]
    assert train.main(ARGS + ["--steps", "6"] + ckpt) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=llama3.2-1b-reduced params=") and out[0].endswith("M")
    losses = [float(line.split()[3]) for line in out if line.startswith("step ")]
    assert len(losses) == 3 and all(l == l and 0 < l < 20 for l in losses)  # steps 0, 2, 4
    assert out[-1].startswith("done: 6 steps, 0 restarts, final loss ")
    # a second run with more steps picks up at the last checkpoint (step 6)
    assert train.main(ARGS + ["--steps", "8"] + ckpt) == 0
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[1] for line in out if line.startswith("step ")] == ["6"]
    assert out[-1].startswith("done: 8 steps, 0 restarts")


def test_cli_microbatch_and_layers(tmp_path, capsys):
    assert train.main(ARGS + ["--steps", "2", "--microbatch", "2", "--layers", "1",
                              "--ckpt-dir", str(tmp_path)]) == 0
    assert capsys.readouterr().out.splitlines()[-1].startswith("done: 2 steps")


def test_cli_refusals(tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train.main(ARGS[:-4] + ["--steps", "1", "--ckpt-dir", str(tmp_path)])
    # every executor and meter name is ported: only unknown names are refused
    for flag in (["--executor", "warp-drive"], ["--meter", "geiger"]):
        with pytest.raises(SystemExit):
            train.main(ARGS + ["--steps", "1", "--ckpt-dir", str(tmp_path)] + flag)


def test_zoo_train_cell_is_pure_and_its_plan_binds(tmp_path, capsys):
    """A train cell's step runs on copies (its trials all start from the
    cell's state, as the reference's pure step); the plan it commits binds
    at the CLI's startup."""
    builder, (params, state, batch), cfg = zoo._cell_target(
        "llama3.2-1b", "train", reduced=True, layers=1, batch=2, seq=8, seed=0, device="cpu")
    step = builder()
    before = params["embed"]["embedding"].clone()
    p1, s1, m1 = step(params, state, batch)
    p2, s2, m2 = step(params, state, batch)
    assert torch.equal(params["embed"]["embedding"], before) and int(state.step) == 0
    assert int(s1.step) == 1 and torch.equal(m1["loss"], m2["loss"])
    assert torch.equal(p1["embed"]["embedding"], p2["embed"]["embedding"])
    assert not torch.equal(p1["embed"]["embedding"], before)

    plans = str(tmp_path / "plans")
    assert train.main(ARGS + ["--steps", "2", "--ckpt-dir", str(tmp_path / "ck"),
                              "--plan-dir", plans, "--plan-search", "--layers", "1"]) == 0
    out = capsys.readouterr().out
    assert "searching offload plans for llama3.2-1b: ['train']" in out
    assert "bound offload plan 'zoo:llama3.2-1b:train'" in out
    assert zoo.default_plan_key(plans, "llama3.2-1b", "train") == "zoo:llama3.2-1b:train"


def test_cli_runs_as_a_module(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *ARGS, "--steps", "3",
         "--ckpt-dir", str(tmp_path)],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.splitlines()[-1].startswith("done: 3 steps, 0 restarts")
