"""The port's fault-tolerant loop, on the reference's cases
(``tests/test_runtime.py``: clean run, bit-exact recovery, several
failures, the restart budget, resuming from a checkpoint, straggler
detection), and recovery on a real train step: llama3.2-1b reduced,
``FaultTolerantLoop`` with a checkpoint every 4 steps and a failure
injected at step 6, bit for bit the uninterrupted run's parameters and
moments (on the CPU every op is deterministic)."""

import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.launch.steps import TrainHyper, make_train_step
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamW, tree_leaves
from repro_torch.runtime.fault import FaultTolerantLoop, InjectedFailure
from repro_torch.runtime.monitor import StepMonitor


def _make_loop(tmp_path, fail_at=(), max_restarts=3, ckpt_every=5):
    trace = []

    def step_fn(state, batch, step):
        trace.append(step)
        return {"x": state["x"] + batch["v"]}

    def batch_fn(step):
        return {"v": torch.tensor(float(step), dtype=torch.float64)}  # deterministic replay

    fails = {s: True for s in fail_at}

    def failure_hook(step):
        if fails.pop(step, False):
            raise InjectedFailure(f"node lost at step {step}")

    loop = FaultTolerantLoop(step_fn=step_fn, batch_fn=batch_fn,
                             ckpt=CheckpointManager(tmp_path), ckpt_every=ckpt_every,
                             max_restarts=max_restarts, failure_hook=failure_hook)
    return loop, trace


def _zero():
    return {"x": torch.tensor(0.0, dtype=torch.float64)}


def _expected(n):
    return float(sum(range(n)))


def test_clean_run(tmp_path):
    loop, _ = _make_loop(tmp_path)
    res = loop.run(_zero(), 12)
    assert res.completed_steps == 12 and res.restarts == 0
    assert float(res.state["x"]) == _expected(12)


def test_recovery_is_bit_exact(tmp_path):
    loop, trace = _make_loop(tmp_path, fail_at=(7,))
    res = loop.run(_zero(), 12)
    assert res.restarts == 1
    # steps 5 and 6 replayed after restoring the step-5 checkpoint
    assert trace.count(5) == 2 and trace.count(6) == 2
    assert float(res.state["x"]) == _expected(12)


def test_multiple_failures_within_budget(tmp_path):
    loop, _ = _make_loop(tmp_path, fail_at=(3, 8, 11), max_restarts=5)
    res = loop.run(_zero(), 15)
    assert res.restarts == 3
    assert float(res.state["x"]) == _expected(15)


def test_failure_before_any_checkpoint_replays_from_the_initial_state(tmp_path):
    loop, trace = _make_loop(tmp_path, fail_at=(3,))
    res = loop.run(_zero(), 8)
    assert res.restarts == 1 and trace[:4] == [0, 1, 2, 0]
    assert float(res.state["x"]) == _expected(8)


def test_restart_budget_exceeded_raises(tmp_path):
    def always_fail(step):
        if step == 2:
            raise InjectedFailure("persistent fault")

    loop, _ = _make_loop(tmp_path, max_restarts=2)
    loop.failure_hook = always_fail
    with pytest.raises(RuntimeError, match="restart budget"):
        loop.run(_zero(), 10)


def test_resume_from_existing_checkpoint(tmp_path):
    loop1, _ = _make_loop(tmp_path)
    loop1.run(_zero(), 10)
    # a fresh process picks up at the last checkpoint, not step 0
    loop2, trace2 = _make_loop(tmp_path)
    res = loop2.run(_zero(), 15)
    assert min(trace2) == 10
    assert float(res.state["x"]) == _expected(15)


def test_straggler_detection_flags_repeat_offender():
    mon = StepMonitor(window=16, threshold=2.0, patience=2)
    for step in range(20):
        mon.observe(step, 0.1, host=0)
    mon.observe(20, 0.5, host=3)
    mon.observe(21, 0.6, host=3)
    assert 3 in mon.flagged_hosts
    assert len(mon.events) >= 2
    assert mon.median_step() == pytest.approx(0.1, rel=0.2)


def _train_run(directory, fail_at=None):
    cfg = get_config("llama3.2-1b").reduced()
    opt = AdamW(moment_dtype=cfg.opt_dtype)
    step_fn = make_train_step(cfg, opt, TrainHyper(base_lr=1e-3, warmup_steps=2, total_steps=10))
    params = lm.init_params(cfg, seed=0)
    data = SyntheticLMData(cfg.vocab_size, 16, 2, seed=0)

    def one_step(state, batch, step):
        b = {k: torch.from_numpy(v) for k, v in batch.items()}
        p, o, _ = step_fn(state["params"], state["opt"], b)
        return {"params": p, "opt": o}

    fails = {fail_at} - {None}

    def hook(step):
        if step in fails:
            fails.discard(step)
            raise InjectedFailure(f"node lost at step {step}")

    loop = FaultTolerantLoop(one_step, data.batch_at, CheckpointManager(directory),
                             ckpt_every=4, failure_hook=hook)
    return loop.run({"params": params, "opt": opt.init(params)}, 10)


def test_recovery_on_a_real_train_step_is_bit_exact(tmp_path):
    clean = _train_run(tmp_path / "clean")
    failed = _train_run(tmp_path / "failed", fail_at=6)
    assert clean.restarts == 0 and failed.restarts == 1
    assert failed.completed_steps == clean.completed_steps == 10
    a, b = failed.state, clean.state
    leaves_a = tree_leaves(a["params"]) + tree_leaves(a["opt"].mu) + tree_leaves(a["opt"].nu)
    leaves_b = tree_leaves(b["params"]) + tree_leaves(b["opt"].mu) + tree_leaves(b["opt"].nu)
    assert all(torch.equal(x, y) for x, y in zip(leaves_a, leaves_b))
    assert int(a["opt"].step) == int(b["opt"].step) == 10
