"""Fault-tolerant training loop: checkpoint / restart / replay (the port of
``repro/runtime/fault.py``).

The loop owns (i) periodic async checkpoints, (ii) restart-on-failure with
restore from the latest complete checkpoint, (iii) deterministic data replay
(the pipeline is seeded per step, so re-running steps k..n after restoring
step k reproduces the original stream), and (iv) a bounded restart budget so
a persistent fault surfaces instead of looping.

``InjectedFailure`` + the ``failure_hook`` exist so tests (and chaos drills)
can kill the loop at arbitrary steps and assert bit-exact recovery.  The
port's train step updates its tensors in place, so the initial state is
snapshotted to host memory and a restart without a checkpoint rebuilds the
state from that copy.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable

from repro_torch.checkpoint.manager import CheckpointManager, from_host, flatten, to_host, unflatten
from repro_torch.runtime.monitor import StepMonitor

log = logging.getLogger("repro_torch.runtime")


class InjectedFailure(RuntimeError):
    """Raised by test failure hooks to simulate a node loss."""


@dataclasses.dataclass
class LoopResult:
    state: Any
    completed_steps: int
    restarts: int
    straggler_events: int


class FaultTolerantLoop:
    def __init__(
        self,
        step_fn: Callable[[Any, dict, int], Any],  # (state, batch, step) -> state
        batch_fn: Callable[[int], dict],  # step -> batch (deterministic)
        ckpt: CheckpointManager,
        ckpt_every: int = 50,
        max_restarts: int = 3,
        monitor: StepMonitor | None = None,
        failure_hook: Callable[[int], None] | None = None,
    ) -> None:
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.monitor = monitor or StepMonitor()
        self.failure_hook = failure_hook

    def run(self, state: Any, n_steps: int, start_step: int = 0) -> LoopResult:
        restarts = 0
        step = start_step
        # host snapshot of the initial state: a restart that finds no
        # checkpoint must replay from *this*, not from the corrupted
        # in-flight state
        initial = {k: to_host(v) for k, v in flatten(state).items()}
        # resume from the latest checkpoint if one exists
        if self.ckpt.latest_step() is not None:
            step, state = self.ckpt.restore(state)
            log.info("resumed from checkpoint at step %d", step)

        while step < n_steps:
            try:
                while step < n_steps:
                    if self.failure_hook is not None:
                        self.failure_hook(step)
                    batch = self.batch_fn(step)
                    self.monitor.start()
                    state = self.step_fn(state, batch, step)
                    self.monitor.stop(step)
                    step += 1
                    if step % self.ckpt_every == 0:
                        self.ckpt.save(step, state)
            except InjectedFailure as e:
                restarts += 1
                log.warning("failure at step %d: %s (restart %d)", step, e, restarts)
                if restarts > self.max_restarts:
                    raise RuntimeError(f"exceeded restart budget ({self.max_restarts})") from e
                if self.ckpt.latest_step() is not None:
                    step, state = self.ckpt.restore(state)
                else:
                    step = start_step
                    flat = flatten(state)
                    state = unflatten(state, {k: from_host(initial[k], v) for k, v in flat.items()})
        self.ckpt.save(step, state, blocking=True)
        return LoopResult(
            state=state,
            completed_steps=step,
            restarts=restarts,
            straggler_events=len(self.monitor.events),
        )
