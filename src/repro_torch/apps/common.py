"""Staged-application machinery for the loop-offload baseline (the port of
``repro/apps/common.py``).

The prior-work loop offloader ([32][33], reproduced here as the GA baseline)
decides *per loop nest* whether to execute on the CPU (interpreted, naive) or
on the accelerator.  An application is expressed as a sequence of stages —
each stage is one loop nest with a naive implementation and an accelerated
(vectorised torch) implementation on the variant's device.

Key fidelity point: every offloaded stage pays the host<->device boundary
(here: numpy -> device tensor -> numpy), exactly the per-loop
transfer overhead that limits loop-level offloading in the paper and that
function-block offloading eliminates by replacing the *whole* block with one
device-resident implementation.

The reference jits each offloaded stage.  Here each runs as a captured
program (:class:`repro_torch.runtime.programs.Program`) per (stage, device),
keyed by its inputs' shapes and dtypes and shared by every variant that
offloads the stage, as the reference's jit cache is.  The transfers stay
outside the program: the host's arrays are copied into the program's
static inputs, and its outputs are copied back.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Stage:
    """One loop nest of an application."""

    name: str
    naive: Callable[[Any], Any]  # numpy in / numpy out, python loops
    offloaded: Callable[[Any], Any]  # tensors in / tensors out, on a device


#: each offloaded stage's captured program: (stage fn, device) -> Program
_PROGRAMS: dict[tuple, Any] = {}


def stage_program(stage: Stage, device: Any) -> Any:
    """The captured program of ``stage``'s offloaded implementation on
    ``device`` (made at first use)."""
    from repro_torch.runtime.programs import Program

    key = (stage.offloaded, device)
    program = _PROGRAMS.get(key)
    if program is None:
        program = _PROGRAMS[key] = Program(f"stage:{stage.name}", stage.offloaded, device)
    return program


def build_staged_variant(
    stages: Sequence[Stage], genome: Sequence[int], device: Any = None
) -> Callable[[Any], Any]:
    """Build the application variant selected by ``genome``.

    genome[i] == 1 -> stage i runs its offloaded implementation on
    ``device`` (the CUDA card unless ``"cpu"`` is asked for) as a captured
    program, with the host->device->host round trip; 0 -> naive CPU loop.
    """
    import torch

    from repro_torch.kernels.ops import as_tensor, resolve_device

    if len(genome) != len(stages):
        raise ValueError(f"genome length {len(genome)} != stages {len(stages)}")
    device = resolve_device(device)
    programs = [stage_program(s, device) if g else None for s, g in zip(stages, genome)]

    def _to_host(x: Any) -> Any:
        if isinstance(x, tuple):
            return tuple(_to_host(e) for e in x)
        if isinstance(x, torch.Tensor):
            return x.cpu().numpy()
        return np.asarray(x)

    def _canonical(x: Any) -> Any:
        if isinstance(x, tuple):
            return tuple(_canonical(e) for e in x)
        # f64 -> f32, as the reference; the program copies it to the card
        return as_tensor(x, "cpu")

    def run(x: Any) -> Any:
        state = _to_host(x)
        for i, stage in enumerate(stages):
            if genome[i]:
                out = programs[i](_canonical(state))  # host->device in the program's input copy
                state = _to_host(out)  # explicit device->host transfer
            else:
                state = stage.naive(state)
        return state

    run.__name__ = "variant_" + "".join(str(int(b)) for b in genome)
    return run
