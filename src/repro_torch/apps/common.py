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


def build_staged_variant(
    stages: Sequence[Stage], genome: Sequence[int], device: Any = None
) -> Callable[[Any], Any]:
    """Build the application variant selected by ``genome``.

    genome[i] == 1 -> stage i runs its offloaded implementation on
    ``device`` (the CUDA card unless ``"cpu"`` is asked for), with the
    host->device->host round trip; 0 -> naive CPU loop.
    """
    import torch

    from repro_torch.kernels.ops import as_tensor, resolve_device

    if len(genome) != len(stages):
        raise ValueError(f"genome length {len(genome)} != stages {len(stages)}")
    device = resolve_device(device)

    def _to_host(x: Any) -> Any:
        if isinstance(x, tuple):
            return tuple(_to_host(e) for e in x)
        if isinstance(x, torch.Tensor):
            return x.cpu().numpy()
        return np.asarray(x)

    def _to_dev(x: Any) -> Any:
        if isinstance(x, tuple):
            return tuple(_to_dev(e) for e in x)
        return as_tensor(x, device)  # canonicalised: f64 -> f32, as the reference

    def run(x: Any) -> Any:
        state = _to_host(x)
        for i, stage in enumerate(stages):
            if genome[i]:
                out = stage.offloaded(_to_dev(state))
                state = _to_host(out)  # explicit device->host transfer
            else:
                state = stage.naive(state)
        return state

    run.__name__ = "variant_" + "".join(str(int(b)) for b in genome)
    return run
