"""Step programs: the serve engine's counterpart of the reference engine's
``jax.jit`` registrations (``repro/serve/engine.py``), as CUDA graphs.

A :class:`StepProgram` wraps one step function.  A step's host inputs
(int32 or float32 numpy arrays) are packed into one pinned staging buffer
and reach the card in one ``copy_(..., non_blocking=True)``, into one
static device buffer whose views the function takes: every call of a key
finds its inputs at the same addresses.

A key is what changes the captured work: the keyword arguments the caller
passes through to the function (a sampling policy), the inputs' shapes (a
prefill's padded length) and the block bindings in force, which a graph
freezes at capture (``core/blocks.py``).  A graphed program on a CUDA
device follows :class:`repro_torch.runtime.programs.Captures`: a key's first
call runs eagerly, its second is captured (on the capture's side stream,
into the pool that every program of the engine shares, since they never
run at once) and replayed, every later call replays.  A graph lives as long
as its program: a program is graphed only where its keys are few by
construction (the decode step's policies, bucketed prefill lengths), so
capture pays for itself.  A replay overwrites its graph's outputs and its
scratch in the shared pool, so the caller reads a step's outputs before the
next replay of any program of the pool.

A program that is not graphed (``graphs=False``, or on the CPU) calls the
function directly on the same static buffers, every call.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core import blocks
from repro_torch.runtime.programs import Captures

#: the input types a staging buffer carries (4-byte words)
_DTYPES = {np.dtype(np.int32): torch.int32, np.dtype(np.float32): torch.float32}


class StepProgram:
    """One step function run through static input buffers; with ``graphs``
    on a CUDA device, captured as a CUDA graph per key.  ``capacity`` is
    the most 4-byte input words one call takes."""

    def __init__(self, name: str, fn: Callable[..., Any], capacity: int,
                 device: torch.device, *, pool: Any = None, graphs: bool = True) -> None:
        self.name = name
        self.fn = fn
        self.graphed = graphs and device.type == "cuda"
        self._host = torch.empty(capacity, dtype=torch.int32, pin_memory=device.type == "cuda")
        self._host_np = self._host.numpy()
        self._dev = torch.empty(capacity, dtype=torch.int32, device=device)
        # the last upload has read the staging buffer once this event is done
        self._copied = torch.cuda.Event() if device.type == "cuda" else None
        self.captures = Captures(pool)
        self.calls = 0

    def inputs(self, arrays: Sequence[np.ndarray]) -> list[torch.Tensor]:
        """Pack ``arrays`` into the staging buffer, upload them in one copy
        and return their views of the static device buffer."""
        if self._copied is not None:
            self._copied.synchronize()
        views, off = [], 0
        for a in arrays:
            a = np.ascontiguousarray(a)
            if a.dtype not in _DTYPES:
                raise TypeError(f"{self.name}: inputs are int32 or float32, got {a.dtype}")
            n = a.size
            if off + n > self._host_np.size:
                raise ValueError(f"{self.name}: inputs exceed {self._host_np.size} words")
            self._host_np[off : off + n] = a.reshape(-1).view(np.int32)
            views.append(self._dev[off : off + n].view(_DTYPES[a.dtype]).view(a.shape))
            off += n
        self._dev[:off].copy_(self._host[:off], non_blocking=True)
        if self._copied is not None:
            self._copied.record()
        return views

    def __call__(self, arrays: Sequence[np.ndarray], **kwargs: Any) -> Any:
        """One step: ``fn(*views of arrays, **kwargs)``, eagerly, captured
        or replayed by the rules above."""
        views = self.inputs(arrays)
        self.calls += 1
        run = functools.partial(self.fn, *views, **kwargs)
        if not self.graphed:
            return run()
        key = (tuple(sorted(kwargs.items())), tuple(v.shape for v in views),
               blocks.registry.bindings())
        return self.captures(key, run)

    def summary(self) -> dict:
        """Calls, eager calls, captures, replays and capture seconds, and
        the key of each graph."""
        captures = self.captures
        return {
            "calls": self.calls,
            "eager_calls": self.calls - captures.replays,
            "captures": len(captures.keys()),
            "replays": captures.replays,
            "capture_seconds": captures.capture_seconds,
            "graphs": [_label(k) for k in captures.keys()],
        }


def _label(key: tuple) -> str:
    kwargs, shapes, bindings = key
    parts = [f"{k}={v}" for k, v in kwargs]
    parts.append("inputs " + ",".join("x".join(map(str, s)) or "()" for s in shapes))
    if bindings:
        parts.append("bound " + ",".join(f"{b}:{t}" for b, t in bindings))
    return " ".join(parts)
