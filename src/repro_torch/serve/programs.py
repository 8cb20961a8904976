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
device:

* runs the first call of a key eagerly.  That is the warm-up: it builds the
  kernel library at first use and sets the kernels' one-time statics
  (shared-memory limits, the tensor-map encoder); its result is the step's
  result;
* captures the second call into a ``torch.cuda.CUDAGraph`` (on the
  capture's side stream, into the pool that every program of the engine
  shares, since they never run at once) and replays it.  Capture executes
  nothing, so the replay produces the step;
* replays every later call.  A graph lives as long as its program: a
  program is graphed only where its keys are few by construction (the
  decode step's policies, bucketed prefill lengths), so capture pays for
  itself.

A failed capture or replay raises: there is no eager fallback on CUDA.  A
replay overwrites its graph's outputs and its scratch in the shared pool,
so the caller reads a step's outputs before the next replay of any program
of the pool.  The kernel wrappers count their launches in Python, which a
replay never runs: the counts a capture made are taken back and added at
every replay (:func:`repro_torch.kernels.add_counters`), so a graphed run
counts as an eager one does.

A program that is not graphed (``graphs=False``, or on the CPU) calls the
function directly on the same static buffers, every call.
"""

from __future__ import annotations

import functools
import gc
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.core import blocks

#: the input types a staging buffer carries (4-byte words)
_DTYPES = {np.dtype(np.int32): torch.int32, np.dtype(np.float32): torch.float32}


class Graph:
    """One step captured in a CUDA graph; :meth:`replay` returns the
    graph's static outputs."""

    def __init__(self, run: Callable[[], Any], pool: Any) -> None:
        self.graph = torch.cuda.CUDAGraph()
        # a dead engine's graphs are freed by the cycle collector; freed
        # during a capture, a graph's teardown invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, pool=pool):
                self.outputs = run()
        finally:
            if collecting:
                gc.enable()

    def replay(self) -> Any:
        self.graph.replay()
        return self.outputs


class StepProgram:
    """One step function run through static input buffers; with ``graphs``
    on a CUDA device, captured as a CUDA graph per key.  ``capacity`` is
    the most 4-byte input words one call takes."""

    def __init__(self, name: str, fn: Callable[..., Any], capacity: int,
                 device: torch.device, *, pool: Any = None, graphs: bool = True) -> None:
        self.name = name
        self.fn = fn
        self.graphed = graphs and device.type == "cuda"
        self.pool = pool
        self._host = torch.empty(capacity, dtype=torch.int32, pin_memory=device.type == "cuda")
        self._host_np = self._host.numpy()
        self._dev = torch.empty(capacity, dtype=torch.int32, device=device)
        # the last upload has read the staging buffer once this event is done
        self._copied = torch.cuda.Event() if device.type == "cuda" else None
        self._seen: set = set()  # keys called once (graphed programs only)
        self._graphs: dict[tuple, tuple] = {}  # key -> (graph, counts per replay)
        self.calls = self.replays = 0
        self.capture_seconds = 0.0

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
        entry = self._graphs.get(key)
        if entry is None:
            if key not in self._seen:
                self._seen.add(key)
                return run()
            entry = self._graphs[key] = self._capture(run)
        graph, delta = entry
        out = graph.replay()
        kernels.add_counters(delta)
        self.replays += 1
        return out

    def _capture(self, run: Callable[[], Any]) -> tuple:
        before = kernels.counters()
        t0 = time.perf_counter()
        graph = Graph(run, self.pool)
        self.capture_seconds += time.perf_counter() - t0
        after = kernels.counters()
        delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        kernels.add_counters({k: -n for k, n in delta.items()})  # nothing ran yet
        return graph, delta

    def summary(self) -> dict:
        """Calls, eager calls, captures, replays and capture seconds, and
        the key of each graph."""
        return {
            "calls": self.calls,
            "eager_calls": self.calls - self.replays,
            "captures": len(self._graphs),
            "replays": self.replays,
            "capture_seconds": self.capture_seconds,
            "graphs": [_label(k) for k in self._graphs],
        }


def _label(key: tuple) -> str:
    kwargs, shapes, bindings = key
    parts = [f"{k}={v}" for k, v in kwargs]
    parts.append("inputs " + ",".join("x".join(map(str, s)) or "()" for s in shapes))
    if bindings:
        parts.append("bound " + ",".join(f"{b}:{t}" for b, t in bindings))
    return " ".join(parts)
