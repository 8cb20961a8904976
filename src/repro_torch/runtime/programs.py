"""Captured programs: the port's counterpart of ``jax.jit`` for a unit of
device work, as CUDA graphs.

:class:`Captures` holds the rule every compiled unit of the port follows
(the serve engine's step programs, the offload pipeline's blocked LU and
loop-offload stages, the zoo planner's cells).  On a CUDA device a key

* runs its first call eagerly.  That is the warm-up: it builds the kernel
  library at first use and sets the kernels' one-time statics (shared-memory
  limits, the tensor-map encoder, a device's constants); its result is the
  call's result;
* is captured at its second call into a ``torch.cuda.CUDAGraph`` and
  replayed.  Capture executes nothing, so the replay produces the result;
* replays at every later call.

A key is whatever changes the captured work; the caller builds it.  The
kernel wrappers count their launches in Python, which a replay never runs:
the counts a capture made are taken back and added at every replay
(:func:`repro_torch.kernels.add_counters`), so a graphed run counts as an
eager one does.  A failed capture or replay raises: there is no eager
fallback.  A replay overwrites its graph's outputs (and its scratch in the
graph's pool), so a caller reads them, or copies them, before the next
replay.

:class:`Program` runs a function of tensors by that rule.  With
``static=True`` its tensor arguments are copied into static buffers of the
program (one set per key of shapes and dtypes), so a call may pass new
tensors; with ``static=False`` they are read in place and their addresses
are part of the key (a graph reads the addresses it captured).  Off CUDA a
program calls its function directly.
"""

from __future__ import annotations

import gc
import time
import warnings
from typing import Any, Callable, Hashable

import torch

from repro_torch import kernels
from repro_torch.core import blocks


class Graph:
    """One call captured in a CUDA graph; :meth:`replay` returns the
    graph's static outputs."""

    def __init__(self, run: Callable[[], Any], pool: Any) -> None:
        self.graph = torch.cuda.CUDAGraph()
        # a dead engine's graphs are freed by the cycle collector; freed
        # during a capture, a graph's teardown invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with warnings.catch_warnings():
                # a unit that only returns views of its inputs (a transpose
                # stage) captures no kernel: its empty graph replays nothing
                warnings.filterwarnings("ignore", "The CUDA Graph is empty")
                with torch.cuda.graph(self.graph, pool=pool):
                    self.outputs = run()
        finally:
            if collecting:
                gc.enable()

    def replay(self) -> Any:
        self.graph.replay()
        return self.outputs


class Captures:
    """Per-key warm-up, capture and replay (the rule above).  ``pool`` is
    the graphs' memory pool (None: a private pool per graph)."""

    #: a new key's calls before it replays: its eager first call, then its
    #: capture (a measurement warms a unit up by as many, so it times replays)
    WARMUP_CALLS = 2

    def __init__(self, pool: Any = None) -> None:
        self.pool = pool
        self._seen: set = set()  # keys called once
        self._graphs: dict[Hashable, tuple] = {}  # key -> (graph, counts per replay)
        self.replays = 0
        self.capture_seconds = 0.0

    def __call__(self, key: Hashable, run: Callable[[], Any]) -> Any:
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

    def keys(self) -> list:
        """The captured keys, in capture order."""
        return list(self._graphs)

    def launches_per_replay(self, key: Hashable) -> dict[str, int]:
        """The launch counts one replay of ``key``'s graph adds."""
        return dict(self._graphs[key][1])


def leaves(tree: Any) -> list:
    """The leaves of nested tuples, lists and dicts (dicts in key order)."""
    if isinstance(tree, (tuple, list)):
        return [leaf for e in tree for leaf in leaves(e)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    return [tree]


def _rebuild(tree: Any, it) -> Any:
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(e, it) for e in tree)
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    return next(it)


class Program:
    """``fn(*args, **kwargs)`` over tensors (nested in tuples, lists and
    dicts) on ``device``, captured per key on CUDA: the keyword arguments,
    the tensors' shapes and dtypes (and, unless ``static``, addresses), the
    structure of ``args`` and the block bindings in force, which a graph
    freezes at capture (:mod:`repro_torch.core.blocks`)."""

    def __init__(self, name: str, fn: Callable[..., Any], device: "torch.device | str", *,
                 static: bool = True, pool: Any = None, graphs: bool = True) -> None:
        self.name = name
        self.fn = fn
        self.device = torch.device(device)
        self.static = static
        self.graphed = graphs and self.device.type == "cuda"
        self.captures = Captures(pool)
        self._buffers: dict[Hashable, list[torch.Tensor]] = {}
        self.calls = 0

    @property
    def warmup_calls(self) -> int:
        """Calls of a new key before the program runs as it will from then
        on (read by :func:`repro_torch.core.verify.measure`)."""
        return Captures.WARMUP_CALLS if self.graphed else 1

    def key(self, args: tuple, kwargs: dict) -> tuple:
        tensors = [t for t in leaves(args) if isinstance(t, torch.Tensor)]
        where = (() if self.static else tuple(t.data_ptr() for t in tensors))
        return (tuple(sorted(kwargs.items())), _structure(args),
                tuple((tuple(t.shape), t.dtype) for t in tensors), where,
                blocks.registry.bindings())

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        self.calls += 1
        if not self.graphed:
            return self.fn(*args, **kwargs)
        key = self.key(args, kwargs)
        if self.static:
            args = self._stage(key, args)
        return self.captures(key, lambda: self.fn(*args, **kwargs))

    def _stage(self, key: Hashable, args: tuple) -> tuple:
        """Copy ``args``' tensors into the key's static buffers (the copy
        from a host tensor is the call's host-to-device transfer)."""
        flat = leaves(args)
        bufs = self._buffers.get(key)
        if bufs is None:
            bufs = self._buffers[key] = [
                torch.empty(t.shape, dtype=t.dtype, device=self.device)
                if isinstance(t, torch.Tensor) else t for t in flat
            ]
        for buf, t in zip(bufs, flat):
            if isinstance(t, torch.Tensor):
                buf.copy_(t)
        return _rebuild(args, iter(bufs))

    def summary(self) -> dict:
        """Calls, eager calls, captures, replays and capture seconds."""
        return {
            "calls": self.calls,
            "eager_calls": self.calls - self.captures.replays,
            "captures": len(self.captures.keys()),
            "replays": self.captures.replays,
            "capture_seconds": self.captures.capture_seconds,
        }


def _structure(tree: Any) -> Any:
    """A hashable outline of ``tree``: containers and their keys, and the
    values of the leaves that are not tensors."""
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, tuple(_structure(e) for e in tree))
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(tree[k])) for k in sorted(tree)))
    if isinstance(tree, torch.Tensor):
        return "tensor"
    return ("value", type(tree).__name__, tree)
