"""Verification-environment measurement primitives (paper Step 3) — the
port of ``repro/core/verify.py``.

"Being registered as fast" does not guarantee speed in situ, so the paper
measures candidate patterns in a verification environment.  This module
owns the *measurement* primitives:

  ``measure``          device-blocking median-of-repeats timing (CUDA work
                       is synchronised before the clock stops) with the
                       compile (warm-up) time split out, and an optional
                       ``min_seconds`` floor that re-runs short kernels
                       until the timed window is long enough to be stable;
  ``verify_numerics``  the functional check a winning pattern must pass
                       before deployment.

The pattern *search* itself lives in ``repro_torch.core.planner``: the
paper's single-then-combine procedure is ``planner.SingleThenCombine`` over
a ``planner.SubsetSpace``, and all strategies share one
``planner.MeasurementCache``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable, Sequence

import numpy as np
import torch


def _block(x: Any) -> None:
    """Wait for the device work behind ``x`` (any tree :func:`flatten`
    takes): PyTorch returns from a CUDA call before the card finishes, so
    without this ``measure`` would time the launches only."""
    for leaf in flatten(x)[0]:
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
            return


def flatten(x: Any) -> tuple[list[Any], Any]:
    """Leaves and structure of nested tuples / lists / dicts / dataclasses
    (the port's counterpart of ``jax.tree.flatten`` for
    ``verify_numerics``; a train step returns an ``OptState``)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        fields = {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
        leaves, tree = flatten(fields)
        return leaves, (type(x).__name__, tree)
    if isinstance(x, (tuple, list)):
        leaves: list[Any] = []
        kids = []
        for e in x:
            sub, tree = flatten(e)
            leaves.extend(sub)
            kids.append(tree)
        return leaves, (type(x).__name__, tuple(kids))
    if isinstance(x, dict):
        leaves = []
        kids = []
        for k in sorted(x):
            sub, tree = flatten(x[k])
            leaves.extend(sub)
            kids.append((k, tree))
        return leaves, ("dict", tuple(kids))
    return [x], "*"


def _host(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class Measurement:
    seconds: float  # median runtime
    compile_seconds: float  # first (warm-up) call minus median
    repeats: int
    energy_joules: float | None = None  # per call, when a PowerMeter is wired
    # "measured" (hardware counter over the trial window) vs "estimated"
    # (modelled, e.g. time-proportional draw or apportioned from a fused
    # window); None when no meter produced a reading.  Kept on every
    # measurement so mixed metered/estimated rankings stay auditable.
    energy_provenance: str | None = None


def warmup_count(fn: Callable[..., Any], warmup: int) -> int:
    """The warm-up calls a trial of ``fn`` makes: ``warmup``, raised to the
    ``warmup_calls`` that ``fn`` reports (none when ``warmup`` is 0)."""
    return max(warmup, getattr(fn, "warmup_calls", 0)) if warmup > 0 else 0


def measure(
    fn: Callable[..., Any],
    args: Sequence[Any],
    repeats: int = 3,
    warmup: int = 1,
    min_seconds: float = 0.0,
) -> Measurement:
    """Median seconds per call; ``min_seconds`` > 0 repeats each timed
    window until it spans at least that much wall time (per-call time is
    the window divided by the call count), which stabilises sub-millisecond
    kernels whose single-call time is dominated by timer/dispatch noise.

    ``fn`` may report ``warmup_calls``, the calls it takes before it runs
    as it will be timed (a captured unit on CUDA: its eager first call and
    its capture); the warm-up makes at least that many, so no timed call
    runs a capture."""
    t0 = time.perf_counter()
    for _ in range(warmup_count(fn, warmup)):
        _block(fn(*args))
    warm = time.perf_counter() - t0
    times = []
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        calls = 0
        while True:
            _block(fn(*args))
            calls += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= min_seconds:
                break
        times.append(elapsed / calls)
    times.sort()
    med = times[len(times) // 2]
    return Measurement(
        seconds=max(med, 1e-9),
        compile_seconds=max(warm - med, 0.0),
        repeats=len(times),
    )


@dataclasses.dataclass
class Trial:
    pattern: tuple[str, ...]  # names of blocks offloaded in this variant
    seconds: float
    speedup: float  # vs baseline


@dataclasses.dataclass
class VerificationReport:
    baseline_seconds: float
    trials: list[Trial]
    best: Trial
    search_seconds: float  # total wall time of the search (paper headline)

    def trial(self, pattern: Iterable[str]) -> Trial | None:
        key = tuple(sorted(pattern))
        for t in self.trials:
            if tuple(sorted(t.pattern)) == key:
                return t
        return None


def verify_numerics(
    original: Callable[..., Any],
    substituted: Callable[..., Any],
    args: Sequence[Any],
    rtol: float = 1e-3,
    atol: float = 1e-3,
) -> bool:
    """Functional check that a substitution preserves results (the paper's
    動作検証 step before deployment).

    Structure-aware: outputs may be arrays or tensors, tuples (engine
    apps) or nested containers (bound model steps) — structures must match
    leaf for leaf.
    Low-precision floats (bfloat16) widen to f64 and complex stays complex
    so the tolerance arithmetic is well-defined.
    """
    a = original(*args)
    b = substituted(*args)

    la, ta = flatten(a)
    lb, tb = flatten(b)
    if ta != tb:
        return False

    def widen(x):
        # complex stays complex; float (incl. bfloat16, numpy kind 'V')
        # widens to f64 so allclose arithmetic is well-defined
        if x.dtype.kind == "c":
            return x.astype(np.complex128)
        if x.dtype.kind in "fV":
            return x.astype(np.float64)
        return x

    for x, y in zip(la, lb):
        x = _host(x)
        y = _host(y)
        if x.shape != y.shape:
            return False
        if not np.allclose(widen(x), widen(y), rtol=rtol, atol=atol):
            return False
    return True
