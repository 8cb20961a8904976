"""Opt-in ``torch.profiler`` capture windows (the port of
``repro/obs/profile.py``, which brackets ``jax.profiler``).

The tracer (:mod:`repro_torch.obs.trace`) answers host-side "why was this
step slow" questions; when the answer is on the card, the next tool down
is the profiler.  :func:`profile_window` records the body with
``torch.profiler`` (CPU activity, and CUDA kernels where a card is present)
and writes a Chrome trace (``trace.json``) into a log directory.  It
degrades to running the body unprofiled (with one warning) where the
profiler is absent or a capture is already running: profiling is never the
reason a serve loop cannot run.

Typical use::

    engine.profile_steps(8, "/tmp/prof")           # N serve steps
"""

from __future__ import annotations

import contextlib
import os
import warnings
from typing import Iterator

__all__ = ["profile_window", "profiler_available"]


def profiler_available() -> bool:
    """True when this torch build has the ``torch.profiler`` API."""
    try:
        import torch.profiler

        return hasattr(torch.profiler, "profile")
    except Exception:  # noqa: BLE001 — absence is an answer, not an error
        return False


def _activities():
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def profile_window(logdir: str, *, tracer=None, name: str = "profile") -> Iterator[bool]:
    """Record the body with ``torch.profiler`` and write its Chrome trace to
    ``logdir/trace.json``.

    Yields True when a capture is running, False when it degraded (no
    profiler, or one already active); the body runs either way.  With
    ``tracer`` (a :class:`repro_torch.obs.Tracer`) the window is also a
    host-side span, so the two timelines line up.
    """
    from repro_torch.obs.trace import get_tracer

    tracer = tracer if tracer is not None else get_tracer()
    prof = None
    try:
        import torch.profiler

        prof = torch.profiler.profile(activities=_activities())
        prof.__enter__()
    except Exception as e:  # noqa: BLE001 — degrade, don't abort serving
        prof = None
        warnings.warn(
            f"obs.profile_window: torch profiler capture unavailable "
            f"({type(e).__name__}: {e}); running unprofiled",
            stacklevel=3,
        )
    started = prof is not None
    span = tracer.span(name, logdir=logdir, captured=started)
    try:
        with span:
            yield started
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(logdir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
            except Exception as e:  # noqa: BLE001
                warnings.warn(
                    f"obs.profile_window: stopping the capture failed "
                    f"({type(e).__name__}: {e})",
                    stacklevel=3,
                )
